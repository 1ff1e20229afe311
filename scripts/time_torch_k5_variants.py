"""K5 (``csrc/match_fwd.cu``) built with other compile-time choices, timed in
turns with this tree's K5 and, when ``_checkouts/parent_match/`` holds the
parent commit's ``match_fwd.cu``, the parent's K5, on the same draws; each
one's bits held against this tree's (and the parent's).

    python scripts/time_torch_k5_variants.py [--rows vit_train,vit_eval,...]
        [--variants acc2_nt15,acc2,wg3,stages4,chains2,tb_now]

A variant is this tree's ``match_fwd.cu`` with one line replaced (the
``VARIANTS`` table), built by the port's ``nvcc`` command with ``-Xptxas
-v`` into a temporary directory and launched through the same C interface
at the wrapper's rules (``ops/match.py``: q-chunks, image groups), its
captions a block read from the build itself. Only the TMA kernel's rows
(chunks of 120 and 136 words) are timed; the parent took Q = 130 in two
passes of 72. The choices: two accumulator sets a warpgroup at 120 words
or at both widths (this tree: one), two or three consumer warpgroups, a ring of 4 tiles, two row-max chains, the
words' biases read a group ahead or where used. Needs ``nvcc`` and a CUDA
device, so it runs where the card is. Prints the card, one JSON line per
build (registers and spill bytes of each kernel instance, from
``ptxas``, and the notes of ``ptxas`` that it serialized an instance's wgmmas), then one per
row: ``device_ms`` of each build (``chip_smoke._in_turns``), its ratio to
the parent's, and whether its four outputs equal this tree's and the
parent's bit for bit.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS = "static constexpr int kAccSets = 1;"
VARIANTS = {
    # two accumulator sets a warpgroup at 120 words (job j's wgmmas in
    # flight during job j-1's epilogue)
    "acc2_nt15": (SETS, "static constexpr int kAccSets = NT <= 15 ? 2 : 1;"),
    # two sets at both widths
    "acc2": (SETS, "static constexpr int kAccSets = 2;"),
    # three consumer warpgroups of one caption, one set each (152 registers)
    "wg3": ("static constexpr int kConsumerWGs = 2;", "static constexpr int kConsumerWGs = 3;"),
    # a ring of four image tiles
    "stages4": ("constexpr int kStages = 6;", "constexpr int kStages = 4;"),
    # the row max as two chains a row (column groups even and odd), as PR
    # 4's kernel keeps it
    "chains2": ("constexpr int kChains = kTma ? 1 : 2;", "constexpr int kChains = 2;"),
    # each column group's word biases read where they are used
    "tb_now": ("constexpr bool kTbAhead = true;", "constexpr bool kTbAhead = false;"),
}
# (A, V, B, Q): the rows of PERF.md's K5 table that take the TMA kernel, and a
# rank's shards
ROWS = {
    "vit_train": (64, 1324, 64, 130), "vit_eval": (64, 1275, 64, 130),
    "vlgae_longest": (64, 739, 64, 114), "alldep": (64, 739, 64, 3306),
    "shard_b32": (64, 739, 32, 114), "shard_b16": (64, 739, 16, 114),
    "shard_b8": (64, 739, 8, 114),
}
D = 128


def build(name, line, tmp):
    """``(name, library, ptxas lines)`` of ``match_fwd.cu`` with ``line`` =
    (old, new) replaced (None: as it is)."""
    from vlgae_tpu_torch.ops import _build

    d = os.path.join(tmp, name)
    os.makedirs(d)
    shutil.copy(os.path.join(_build.CSRC, "match_fwd.cu"), d)
    src_path = os.path.join(d, "match_fwd.cu")
    if line is not None:
        src = open(src_path).read()
        if src.count(line[0]) != 1:
            raise SystemExit(f"variant {name}: {line[0]!r} is not one line of match_fwd.cu")
        open(src_path, "w").write(src.replace(line[0], line[1]))
    so = os.path.join(d, "libmatch_fwd.so")
    res = subprocess.run([_build.nvcc_path(), "-gencode", _build.ARCH, "-std=c++17", "-O3",
                          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, src_path],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"variant {name} does not build:\n{res.stderr}")
    ptxas = [f"{m[0]} nt={m[1]}: {m[3]} registers, {m[2]} B spilled"
             for m in re.findall(r"match_fwd_(tma_kernel|kernel)ILi(\d+)E[^\n]*\n[^\n]*?"
                                 r"(\d+) bytes spill stores[^\n]*\n[^\n]*?Used (\d+) registers",
                                 res.stderr)]
    # the notes that ptxas serialized the wgmmas of an instance (C7519, a
    # fence it added before a wgmma, is not one)
    notes = {}
    for code, fn in re.findall(r"\((C75\d\d)\)[^\n]*function '\w*match_fwd_(\w+?kernelILi\d+)E",
                               res.stderr):
        if code != "C7519":
            notes[f"{fn} {code}"] = notes.get(f"{fn} {code}", 0) + 1
    ptxas += [f"{k}: {v}" for k, v in sorted(notes.items())]
    lib = ctypes.CDLL(so)
    lib.match_fwd_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    lib.match_fwd_launch.restype = ctypes.c_int
    for fn in (lib.match_fwd_smem_bytes, lib.match_fwd_cap_tile):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
    return name, lib, ptxas


def launcher(lib, args):
    """One launch of a build's TMA kernel at the wrapper's rules; its
    outputs."""
    import torch

    from vlgae_tpu_torch.ops import _build, match

    vis, txt, vb, tb = args
    A, V, _ = vis.shape
    B, Q, _ = txt.shape
    tma = match.FWD_STAGING.index("tma")
    nt = match.match_fwd_q_tiling(Q, match.FWD_TMA_Q_GROUPS)[1]
    sms = torch.cuda.get_device_properties(vis.device).multi_processor_count
    groups = match.match_fwd_groups(A, B, sms, lib.match_fwd_cap_tile(nt, tma))

    def go():
        out = (torch.empty((B, A, Q), device=vis.device),
               torch.empty((B, A, Q), device=vis.device, dtype=torch.int32),
               torch.empty((B, A, V), device=vis.device),
               torch.empty((B, A, V), device=vis.device, dtype=torch.int32))
        _build.check(lib.match_fwd_launch(*(_build.ptr(t) for t in (*args, *out)), A, V, D, B, Q,
                                          groups, nt, tma, _build.stream_ptr(vis.device)),
                     "match_fwd_launch (variant)")
        return out

    return go


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default=",".join(ROWS))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke  # stdlib only at import

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_torch_k5_variants: no CUDA device", file=sys.stderr)
        return 2
    names = [n for n in args.variants.split(",") if n]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {sorted(VARIANTS)}")
    rows = args.rows.split(",")
    tmp = tempfile.mkdtemp()
    try:
        jobs = [("this_tree", None)] + [(n, VARIANTS[n]) for n in names]
        with ThreadPoolExecutor(len(jobs)) as pool:
            built = list(pool.map(lambda j: build(*j, tmp), jobs))
        parent = None
        if os.path.exists(os.path.join(chip_smoke.PARENT_MATCH, "match_fwd.cu")):
            parent = chip_smoke.ParentMatch()
            parent.build()
        print(chip_smoke.nvidia_smi_line(), flush=True)
        for name, _, ptxas in built:
            print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)
        rng = np.random.default_rng(7)
        dev = torch.device("cuda")
        libs = dict((name, lib) for name, lib, _ in built)
        for row in rows:
            A, V, B, Q = ROWS[row]
            inputs = chip_smoke._k5_inputs(rng, A, V, B, Q, D, dev, "random")
            fns = {name: launcher(lib, inputs) for name, lib in libs.items()}
            if parent is not None:
                fns = {"parent": lambda: parent(*inputs), **fns}
            outs = {name: fn() for name, fn in fns.items()}
            torch.cuda.synchronize()

            def same(a, b):
                return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                           for x, y in zip(a, b))

            ms = chip_smoke._in_turns(fns)
            ref = ms.get("parent")
            print(json.dumps({
                "row": row, "A": A, "V": V, "B": B, "Q": Q, "device_ms": ms,
                "vs_parent": {k: v / ref - 1 for k, v in ms.items()} if ref else None,
                "bits_equal_this_tree": {k: same(o, outs["this_tree"]) for k, o in outs.items()},
                "bits_equal_parent": ({k: same(o, outs["parent"]) for k, o in outs.items()}
                                      if parent is not None else None)}), flush=True)
            del outs
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
