"""K1 (``csrc/dmv_fused.cu``) built with other compile-time choices, timed in
turns with this tree's K1 and, when ``_checkouts/parent_dmv/`` holds the
parent commit's sources, the parent's K1, on the same draws; each one's bits
held against this tree's (and the parent's).

    python scripts/time_torch_k1_variants.py [--n1 17,51,57,65,75,101]
        [--variants hold4_split,hold4_global,hold0_split,global_trees_off]

A variant is this tree's ``dmv_fused.cu`` with one line replaced (the
``VARIANTS`` table), built by the port's ``nvcc`` command with ``-Xptxas
-v`` into a temporary directory and launched through the same C interface
at the wrapper's plan (``dmv_cuda.fused_plan``: placement, threads, inside
threads). The variants are the choices behind ``kHold``, the terms a lane
holds in registers for the log sums, and the outside pass's level-by-level
trees in the global placement. Needs ``nvcc`` and a CUDA device, so it runs
where the card is. Prints the card, one JSON line per build (registers and
spill bytes of each kernel instance, from ``ptxas``), then one per (n1,
semiring): ``device_ms`` of each build (``chip_smoke._in_turns``), its
ratio to the parent's, and whether its three outputs equal this tree's and
the parent's bit for bit.
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
HOLD = ("constexpr int kHold = SMEM_CHARTS == 8 ? kRegTerms : "
        "SMEM_CHARTS == 4 ? kRegTerms / 2 : 0;")
OUTSIDE = "outside_fill_1b<IS_MAX, true, kHold>"
VARIANTS = {
    # four terms a lane in the split placement too
    "hold4_split": (HOLD, "constexpr int kHold = SMEM_CHARTS ? kRegTerms : 0;"),
    # four in every placement, the global one's 64 registers a thread too
    "hold4_global": (HOLD, "constexpr int kHold = kRegTerms;"),
    # none held in the split placement
    "hold0_split": (HOLD, "constexpr int kHold = SMEM_CHARTS == 8 ? kRegTerms : 0;"),
    # the global placement's outside pass reducing one tree after another
    "global_trees_off": (OUTSIDE, "outside_fill_1b<IS_MAX, (SMEM_CHARTS > 0), kHold>"),
}


def build(name, line, tmp):
    """``(name, launch function, ptxas lines)`` of ``dmv_fused.cu`` with
    ``line`` = (old, new) replaced (None: as it is)."""
    from vlgae_tpu_torch.ops import _build

    d = os.path.join(tmp, name)
    os.makedirs(d)
    for f in ("dmv_fused.cu", "dmv_common.cuh"):
        shutil.copy(os.path.join(_build.CSRC, f), d)
    src_path = os.path.join(d, "dmv_fused.cu")
    if line is not None:
        src = open(src_path).read()
        if src.count(line[0]) != 1:
            raise SystemExit(f"variant {name}: {line[0]!r} is not one line of dmv_fused.cu")
        open(src_path, "w").write(src.replace(line[0], line[1]))
    so = os.path.join(d, "libdmv_fused.so")
    res = subprocess.run([_build.nvcc_path(), "-gencode", _build.ARCH, "-std=c++17", "-O3",
                          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, src_path],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"variant {name} does not build:\n{res.stderr}")
    ptxas = [f"max={m[0]} smem_charts={m[1]} stage={m[2]}: {m[4]} registers, {m[3]} B spilled"
             for m in re.findall(r"dmv_fused_kernelILb(\d)ELi(\d)ELb(\d)[^\n]*\n[^\n]*?"
                                 r"(\d+) bytes spill stores[^\n]*\n[^\n]*?Used (\d+) registers",
                                 res.stderr)]
    fn = ctypes.CDLL(so).dmv_fused_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return name, fn, ptxas


def launcher(fn, dec, attach, lens, kind):
    """One launch of a build ``fn`` at the wrapper's plan; its outputs."""
    import torch

    from vlgae_tpu_torch.ops import _build, dmv_cuda

    B, n1 = dec.shape[:2]
    plan = dmv_cuda.fused_plan(n1, dmv_cuda._smem_optin)
    scratch = torch.empty(B * plan["scratch_bytes"], device=dec.device,
                          dtype=torch.uint8) if plan["scratch_bytes"] else None

    def go():
        out = torch.empty(B, device=dec.device)
        g_dec, g_attach = torch.empty_like(dec), torch.empty_like(attach)
        _build.check(fn(_build.ptr(dec), _build.ptr(attach), _build.ptr(lens), _build.ptr(out),
                        _build.ptr(g_dec), _build.ptr(g_attach),
                        None if scratch is None else _build.ptr(scratch), B, n1,
                        int(kind == "max"), dmv_cuda.FUSED_SMEM_CHARTS[plan["mapping"]],
                        int(plan["stage"]), plan["threads"], plan["inside_threads"],
                        _build.stream_ptr(dec.device)), "dmv_fused_launch (variant)")
        return out, g_dec, g_attach

    return go


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n1", default="17,51,57,65,75,101")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke  # stdlib only at import

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_torch_k1_variants: no CUDA device", file=sys.stderr)
        return 2
    from vlgae_tpu_torch.ops import dmv_cuda

    names = args.variants.split(",")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {sorted(VARIANTS)}")
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [("this_tree", None)] + [(n, VARIANTS[n]) for n in names]
        with ThreadPoolExecutor(len(jobs)) as pool:
            built = list(pool.map(lambda j: build(*j, tmp), jobs))
    parent = None
    if os.path.exists(os.path.join(chip_smoke.PARENT_DMV, "dmv_fused.cu")):
        parent = chip_smoke.ParentDMV()
        parent.build("dmv_fused")
    dmv_cuda._library()  # the card's shared-memory limit, for the plan
    print(chip_smoke.nvidia_smi_line(), flush=True)
    for name, _, ptxas in built:
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)
    rng = np.random.default_rng(11)
    dev = torch.device("cuda")
    for n1 in (int(x) for x in args.n1.split(",")):
        lengths = chip_smoke._ragged(rng, n1)
        dec, attach, lens = chip_smoke._dmv_inputs(rng, lengths, n1, dev)
        for kind in ("log", "max"):
            fns = {name: launcher(fn, dec, attach, lens, kind) for name, fn, _ in built}
            if parent is not None:
                fns = {"parent": lambda: parent.fused(dec, attach, lens, kind), **fns}
            outs = {name: fn() for name, fn in fns.items()}
            torch.cuda.synchronize()

            def same(a, b):
                return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                           for x, y in zip(a, b))

            ms = chip_smoke._in_turns(fns)
            ref = ms.get("parent")
            print(json.dumps({
                "n1": n1, "kind": kind,
                "mapping": dmv_cuda.fused_plan(n1, dmv_cuda._smem_optin)["mapping"],
                "device_ms": ms,
                "vs_parent": {k: v / ref - 1 for k, v in ms.items()} if ref else None,
                "bits_equal_this_tree": {k: same(o, outs["this_tree"]) for k, o in outs.items()},
                "bits_equal_parent": ({k: same(o, outs["parent"]) for k, o in outs.items()}
                                      if parent is not None else None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
