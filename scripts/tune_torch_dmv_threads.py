"""Threads per block of the two-launch DMV pair (``csrc/dmv_inside.cu``'s
block mappings, K2/K3a, and ``csrc/dmv_outside.cu``, K3b) and of K1
(``csrc/dmv_fused.cu``: its block and the first threads of it that run the
inside pass), and sentences per block of the inside kernel's warp mapping
(K4, n1 <= 9), swept on one GPU with the ragged lengths of
``chip_smoke.py`` phases ``k2``/``k3``.

    python scripts/tune_torch_dmv_threads.py [--n1 9,17,51,57,63,64,101] [--B 64]
        [--kernels pair,fused]

Each kernel is launched through its C interface with every power of two from
32 to 1024 threads (the warp mapping: 32, 64 and 128, one, two and four
sentences a block; K1: every block size, up to 512 with charts in shared
memory, and every inside count up to it;
the wrapper's mapping and staging rules otherwise), its outputs held
against the wrapper's own launch (bit-equal in the max semiring, the
butterflies' order aside within 1e-4 in log), and timed as
``chip_smoke.device_ms`` times it (calls queued behind a busy device).
Prints the card, then a JSON line per (n1, B, semiring) with the ms of each
thread count by kernel (K1's keyed "threads/inside") and the count the
wrapper's rule picks (``dmv_cuda.inside_plan`` / ``outside_threads`` /
``fused_plan``). ``--B`` takes a list.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = (32, 64, 128, 256, 512, 1024)
WARP_THREADS = (32, 64, 128)  # one, two, four sentences a block


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n1", default="9,17,51,57,63,64,101")
    ap.add_argument("--B", default="64")
    ap.add_argument("--kernels", default="pair,fused")
    args = ap.parse_args(argv)
    kernels = set(args.kernels.split(","))
    sys.path.insert(0, ROOT)
    import chip_smoke  # stdlib only at import

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tune_torch_dmv_threads: no CUDA device", file=sys.stderr)
        return 2
    from vlgae_tpu_torch.ops import _build, dmv_cuda

    print(chip_smoke.nvidia_smi_line(), flush=True)
    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    cases = [(n1, B) for n1 in (int(x) for x in args.n1.split(","))
             for B in (int(x) for x in args.B.split(","))]
    for n1, B in cases:
        lengths = chip_smoke._ragged(rng, n1, B)
        dec, attach, lens = chip_smoke._dmv_inputs(rng, lengths, n1, dev)
        gout = chip_smoke._gout(B, dev)
        for kind in ("log", "max"):
            if "fused" in kernels:
                print(json.dumps(_sweep_fused(chip_smoke, dec, attach, lens, kind)), flush=True)
            if "pair" not in kernels:
                continue
            want_total, want_charts = dmv_cuda.dmv_inside_save(dec, attach, lens, kind)
            want_grads = dmv_cuda.dmv_outside(dec, attach, lens, gout, want_total,
                                              want_charts, kind)
            optin = dmv_cuda._smem_optin
            ip, op = dmv_cuda.inside_plan(n1, optin), dmv_cuda.outside_plan(n1, optin)
            warp = ip["mapping"] == "warp"
            stream = _build.stream_ptr(dev)

            def inside(threads, save):
                out = torch.empty(B, device=dev)
                charts = torch.empty((B, 4, n1, n1, 2), device=dev) if save else None
                scratch = torch.empty(B * dmv_cuda.INSIDE_BYTES_PER_N1SQ * n1 * n1, device=dev,
                                      dtype=torch.uint8
                                      ) if ip["mapping"] == "global" and not save else None
                _build.check(dmv_cuda._inside_lib.dmv_inside_launch(
                    _build.ptr(dec), _build.ptr(attach), _build.ptr(lens), _build.ptr(out),
                    None if charts is None else _build.ptr(charts),
                    None if scratch is None else _build.ptr(scratch), B, n1,
                    int(kind == "max"), int(save), dmv_cuda.MAPPINGS.index(ip["mapping"]),
                    threads, int(ip["stage"]), stream), "dmv_inside_launch")
                return out, charts

            def outside(threads):
                g_dec, g_attach = torch.empty_like(dec), torch.empty_like(attach)
                smem = op["mapping"] == "smem"
                scratch = None if smem else torch.empty(
                    B * dmv_cuda.OUTSIDE_SCRATCH_PER_N1SQ * n1 * n1, device=dev,
                    dtype=torch.uint8)
                _build.check(dmv_cuda._outside_lib.dmv_outside_launch(
                    _build.ptr(dec), _build.ptr(attach), _build.ptr(lens), _build.ptr(gout),
                    _build.ptr(want_total), _build.ptr(want_charts), _build.ptr(g_dec),
                    _build.ptr(g_attach), None if scratch is None else _build.ptr(scratch),
                    B, n1, int(kind == "max"), int(smem), int(op["stage"]), threads, stream),
                    "dmv_outside_launch")
                return g_dec, g_attach

            # the outside kernel has no warp mapping: its block threads are
            # swept at larger n1
            whats = ("inside", "inside_save") + (() if warp else ("outside",))
            rows, errs = {w: {} for w in whats}, dict.fromkeys(whats, 0.0)
            for threads in WARP_THREADS if warp else THREADS:
                total, charts = inside(threads, True)
                grads = None if warp else outside(threads)
                value = inside(threads, False)[0]
                torch.cuda.synchronize()
                for what, got, want in (("inside", [value], [want_total]),
                                        ("inside_save", [total, charts],
                                         [want_total, want_charts]),
                                        ("outside", grads, want_grads))[:len(whats)]:
                    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                    if (err != 0.0) if kind == "max" else not err <= 1e-4 * max(
                            1.0, max(float(w.abs().max()) for w in want)):
                        raise AssertionError(f"{what} n1={n1}/{kind} at {threads} threads: {err}")
                    errs[what] = max(errs[what], err)
                rows["inside"][threads] = chip_smoke.device_ms(lambda: inside(threads, False))
                rows["inside_save"][threads] = chip_smoke.device_ms(lambda: inside(threads, True))
                if not warp:
                    rows["outside"][threads] = chip_smoke.device_ms(lambda: outside(threads))
            print(json.dumps({
                "n1": n1, "kind": kind, "B": B, "ms_by_threads": rows, "max_err": errs,
                "rule": {"inside": ip["threads"], "outside": op["threads"]},
                "plans": {"inside": ip, "outside": op},
                "best": {k: min(v, key=v.get) for k, v in rows.items()}}), flush=True)
    return 0


def _sweep_fused(chip_smoke, dec, attach, lens, kind):
    """K1 at every block size and every inside count up to it, held against
    the wrapper's launch and timed; one JSON-able dict."""
    import torch

    from vlgae_tpu_torch.ops import _build, dmv_cuda

    B, n1 = dec.shape[:2]
    want = dmv_cuda.dmv_fused(dec, attach, lens, kind)
    plan = dmv_cuda.fused_plan(n1, dmv_cuda._smem_optin)
    charts = dmv_cuda.FUSED_SMEM_CHARTS[plan["mapping"]]
    scratch = torch.empty(B * plan["scratch_bytes"], device=dec.device,
                          dtype=torch.uint8) if plan["scratch_bytes"] else None
    stream = _build.stream_ptr(dec.device)

    def fused(threads, inside):
        out = torch.empty(B, device=dec.device)
        g_dec, g_attach = torch.empty_like(dec), torch.empty_like(attach)
        _build.check(dmv_cuda._lib.dmv_fused_launch(
            _build.ptr(dec), _build.ptr(attach), _build.ptr(lens), _build.ptr(out),
            _build.ptr(g_dec), _build.ptr(g_attach),
            None if scratch is None else _build.ptr(scratch), B, n1, int(kind == "max"),
            charts, int(plan["stage"]), threads, inside, stream), "dmv_fused_launch")
        return out, g_dec, g_attach

    rows, err = {}, 0.0
    # with charts in shared memory the kernel takes at most 512 threads
    for threads in (t for t in THREADS if not charts or t <= dmv_cuda.FUSED_SMEM_MAX_THREADS):
        for inside in (t for t in THREADS if t <= threads):
            got = fused(threads, inside)
            torch.cuda.synchronize()
            e = max(float((g - w).abs().max()) for g, w in zip(got, want))
            scale = max(1.0, max(float(w.abs().max()) for w in want))
            if (e != 0.0) if kind == "max" else not e <= 1e-4 * scale:
                raise AssertionError(f"K1 n1={n1}/{kind} at {threads}/{inside} threads: {e}")
            err = max(err, e)
            rows[f"{threads}/{inside}"] = chip_smoke.device_ms(lambda: fused(threads, inside))
    return {"n1": n1, "kind": kind, "B": B, "kernel": "fused", "ms_by_threads": rows,
            "max_err": err, "rule": f"{plan['threads']}/{plan['inside_threads']}",
            "plan": plan, "best": min(rows, key=rows.get)}


if __name__ == "__main__":
    sys.exit(main())
