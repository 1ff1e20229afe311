"""A/B of K6 (the matching-max backward, ``match_maxes_bwd_cuda``) between
this checkout and another one, on one GPU at the recipe's training shape
A = B = 64, Q = 102, V = 739, D = 128, on inputs made as ``chip_smoke.py``
phase ``k6`` makes them (winners from K5, random operands and cotangents).

    python scripts/time_torch_k6.py [--root DIR]

``--root`` imports ``vlgae_tpu_torch`` from another checkout (a parent
commit unpacked by ``git archive``); run it as parent, change, change,
parent in one call. Prints the card, then one JSON line: K6's time of one
call (``ms``, CUDA events around each call, as ``chip_smoke.py``'s ``k6``
row) and with the calls queued behind a busy device (``device_ms``), after
holding its outputs against the plain version.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke  # stdlib only at import

    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_torch_k6: no CUDA device", file=sys.stderr)
        return 2
    from vlgae_tpu_torch.ops import match

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.nvidia_smi_line(), flush=True)
    call = chip_smoke._match_bwd_inputs(np.random.default_rng(2), 64, 739, 64, 102, 128,
                                        torch.device("cuda"), "random")
    err = chip_smoke._check_k6(call, False, "at the training shape")
    chip_smoke.emit({"root": args.root, "package": match.__file__, "max_abs_err": err,
                     "ms": chip_smoke.time_ms(lambda: match.match_maxes_bwd_cuda(*call)),
                     "device_ms": chip_smoke.device_ms(
                         lambda: match.match_maxes_bwd_cuda(*call), n=20)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
