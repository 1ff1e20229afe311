"""Whether a CUDA source of the port compiles to the same machine code as the
parent commit's copy of it, kernel by kernel.

    python scripts/compare_torch_dmv_sass.py [--name dmv_inside]
        [--parent _checkouts/parent_dmv]

Builds ``vlgae_tpu_torch/csrc/<name>.cu`` as the port builds it
(``ops/_build.py``) and ``<parent>/<name>.cu`` (with the parent's headers
beside it) by the same ``nvcc`` command, dumps both with ``cuobjdump
-sass`` and compares the instructions of every kernel the two share, by
name (the anonymous namespace's hash, which differs between builds, is
left out; so are addresses and encodings). Needs ``nvcc`` and
``cuobjdump``, so it runs where the card is. Prints one JSON line per
kernel, ``{"kernel", "same", "parent", "new"}`` (instruction counts), or
``{"kernel", "only_in"}``, then ``{"same": n, "differ": [kernels]}``.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernels(sass: str) -> dict:
    """Kernel name -> its instructions, from ``cuobjdump -sass`` text."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", m.group(1))
            out[name] = []
        elif name and "/*" in line:
            ins = re.sub(r"/\*.*?\*/", "", line).strip()
            if ins:
                out[name].append(ins)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", default="dmv_inside")
    ap.add_argument("--parent", default=os.path.join(ROOT, "_checkouts", "parent_dmv"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from vlgae_tpu_torch.ops import _build

    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")
    cmd = [_build.nvcc_path(), "-gencode", _build.ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC"]
    dumps = {}
    with tempfile.TemporaryDirectory() as tmp:
        for side, src in (("parent", os.path.join(args.parent, f"{args.name}.cu")),
                          ("new", os.path.join(_build.CSRC, f"{args.name}.cu"))):
            lib = os.path.join(tmp, f"{side}.so")
            subprocess.run([*cmd, "-o", lib, src], check=True)
            dumps[side] = kernels(subprocess.run([cuobjdump, "-sass", lib], check=True,
                                                 capture_output=True, text=True).stdout)
    parent, new = dumps["parent"], dumps["new"]
    same, differ = 0, []
    for k in sorted(set(parent) | set(new)):
        if k in parent and k in new:
            same += parent[k] == new[k]
            if parent[k] != new[k]:
                differ.append(k)
            print(json.dumps({"kernel": k, "same": parent[k] == new[k],
                              "parent": len(parent[k]), "new": len(new[k])}))
        else:
            print(json.dumps({"kernel": k, "only_in": "parent" if k in parent else "new"}))
    print(json.dumps({"same": same, "differ": differ}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
