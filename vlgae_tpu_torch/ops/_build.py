"""Build the sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into ``vlgae_tpu_torch/_build/lib<name>.so``, then loaded with
``ctypes``. The library is rebuilt when its source, or a header
(``csrc/*.cuh``) beside it, is newer. Pointers and
the stream pass as ``c_void_p``; each launcher returns the CUDA error code,
and :func:`check` raises on a non-zero one. The host library
``csrc/vlgae_io.cpp`` (the det-feature packer) is built the same way by
``g++ -O3 -fPIC -shared -std=c++17`` (:func:`build_host`).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
ARCH = "arch=compute_90a,code=sm_90a"
CXX = "g++"  # plain ``cc`` mislinks the C++ runtime

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use")


def _compile(src: str, out: str, cmd, deps=(), verbose: bool = False) -> str:
    """Run ``cmd + ["-o", <tmp>, src]`` when ``out`` is older than ``src`` or
    ``deps`` (or missing), then move the result to ``out`` in one rename, so
    that processes building at once never load a half-written library.
    Raises, naming the command and its stderr, when the compiler fails or
    cannot be run; ``verbose`` prints the stderr of a build that worked."""
    deps = [src, *deps]
    if os.path.exists(out) and os.path.getmtime(out) >= max(map(os.path.getmtime, deps)):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [*cmd, "-o", tmp, src]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(
            f"{' '.join(cmd)} failed (rc {res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr)
    os.replace(tmp, out)
    return out


def build(name: str, verbose: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` (when stale) and return the .so path."""
    headers = [os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    cmd = [nvcc_path(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC"]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return _compile(os.path.join(CSRC, f"{name}.cu"),
                    os.path.join(BUILD, f"lib{name}.so"), cmd, headers, verbose)


def build_host(name: str) -> str:
    """Compile the host library ``csrc/<name>.cpp`` with :data:`CXX` (when
    stale) into ``_build/lib<name>.so`` and return its path."""
    return _compile(os.path.join(CSRC, f"{name}.cpp"), os.path.join(BUILD, f"lib{name}.so"),
                    [CXX, "-O3", "-fPIC", "-shared", "-std=c++17"])


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first call)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
