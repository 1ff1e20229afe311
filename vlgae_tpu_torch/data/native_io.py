"""ctypes bindings of the port's native det-feature packer (counterpart of
vlgae_tpu/data/native_io.py).

``vlgae_tpu_torch/csrc/vlgae_io.cpp`` (the same functions as the JAX
package's ``native/vlgae_io.cpp``) is compiled at first use by ``g++ -O3
-fPIC -shared -std=c++17`` into ``vlgae_tpu_torch/_build/libvlgae_io.so``
(:func:`vlgae_tpu_torch.ops._build.build_host`: rebuilt when the source is
newer, moved into place in one rename) and loaded with ``ctypes``. A build
that fails raises with the compiler's command and stderr: there is no
NumPy fallback, since it would draw other boxes than the packer does.

The packer reads each image's ``.npy`` rows (f4 or f8), draws ``sample`` of
them by a partial Fisher-Yates shuffle on ``std::mt19937_64`` seeded with
``seed + i`` for the ``i``-th image, sorts the drawn rows and writes them
into the caller's padded buffers, which it zero-fills itself; its feature
buffer is page-locked when a card is present
(:mod:`vlgae_tpu_torch.utils.pinned`). It returns what the JAX package's
packer returns; it reads each file in one call where that one reads a row
at a time.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from ..ops import _build
from ..utils.pinned import host_empty

_LIB: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def load_library(build: bool = True) -> Optional[ctypes.CDLL]:
    """The loaded packer, compiled first when it is missing or stale (with
    ``build``). ``build=False`` gives ``None`` when no library was built."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        so = os.path.join(_build.BUILD, "libvlgae_io.so")
        if build:
            so = _build.build_host("vlgae_io")
        elif not os.path.exists(so):
            return None
        lib = ctypes.CDLL(so)
        lib.vlgae_load_det_feats_batch.restype = ctypes.c_int
        lib.vlgae_load_det_feats_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.vlgae_npy_header.restype = ctypes.c_int
        lib.vlgae_npy_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
        ]
        _LIB = lib
        return lib


def npy_shape(path) -> Optional[tuple]:
    """``(rows, cols)`` of a 2-D f4/f8 ``.npy`` file from its header, or
    ``None`` when the header is not one the packer reads."""
    lib = load_library()
    rows, cols, off, ds = (ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64(),
                           ctypes.c_int())
    rc = lib.vlgae_npy_header(str(path).encode(), ctypes.byref(rows), ctypes.byref(cols),
                              ctypes.byref(off), ctypes.byref(ds))
    if rc != 0:
        return None
    return int(rows.value), int(cols.value)


def load_det_feats_batch(paths, pad_boxes: int, feat_dim: int, sample: int,
                         seed: int = 0):
    """``(feats [n, pad_boxes, feat_dim] f32, boxes [n, pad_boxes, 4] f32,
    mask [n, pad_boxes] bool)`` of the images' ``.npy`` files: ``sample``
    rows of each drawn from ``seed + i`` when ``0 < sample < rows``, else its
    first ``pad_boxes`` rows. Raises ``OSError`` with the packer's code on a
    file it cannot read."""
    lib = load_library()
    n = len(paths)
    feats = host_empty((n, pad_boxes, feat_dim), np.float32)
    boxes = np.zeros((n, pad_boxes, 4), np.float32)
    mask = np.zeros((n, pad_boxes), np.uint8)
    joined = "\n".join(str(p) for p in paths).encode()
    rc = lib.vlgae_load_det_feats_batch(
        joined, n, pad_boxes, feat_dim, sample, seed,
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise OSError(f"vlgae_io batch load failed: rc={rc}")
    return feats, boxes, mask.astype(bool)
