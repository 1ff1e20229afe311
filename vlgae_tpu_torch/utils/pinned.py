"""Page-locked host arrays for the batches that go to the card.

The loaders and the batch padding write the large arrays of a batch
(``vis_box_feat``, ``vis_pixels``) into NumPy views of page-locked torch
tensors (:func:`host_zeros`), so that ``parallel.shard_batch`` can upload
them with ``non_blocking=True`` straight from that memory
(:func:`pinned_rows`). Without a card the same calls give plain NumPy
arrays.

Buffer lifetime: a pinned tensor comes from PyTorch's caching host
allocator, and the view :func:`pinned_rows` returns shares its storage. A
non-blocking copy from it records an event on the copy's stream with that
allocator, which does not hand the block out again before the event has
completed, however early the batch is dropped. No event of our own is kept.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def pinning() -> bool:
    """Whether host arrays are page-locked: when a card is present."""
    return torch.cuda.is_available()


def host_zeros(shape, dtype) -> np.ndarray:
    """A zero-filled NumPy array, page-locked when a card is present (a view
    of a pinned torch tensor, which the array keeps alive)."""
    if not pinning():
        return np.zeros(shape, dtype)
    return torch.zeros(tuple(shape), dtype=_torch_dtype(dtype), pin_memory=True).numpy()


def host_empty(shape, dtype) -> np.ndarray:
    """An uninitialised :func:`host_zeros`."""
    if not pinning():
        return np.empty(shape, dtype)
    return torch.empty(tuple(shape), dtype=_torch_dtype(dtype), pin_memory=True).numpy()


def _owner(a: np.ndarray) -> Optional[torch.Tensor]:
    """The torch tensor whose memory ``a`` views, if any."""
    base = a
    while isinstance(base, np.ndarray):
        base = base.base
    return base if isinstance(base, torch.Tensor) else None


def is_pinned(a) -> bool:
    """Whether the NumPy array ``a`` lies in a pinned torch tensor."""
    owner = _owner(a) if isinstance(a, np.ndarray) else None
    return owner is not None and owner.is_pinned()


def pinned_rows(a: np.ndarray) -> Optional[torch.Tensor]:
    """``a`` (a C-contiguous view into a pinned tensor, e.g. some rows of a
    batch array) as a torch view of that tensor's storage, which a
    non-blocking copy records its stream on; ``None`` when ``a`` does not lie
    in pinned memory."""
    owner = _owner(a)
    if owner is None or not owner.is_pinned() or not a.flags.c_contiguous:
        return None
    flat = owner.reshape(-1)
    offset, rem = divmod(a.ctypes.data - flat.data_ptr(), a.itemsize)
    if rem or a.itemsize != flat.element_size():
        return None
    return flat[offset:offset + a.size].view(a.shape)
