"""Carry weights between the JAX package's params and the port's modules.

The JAX params come as a flat dict of numpy arrays keyed by ``/``-joined
flax paths (the ``.npz`` that ``scripts/export_jax_params.py`` writes; a
leading ``params/`` is accepted). The port names its modules after the
flax paths, so a key maps mechanically:

* a flax ``Dense`` ``kernel [in, out]`` is the transposed ``weight`` of
  ``nn.Linear``; a ``LayerNorm`` ``scale`` is its ``weight``;
* a flax ``Conv`` ``kernel [kh, kw, in, out]`` (the ViT's patch
  projection) is a ``weight [out, in, kh, kw]``: the axes are permuted, not
  reversed, so a square patch cannot hide a swap of kh and kw;
* the ``Dense_0`` inside ``MLP`` / ``MLPEncoder`` is ``linear``;
* the bottleneck pair ``<NAME>_down`` / ``<NAME>_up`` of
  ``DMVSkipConnectEncoder`` is the ``Sequential`` ``<NAME>.0`` / ``<NAME>.1``;
* every other parameter (``arc_encoder_w1``, ``rel_fc_bias``, embedding
  tables, the BERT tree under ``.../transformer/bert/...``, the LSTM gates
  ``encoder/fwd_0/cell/OptimizedLSTMCell_0/{ii..io,hi..ho}``) keeps its
  path, as do the ViT's ``cls_token`` and ``position_embeddings`` under
  ``.../vis_encoder/vit/embeddings``. The stand-alone parser of
  ``exp=lang_only`` has the same names without the joint model's
  ``dependency/`` prefix.

Both directions raise on a missing or an unused key.

The classic tabular DMV (:mod:`vlgae_tpu_torch.models.dmv_model`) is no
module: its params are the same three arrays under the same keys in both
packages (``root_param``, ``trans_param``, ``dec_param``), carried as
``{k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_BOTTLENECK = ("HASCHILD", "NOCHILD", "LEFT", "RIGHT")
# a flax Conv kernel [kh, kw, in, out] <-> a torch weight [out, in, kh, kw]
_CONV_TO_TORCH, _CONV_TO_FLAX = (3, 2, 0, 1), (2, 3, 1, 0)


def _kernel_to_torch(arr: np.ndarray) -> np.ndarray:
    return arr.transpose(_CONV_TO_TORCH) if arr.ndim == 4 else arr.T


def _kernel_to_flax(arr: np.ndarray) -> np.ndarray:
    return arr.transpose(_CONV_TO_FLAX) if arr.ndim == 4 else arr.T


def _flax_to_torch_key(path: str):
    """(torch key, transpose?) for one flax path."""
    parts = path.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    out = []
    for p in parts[:-1]:
        if p == "Dense_0":
            out.append("linear")
        elif p.endswith(("_down", "_up")) and p.rsplit("_", 1)[0] in _BOTTLENECK:
            name, end = p.rsplit("_", 1)
            out += [name, "0" if end == "down" else "1"]
        else:
            out.append(p)
    leaf = parts[-1]
    if leaf == "kernel":
        return ".".join(out + ["weight"]), True
    if leaf == "scale":
        return ".".join(out + ["weight"]), False
    return ".".join(out + [leaf]), False


def torch_to_flax_key(key: str, ndim: int) -> str:
    parts = key.split(".")
    out = []
    i = 0
    while i < len(parts) - 1:
        p = parts[i]
        if p == "linear":
            out.append("Dense_0")
        elif (p in _BOTTLENECK and i + 1 < len(parts) - 1
              and parts[i + 1] in ("0", "1")):
            out.append(f"{p}_{'down' if parts[i + 1] == '0' else 'up'}")
            i += 1
        else:
            out.append(p)
        i += 1
    leaf = parts[-1]
    if leaf == "weight":
        leaf = "kernel" if ndim in (2, 4) else "scale"
    return "/".join(out + [leaf])


def flax_to_torch(flat: Dict[str, np.ndarray], model: torch.nn.Module):
    """Flat flax params -> a ``state_dict`` for ``model`` (strict)."""
    want = model.state_dict()
    state = {}
    for path, value in flat.items():
        key, transpose = _flax_to_torch_key(path)
        if key not in want:
            raise KeyError(f"flax param {path!r} has no counterpart ({key!r})")
        arr = np.asarray(value)
        if transpose:
            arr = _kernel_to_torch(arr)
        t = torch.from_numpy(np.array(arr)).to(want[key].dtype)
        if t.shape != want[key].shape:
            raise ValueError(
                f"{path!r}: shape {tuple(t.shape)} != {tuple(want[key].shape)}")
        state[key] = t
    missing = sorted(set(want) - set(state))
    if missing:
        raise KeyError(f"params missing for: {missing}")
    return state


def torch_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A port ``state_dict`` -> flat flax params (``/``-joined paths,
    without the ``params/`` root)."""
    flat = {}
    for key, value in state.items():
        arr = value.detach().cpu().numpy()
        path = torch_to_flax_key(key, arr.ndim)
        if path.endswith("/kernel"):
            arr = _kernel_to_flax(arr)
        if path in flat:
            raise KeyError(f"two torch keys map to {path!r}")
        flat[path] = np.ascontiguousarray(arr)
    return flat
