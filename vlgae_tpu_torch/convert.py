"""Carry weights between the JAX package's params and the port's modules.

The JAX params come as a flat dict of numpy arrays keyed by ``/``-joined
flax paths (the ``.npz`` that ``scripts/export_jax_params.py`` writes; a
leading ``params/`` is accepted). The port names its modules after the
flax paths, so a key maps mechanically:

* a flax ``Dense`` ``kernel [in, out]`` is the transposed ``weight`` of
  ``nn.Linear``; a ``LayerNorm`` ``scale`` is its ``weight``;
* a flax ``Conv`` ``kernel [kh, kw, in, out]`` (the ViT's patch
  projection) is a ``weight [out, in, kh, kw]``: the axes are permuted, not
  reversed, so a square patch cannot hide a swap of kh and kw; a 1-D
  ``Conv`` ``kernel [k, in, out]`` (the char-CNN's ``conv<k>``) is a
  ``Conv1d`` ``weight [out, in, k]``;
* the ``Dense_0`` inside ``MLP`` / ``MLPEncoder`` is ``linear``; the
  ``RNNEncoder``'s projections are flax's ``Dense_0`` and ``Dense_1`` in
  the order it makes them (``reproject_emb`` first), so its first is
  ``linear`` and its second ``Dense_1``;
* the bottleneck pair ``<NAME>_down`` / ``<NAME>_up`` of
  ``DMVSkipConnectEncoder`` is the ``Sequential`` ``<NAME>.0`` / ``<NAME>.1``;
* every other parameter (``arc_encoder_w1``, ``rel_fc_bias``, embedding
  tables, the BERT tree under ``.../transformer/bert/...``, the LSTM gates
  ``encoder/fwd_0/cell/OptimizedLSTMCell_0/{ii..io,hi..ho}``, the mix
  ``encoder/ScalarMix_0/{weights,gamma}``, the variational layers
  ``variational_enc``, ``target_mean``/``target_lvar`` of the parser and
  ``embedding/<item>/{enc,target_mean,target_lvar}`` of an embedding item,
  the char-CNN's ``char_embedding`` and ``proj``, the image head
  ``img_fc``, a ``MultiEncoder``'s sub-encoders under flax's
  ``encoders_<i>_1``) keeps its path, as do the ViT's ``cls_token`` and
  ``position_embeddings`` under ``.../vis_encoder/vit/embeddings``. The BERT
  tree is the same at any width (layers ``encoder/layer/<k>``). The stand-alone parser of
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
# a flax Conv kernel [kh, kw, in, out] <-> a torch weight [out, in, kh, kw];
# [k, in, out] <-> [out, in, k]; a Dense kernel [in, out] <-> [out, in]
_TO_TORCH = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
_TO_FLAX = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


def _kernel_to_torch(arr: np.ndarray) -> np.ndarray:
    return arr.transpose(_TO_TORCH[arr.ndim])


def _kernel_to_flax(arr: np.ndarray) -> np.ndarray:
    return arr.transpose(_TO_FLAX[arr.ndim])


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
        leaf = "kernel" if ndim in (2, 3, 4) else "scale"
    return "/".join(out + [leaf])


def flax_to_torch(flat: Dict[str, np.ndarray], model: torch.nn.Module, shapes=None):
    """Flat flax params -> a ``state_dict`` for ``model`` (strict), each
    tensor of the shape ``shapes`` gives its key (the model's own shapes by
    default; the whole shapes for a model sharded over processes)."""
    want = model.state_dict()
    shapes = shapes or {k: tuple(v.shape) for k, v in want.items()}
    state = {}
    for path, value in flat.items():
        key, transpose = _flax_to_torch_key(path)
        if key not in want:
            raise KeyError(f"flax param {path!r} has no counterpart ({key!r})")
        arr = np.asarray(value)
        if transpose:
            arr = _kernel_to_torch(arr)
        t = torch.from_numpy(np.array(arr)).to(want[key].dtype)
        if tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{path!r}: shape {tuple(t.shape)} != {tuple(shapes[key])}")
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
