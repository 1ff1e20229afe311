"""Visual factor encoder (counterpart of vlgae_tpu/models/vis_encoder.py,
``VisBoxRelSimpleEncoder``).

Box / relation (box-pair) / attribute factor embeddings from Faster-RCNN
box features, and with ``use_img`` an image embedding (``img_fc`` over the
mean box feature, ``out["img"]``; the joint model's image factor is the
mean box factor, as in the JAX package, so nothing reads it). The
pairwise-mean relation MLP is factorized: each box is
projected once and the pair sum is taken before the activation, so the
``[B, P, P, 2H]`` input never exists. At eval the relation group covers
the full ``P * P`` pair axis; in training the caller may ask for only the
pairs ``rel_pairs`` (the inclusive upper triangle, since rel(i, j) ==
rel(j, i)), produced by a product with a 0.5/0.5 incidence matrix. With
``dtype=bfloat16`` the 2048-d projections run in bf16 and return f32, as
under ``precision=bf16`` in the JAX package.

``VisViTPatchEncoder`` (the ``exp=vlgae_vit`` recipe) feeds the same head
with the patch grid of a ViT over raw pixels: every patch is a "box" whose
geometry is its rectangle (:func:`patch_boxes`). The port builds the ViT
itself: the computation of ``transformers``' ``FlaxViTModule`` without its
pooler, always in f32, under HF's module names. :func:`load_vit_params`
reads pretrained backbone weights (an ``.npz``, a flax ``.msgpack`` or a
HF checkpoint directory, through the readers of
:mod:`vlgae_tpu_torch.utils.serialization`) and :func:`graft_vit_params`
puts them into a model.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import ModelGroup, copy_to_model
from .nn import MLP, Dropping, leaky_relu, linear, shared_dropout, shared_keep_shape


class VisBoxRelSimpleEncoder(Dropping):
    """The factor heads. Under tensor parallelism (:meth:`set_model_group`)
    every head is column-parallel: this rank holds a slice of the output
    features, draws its dropout masks at full width and keeps its columns,
    and the gradient of the input features is summed over the model
    group."""

    model_group = ModelGroup()

    def __init__(self, n_in: int, n_hidden: int, activate: bool = True,
                 use_attr: bool = True, use_img: bool = False,
                 img_feat: bool = True, dtype=None, dropout: float = 0.0):
        super().__init__()
        d_in = 2 * n_in if img_feat else n_in
        self.img_feat = img_feat
        self.n_hidden = n_hidden
        self.activate = activate
        self.dtype = dtype
        self.dropout = dropout
        self.rel_fc = nn.Linear(d_in, n_hidden, bias=False)
        self.rel_fc_bias = nn.Parameter(torch.zeros(n_hidden))
        self.box_fc = MLP(d_in, n_hidden, activate, dtype=dtype, dropout=dropout)
        self.attr_fc = (MLP(d_in, n_hidden, activate, dtype=dtype, dropout=dropout)
                        if use_attr else None)
        self.img_fc = (MLP(n_in, n_hidden, activate, dtype=dtype, dropout=dropout)
                       if use_img else None)

    def set_model_group(self, mp: ModelGroup) -> None:
        """Serve this model rank's slice of the output features (the
        parameters were cut by ``parallel.tensor_parallel``)."""
        self.model_group = mp
        cols = (*mp.cols(self.n_hidden), self.n_hidden)
        for m in (self, self.box_fc, self.attr_fc, self.img_fc):
            if m is not None:
                m.feature_cols = cols

    def forward(self, x, rel_pairs=None):
        """``rel_pairs``: optional ``(i_idx, j_idx)`` box-pair index tensors
        on the input's device; the relation group then holds only those
        pairs ([B, K, h])."""
        feat = copy_to_model(x["vis_box_feat"].float(), self.model_group)  # [B, P, F]
        B, P, _ = feat.shape
        if self.img_feat:
            inputs = torch.cat([feat, feat.mean(1, keepdim=True).expand_as(feat)], -1)
        else:
            inputs = feat
        rel_u = linear(inputs, self.rel_fc, self.dtype)  # [B, P, h]
        if rel_pairs is not None:
            ti, tj = rel_pairs
            K = ti.numel()
            rows = torch.arange(K, device=rel_u.device)
            inc = rel_u.new_zeros(K, P)
            inc[rows, ti] += 0.5
            inc[rows, tj] += 0.5
            rel = torch.einsum("bnh,kn->bkh", rel_u, inc) + self.rel_fc_bias
        else:
            rel = (rel_u[:, :, None] + rel_u[:, None, :]) / 2 + self.rel_fc_bias
            rel = rel.reshape(B, P * P, -1)
        if self.activate:
            rel = leaky_relu(rel)
        if self.active(self.dropout):
            rel = shared_dropout(rel, self.dropout,
                                 self.keep_mask(shared_keep_shape(rel), self.dropout, rel))
        out = {"box": self.box_fc(inputs), "rel": rel}
        if self.attr_fc is not None:
            out["attr"] = self.attr_fc(inputs)
        if self.img_fc is not None:
            out["img"] = self.img_fc(feat.mean(1, keepdim=True))
        return out


@dataclass(frozen=True)
class ViTConfig:
    """The ViT's dimensions (the fields of ``transformers.ViTConfig`` that
    vlgae_tpu/training/factory.py sets; defaults are HF's)."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    layer_norm_eps: float = 1e-12

    @property
    def n_patches(self) -> int:
        g = self.image_size // self.patch_size
        return g * g


# the dimensions a checkpoint's config.json must agree on
VIT_DIMS = ("hidden_size", "num_hidden_layers", "num_attention_heads",
            "intermediate_size", "image_size", "patch_size")


class ViTPatchProjection(nn.Module):
    """The patch projection: a ``VALID`` convolution with stride = patch
    over NHWC pixels, as a product of the flattened patches with the
    kernel. ``weight`` is ``[out, in, kh, kw]`` (HF's torch layout)."""

    def __init__(self, c: ViTConfig):
        super().__init__()
        p = c.patch_size
        self.weight = nn.Parameter(torch.zeros(c.hidden_size, c.num_channels, p, p))
        self.bias = nn.Parameter(torch.zeros(c.hidden_size))

    def forward(self, px):
        B, H, W, C = px.shape
        out, c_in, p, _ = self.weight.shape
        if C != c_in:
            raise ValueError(f"pixels have {C} channels, the ViT expects {c_in}")
        gh, gw = H // p, W // p
        patches = (px[:, :gh * p, :gw * p].reshape(B, gh, p, gw, p, C)
                   .permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, p * p * C))
        kernel = self.weight.permute(2, 3, 1, 0).reshape(p * p * C, out)
        return patches @ kernel + self.bias


class ViTPatchEmbeddings(nn.Module):
    def __init__(self, c: ViTConfig):
        super().__init__()
        self.projection = ViTPatchProjection(c)


class ViTEmbeddings(nn.Module):
    """Patch embeddings after a CLS token, plus learned positions."""

    def __init__(self, c: ViTConfig):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size))
        self.patch_embeddings = ViTPatchEmbeddings(c)
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, c.n_patches + 1, c.hidden_size))

    def forward(self, px):
        h = self.patch_embeddings.projection(px)
        cls = self.cls_token.expand(h.shape[0], -1, -1)
        return torch.cat([cls, h], 1) + self.position_embeddings


class _Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.dense = nn.Linear(n_in, n_out)


class ViTSelfAttention(nn.Module):
    def __init__(self, c: ViTConfig):
        super().__init__()
        if c.hidden_size % c.num_attention_heads:
            raise ValueError(f"hidden_size {c.hidden_size} is not a multiple of "
                             f"num_attention_heads {c.num_attention_heads}")
        self.n_heads = c.num_attention_heads
        self.query = nn.Linear(c.hidden_size, c.hidden_size)
        self.key = nn.Linear(c.hidden_size, c.hidden_size)
        self.value = nn.Linear(c.hidden_size, c.hidden_size)

    def forward(self, h):
        B, S, H = h.shape
        hd = H // self.n_heads

        def heads(x):
            return x.view(B, S, self.n_heads, hd).transpose(1, 2)

        q = heads(self.query(h)) / (hd ** 0.5)
        w = torch.softmax(q @ heads(self.key(h)).transpose(-1, -2), dim=-1)
        return (w @ heads(self.value(h))).transpose(1, 2).reshape(B, S, H)


class ViTAttention(nn.Module):
    def __init__(self, c: ViTConfig):
        super().__init__()
        self.attention = ViTSelfAttention(c)
        self.output = _Dense(c.hidden_size, c.hidden_size)

    def forward(self, h):
        return self.output.dense(self.attention(h))


class ViTLayer(nn.Module):
    """A pre-LayerNorm block: attention and the exact-GELU MLP, each added
    to its input."""

    def __init__(self, c: ViTConfig):
        super().__init__()
        self.attention = ViTAttention(c)
        self.intermediate = _Dense(c.hidden_size, c.intermediate_size)
        self.output = _Dense(c.intermediate_size, c.hidden_size)
        self.layernorm_before = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.layernorm_after = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, h):
        h = self.attention(self.layernorm_before(h)) + h
        x = F.gelu(self.intermediate.dense(self.layernorm_after(h)))  # exact GELU
        return self.output.dense(x) + h


class ViTEncoder(nn.Module):
    def __init__(self, c: ViTConfig):
        super().__init__()
        self.layer = nn.ModuleList(ViTLayer(c) for _ in range(c.num_hidden_layers))


class ViTModel(nn.Module):
    """The ViT without its pooler (``FlaxViTModule(add_pooling_layer=
    False)``): ``[B, H, W, C]`` pixels to the last hidden states
    ``[B, 1 + patches, hidden]``, CLS first, after the final LayerNorm."""

    def __init__(self, c: ViTConfig):
        super().__init__()
        self.config = c
        self.embeddings = ViTEmbeddings(c)
        self.encoder = ViTEncoder(c)
        self.layernorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, px):
        h = self.embeddings(px)
        for layer in self.encoder.layer:
            h = layer(h)
        return self.layernorm(h)


class VisViTPatchEncoder(nn.Module):
    """Factors of the ViT patch grid (vlgae_tpu/models/vis_encoder.py
    ``VisViTPatchEncoder``): the backbone over ``x["vis_pixels"]`` (NHWC
    f32, always deterministic), its CLS row dropped, the patches fed as
    ``vis_box_feat`` to a :class:`VisBoxRelSimpleEncoder` head. Unless
    ``requires_grad``, the backbone runs without autograd, as the JAX
    package stops its gradient, and the optimizer leaves it out."""

    def __init__(self, n_hidden: int, vit_config: ViTConfig,
                 requires_grad: bool = False, activate: bool = True,
                 use_attr: bool = True, use_img: bool = False,
                 img_feat: bool = True, dtype=None, dropout: float = 0.0):
        super().__init__()
        self.vit_config = vit_config
        self.requires_grad = requires_grad
        self.vit = ViTModel(vit_config)
        self.head = VisBoxRelSimpleEncoder(
            n_in=vit_config.hidden_size, n_hidden=n_hidden, activate=activate,
            use_attr=use_attr, use_img=use_img, img_feat=img_feat, dtype=dtype,
            dropout=dropout)

    def forward(self, x, rel_pairs=None):
        with torch.set_grad_enabled(self.requires_grad and torch.is_grad_enabled()):
            hidden = self.vit(x["vis_pixels"].float())[:, 1:]  # drop CLS
        return self.head({"vis_box_feat": hidden}, rel_pairs=rel_pairs)


def _flatten(tree, prefix=()) -> Dict[str, np.ndarray]:
    """A nested dict of arrays as ``/``-joined paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = np.asarray(v)
    return out


def _backbone(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The backbone's paths of a directory's flat flax params: unwrapped
    from ``params``, and from ``vit`` for a ViTFor... head's tree."""
    for prefix in ("params/", "vit/"):
        if any(k.startswith(prefix) for k in flat) and not any(
                k.startswith("embeddings/") for k in flat):
            flat = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    return flat


def _from_torch_state(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Flat flax params of a torch-layout state (a ViTFor... head keeps the
    backbone under ``vit.``)."""
    from ..convert import torch_to_flax

    if any(k.startswith("vit.") for k in state):
        state = {k[4:]: v for k, v in state.items() if k.startswith("vit.")}
    return torch_to_flax({k: torch.from_numpy(np.array(v, np.float32))
                          for k, v in state.items()})


def _hf_dir_params(path: str, vit_config: ViTConfig) -> Dict[str, np.ndarray]:
    """Flat flax params of a HF checkpoint directory (``config.json`` and
    the first of ``flax_model.msgpack``, ``model.safetensors`` and
    ``pytorch_model.bin``, the order in which transformers' flax loader
    looks), its dimensions checked against the recipe's."""
    from ..utils.serialization import msgpack_restore, read_safetensors

    with open(os.path.join(path, "config.json")) as f:
        disk = json.load(f)
    for key in VIT_DIMS:
        want = getattr(vit_config, key)
        got = disk.get(key, getattr(ViTConfig, key))
        if want != got:
            raise ValueError(
                f"vit_weights checkpoint at {path} has {key}={got} but the "
                f"recipe's vis_encoder expects {key}={want}; align "
                "vis_encoder.vit_* with the checkpoint")
    flax_path = os.path.join(path, "flax_model.msgpack")
    st_path = os.path.join(path, "model.safetensors")
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(flax_path):
        with open(flax_path, "rb") as f:
            return _backbone(_flatten(msgpack_restore(f.read())))
    if os.path.exists(st_path):
        tensors, meta = read_safetensors(st_path)
        if meta.get("format") == "flax":  # flax paths joined with "."
            return _backbone({k.replace(".", "/"): v for k, v in tensors.items()})
        return _from_torch_state(tensors)
    if os.path.exists(bin_path):
        state = torch.load(bin_path, map_location="cpu", weights_only=True)
        return _from_torch_state({k: v.float().numpy() for k, v in state.items()})
    raise ValueError(f"vit_weights at {path}: a checkpoint directory needs "
                     "flax_model.msgpack, model.safetensors or pytorch_model.bin")


def load_vit_params(path, vit_config: ViTConfig) -> Dict[str, torch.Tensor]:
    """Pretrained backbone weights for :class:`VisViTPatchEncoder`
    (``vis_encoder.vit_weights``), as a ``state_dict`` of its ``vit``.

    Accepted, as by vlgae_tpu's ``load_vit_params``: a HF checkpoint
    directory (``config.json``, its dimensions checked against the recipe's,
    and ``flax_model.msgpack``, ``model.safetensors`` or a torch
    ``pytorch_model.bin``), an ``.npz`` of ``/``-joined flax paths, or any
    other file as a flax msgpack of the backbone's tree. A tree or a set of
    paths wrapped in ``params`` is unwrapped. Every parameter the backbone
    has must be there with its flax shape, else a ``ValueError`` names the
    missing or misshapen paths; extra entries (a pooler) are ignored."""
    from ..convert import flax_to_torch, torch_to_flax
    from ..utils.serialization import msgpack_restore

    path = str(path)
    if os.path.isdir(path):
        flat = _hf_dir_params(path, vit_config)
    elif path.endswith(".npz"):
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        if flat and all(k.startswith("params/") for k in flat):
            flat = {k[len("params/"):]: v for k, v in flat.items()}
    else:
        with open(path, "rb") as f:
            tree = msgpack_restore(f.read())
        if isinstance(tree, dict) and set(tree) == {"params"}:
            tree = tree["params"]
        flat = _flatten(tree) if isinstance(tree, dict) else {}
    module = ViTModel(vit_config)
    want = torch_to_flax(module.state_dict())
    missing = [k for k in want if k not in flat]
    bad = [(k, tuple(np.shape(flat[k])), want[k].shape) for k in want
           if k in flat and tuple(np.shape(flat[k])) != want[k].shape]
    if missing or bad:
        msgs = [f"{k} MISSING" for k in missing[:8]]
        msgs += [f"{k} has shape {h}, expected {w}" for k, h, w in bad[:8]]
        raise ValueError(f"vit_weights at {path} do not match the ViT the "
                         "recipe builds: " + "; ".join(msgs))
    return flax_to_torch({k: np.asarray(flat[k], np.float32) for k in want}, module)


def graft_vit_params(model: nn.Module, vit_state: Dict[str, torch.Tensor],
                     scope: str = "vis_encoder.vit") -> nn.Module:
    """Load ``vit_state`` (from :func:`load_vit_params`) into the backbone
    at ``scope`` of ``model``; returns ``model``."""
    try:
        backbone = model.get_submodule(scope)
    except AttributeError:
        backbone = None
    if not isinstance(backbone, ViTModel):
        raise ValueError(
            f"no parameters under {scope.replace('.', '/')}: vit_weights was set "
            "but the model has no ViT backbone there (is the vis_encoder a "
            "VisViTPatchEncoder?)")
    backbone.load_state_dict(vit_state, strict=True)
    return model


def patch_boxes(image_size: int, patch_size: int) -> np.ndarray:
    """``[n_patches, 4]`` (x1, y1, x2, y2) rectangles of a ViT patch grid in
    row-major patch order (the ViT's sequence order): the proposal boxes of
    IoU-based grounding evaluation."""
    g = image_size // patch_size
    return np.array(
        [[c * patch_size, r * patch_size, (c + 1) * patch_size, (r + 1) * patch_size]
         for r in range(g) for c in range(g)],
        dtype=np.float64)
