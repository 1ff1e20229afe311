"""Visual factor encoder (counterpart of vlgae_tpu/models/vis_encoder.py,
``VisBoxRelSimpleEncoder``).

Box / relation (box-pair) / attribute factor embeddings from Faster-RCNN
box features. The pairwise-mean relation MLP is factorized: each box is
projected once and the pair sum is taken before the activation, so the
``[B, P, P, 2H]`` input never exists. At eval the relation group covers
the full ``P * P`` pair axis; in training the caller may ask for only the
pairs ``rel_pairs`` (the inclusive upper triangle, since rel(i, j) ==
rel(j, i)), produced by a product with a 0.5/0.5 incidence matrix. With
``dtype=bfloat16`` the 2048-d projections run in bf16 and return f32, as
under ``precision=bf16`` in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from .nn import MLP, Dropping, leaky_relu, linear, shared_dropout, shared_keep_shape


class VisBoxRelSimpleEncoder(Dropping):
    def __init__(self, n_in: int, n_hidden: int, activate: bool = True,
                 use_attr: bool = True, use_img: bool = False,
                 img_feat: bool = True, dtype=None, dropout: float = 0.0):
        super().__init__()
        if use_img:
            raise NotImplementedError("vis_encoder.use_img is not ported")
        d_in = 2 * n_in if img_feat else n_in
        self.img_feat = img_feat
        self.activate = activate
        self.dtype = dtype
        self.dropout = dropout
        self.rel_fc = nn.Linear(d_in, n_hidden, bias=False)
        self.rel_fc_bias = nn.Parameter(torch.zeros(n_hidden))
        self.box_fc = MLP(d_in, n_hidden, activate, dtype=dtype, dropout=dropout)
        self.attr_fc = (MLP(d_in, n_hidden, activate, dtype=dtype, dropout=dropout)
                        if use_attr else None)

    def forward(self, x, rel_pairs=None):
        """``rel_pairs``: optional ``(i_idx, j_idx)`` box-pair index tensors
        on the input's device; the relation group then holds only those
        pairs ([B, K, h])."""
        feat = x["vis_box_feat"].float()  # [B, P, F]
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
        return out
