"""DependencyBoxRel, the joint vision-language grounding model
(counterpart of vlgae_tpu/models/joint.py).

Forward: visual factors, the attention fusion of matched visual features
into the text encoding, the dependency scores, the language factors of
``language_factor_mode`` (``word``: the words alone; ``word+maxdep``: words
and the arcs of the Viterbi tree, two DP passes, log and max, through the
fused kernel K1 on the card; ``word+alldep``: words and every (head, dep)
pair weighted by its marginal, one K1 pass in log, in training only), then
the matching. ``gather_logit_mode=simple`` with the factor-CE loss takes
the reduced matching maxes (kernels K5 forward and K6 backward under
``precision=bf16``; no ``[B, A, Q, V]`` tensor is built); ``reduced``
(caption logits for the caption-image CE and the ``on_img`` decode) builds
the full map with one einsum, as the JAX package does outside any kernel,
and reduces it at once. At eval the grounding decode takes the exact
top-5 (``on_factor``) or the best image of each caption (``on_img``).

Under tensor parallelism (``model_group``, :meth:`set_model_group`) the
visual factor heads are column-parallel and ``vis_mlp_pre_matching``
row-parallel: its partial products are summed over the model group, and the
pre-projection features that the fusion adds to the text encoding are
gathered whole.

Under a data group (``data_group``, set by the pipeline; world 1 by
default) each rank holds its rows of the batch: its captions are matched
against every rank's images (gathered; ``match_maxes_sharded`` under bf16),
and the grounding losses are each rank's share of the global loss, their
counts and normalisers summed over ranks, so that the ranks' gradients sum
to the single-process gradient of the same global batch.

In ``.train()`` mode the dropouts act and the relation group is built
compactly: the inclusive upper triangle of box pairs (rel(i, j) ==
rel(j, i)), with +ln 2 on the off-diagonal pairs in the fusion softmax so
that it equals the full-axis softmax; eval uses the full ``P * P`` axis.
"""

from __future__ import annotations

import dataclasses
import math
import os
from bisect import bisect_left
from itertools import accumulate
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..ops.match import match_maxes_sharded
from ..ops.topk import exact_top_k
from ..parallel.mesh import (DataGroup, ModelGroup, gather_from_model, gather_rows,
                             global_sum, log_softmax_across, reduce_from_model)
from ..struct import dmv_value_and_grads
from ..utils.trace import span
from .ldndmv import DiscriminativeNDMV, LDNDMVConfig
from .nn import MLP

# POS prior sets (the reference's joint.py)
OBJ_POS = ["NN", "NNS", "PRP", "NNP", "WDT", "WP", "NNPS"]
REL_POS = ["IN", "VBZ", "VBG", "VBN", "TO", "VB", "RB", "RP", "VBD", "CC",
           "VBP", "EX", "POS", "FW", "WRB", "MD", "RBR"]
ATTR_POS = ["DT", "JJ", "CD", "PRP$", "JJR", "JJS", "PDT"]

INF = 1e9  # matching mask fill
LN_EPS = 1e-6  # flax LayerNorm default


@dataclasses.dataclass(frozen=True)
class DependencyBoxRelConfig:
    """The strategy strings of the JAX config; an unknown value, or a
    pairing the JAX package rejects, raises its ``ValueError``."""

    add_rel: bool = True
    add_attr: bool = True
    add_image: bool = True
    add_marginal: bool = True
    language_factor_mode: str = "word+maxdep"
    visual_factor_mode: str = "unprune"
    match_hidden: int = 128
    feat_fuse_mode: str = "attention"
    fuse_aug_with_matching: bool = True
    gather_logit_mode: str = "simple"
    loss_grounding_mode: str = "factor|ce"
    loss_use_pos_prior: bool = True
    loss_vis2txt: float = 1.0
    decode_grounding_mode: str = "on_factor"
    decode_use_pos_prior: bool = True
    decode_use_heuristic: bool = True
    grounding_interpolation: float = 0.5
    eval_match_chunk: int = 128
    compact_rel_train: bool = True
    word_encoder_dropout: float = 0.33
    bf16_matmul: bool = False
    # the JAX package's formulation switch: every value takes K5/K6 under
    # bf16 and the f32 stream at precision 32 (a CUDA tensor never leaves
    # the kernels), and under a data group the sharded form
    match_kernel: str = "auto"

    def __post_init__(self):
        allowed = {
            "match_kernel": ("auto", "pallas", "pallas_sharded", "xla"),
            "language_factor_mode": ("word", "word+maxdep", "word+alldep"),
            "visual_factor_mode": ("unprune",),
            "feat_fuse_mode": ("none", "attention"),
            "gather_logit_mode": ("simple", "reduced"),
            "loss_grounding_mode": ("factor|ce", "cap_img|ce"),
            "decode_grounding_mode": ("on_img", "on_factor"),
        }
        for name, values in allowed.items():
            v = getattr(self, name)
            if v not in values:
                raise ValueError(f"{name}={v!r} not in {values}")
        if self.gather_logit_mode == "reduced" and self.decode_grounding_mode != "on_img":
            raise ValueError(
                "gather_logit_mode='reduced' produces [B_txt, B_img] caption "
                "logits; decode_grounding_mode must be 'on_img'")
        if self.loss_grounding_mode == "cap_img|ce" and self.gather_logit_mode != "reduced":
            raise ValueError(
                "loss_grounding_mode='cap_img|ce' consumes the [B_txt, B_img] "
                "caption logits of gather_logit_mode='reduced'; 'simple' "
                "produces a 4-D attention map the caption CE cannot use")
        if self.eval_match_chunk <= 0:
            raise ValueError("eval_match_chunk must be positive")


def _check_match_budget(B, A, Q, chunk, cfg):
    """Loud gate on the f32 stream's [B, A, Q, chunk] block: fail with the
    mode and the shape instead of an opaque out-of-memory error."""
    est_bytes = B * A * Q * chunk * 4
    budget = int(float(os.environ.get("VLGAE_MATCH_EINSUM_BUDGET_GB", "4"))
                 * 2**30)
    if est_bytes > budget:
        raise ValueError(
            f"matching stream would materialize a [B={B}, A={A}, Q={Q}, "
            f"chunk={chunk}] f32 block (~{est_bytes / 2**30:.1f} GiB > budget "
            f"{budget / 2**30:.1f} GiB) under language_factor_mode="
            f"{cfg.language_factor_mode!r}; lower model.eval_match_chunk, "
            f"reduce the batch, or raise VLGAE_MATCH_EINSUM_BUDGET_GB")


class DependencyBoxRel(nn.Module):
    # this process's rows of the batch and the group they are split over; the
    # model group the visual features are sharded over
    data_group = DataGroup()
    model_group = ModelGroup()

    def __init__(self, cfg: DependencyBoxRelConfig, dep_cfg: LDNDMVConfig,
                 dependency: DiscriminativeNDMV, vis_encoder, n_enc: int,
                 n_vis: int, pos_for_obj=(), pos_for_rel=(), pos_for_attr=()):
        super().__init__()
        self.cfg = cfg
        self.dep_cfg = dep_cfg
        self.dependency = dependency
        self.vis_encoder = vis_encoder
        H = cfg.match_hidden
        p = cfg.word_encoder_dropout
        self.word_encoder = MLP(n_enc, H, activate=False, dropout=p)
        self.vis_mlp_pre_matching = nn.Linear(n_vis, H, bias=False)
        if cfg.language_factor_mode != "word":
            # the arc factors' encoders (shared by the max-tree and all-arc
            # factors); the words-only mode has none, as in the JAX package
            self.child_encoder = MLP(n_enc, H, dropout=p)
            self.parent_encoder = MLP(n_enc, H, dropout=p)
            self.arc_encoder_w1 = nn.Parameter(torch.zeros(H, H, H))
            self.arc_encoder_w2 = nn.Parameter(torch.zeros(H, H))
            self.arc_encoder_b = nn.Parameter(torch.zeros(H))
        if cfg.feat_fuse_mode == "attention":
            self.feat_layernorm = nn.LayerNorm(n_enc, eps=LN_EPS)
        for name, ids in (("obj", pos_for_obj), ("rel", pos_for_rel),
                          ("attr", pos_for_attr)):
            self.register_buffer(f"pos_for_{name}", torch.tensor(ids, dtype=torch.long),
                                 persistent=False)

    def set_model_group(self, mp: ModelGroup) -> None:
        self.model_group = mp

    @property
    def vis_factor_names(self):
        names = ["obj"]
        if self.cfg.add_rel:
            names.append("rel")
        if self.cfg.add_attr:
            names.append("attr")
        if self.cfg.add_image:
            names.append("img")
        return names

    # -- vis_feat ----------------------------------------------------------
    def vis_feat(self, inputs, vis_encoded, return_mid: bool = False):
        cfg = self.cfg
        box_mask = inputs["vis_box_mask"]
        B, P = box_mask.shape
        feat, mask, split = [vis_encoded["box"]], [box_mask], [P]
        if cfg.add_rel:
            rel = vis_encoded["rel"]
            feat.append(rel)
            if rel.shape[1] == P * P:
                rel_mask = box_mask[:, None, :] & box_mask[:, :, None]
                rel_mask = torch.triu(rel_mask, 1).reshape(B, -1)
            else:
                # compact inclusive triangle: the strict i < j visibility
                # of the full axis (diagonal pairs masked)
                ti, tj = self._rel_incl_pairs(P, box_mask.device)
                rel_mask = box_mask[:, ti] & box_mask[:, tj] & (ti != tj)[None]
            mask.append(rel_mask)
            split.append(rel.shape[1])
        if cfg.add_attr:
            feat.append(vis_encoded["attr"])
            mask.append(box_mask)
            split.append(P)
        if cfg.add_image:
            feat.append(vis_encoded["box"].mean(1, keepdim=True))
            mask.append(torch.ones(B, 1, dtype=torch.bool, device=box_mask.device))
            split.append(1)
        mid = torch.cat(feat, 1)  # this model rank's features
        vis = reduce_from_model(self.vis_mlp_pre_matching(mid), self.model_group)
        vis_mask = torch.cat(mask, 1)
        if return_mid:
            return vis, vis_mask, tuple(split), mid
        return vis, vis_mask, tuple(split)

    @staticmethod
    def _rel_incl_pairs(P, device):
        """Inclusive-triangle (i <= j) box-pair indices ``(ti, tj)``."""
        return tuple(torch.triu_indices(P, P, 0, device=device))

    def _rel_logmult(self, split, device):
        """[V] log-multiplicity of the compact factor axis: ln 2 on the
        off-diagonal pairs (each stands for two full-axis entries)."""
        parts = []
        for name, w in zip(self.vis_factor_names, split):
            if name == "rel":
                ti, tj = self._rel_incl_pairs(split[0], device)
                parts.append((ti != tj).float() * math.log(2.0))
            else:
                parts.append(torch.zeros(w, device=device))
        return torch.cat(parts)

    # -- lang_feat -----------------------------------------------------------
    @staticmethod
    def _root_prepended(x, mask, seq_len):
        root = (torch.where(mask[..., None], x, 0.0).sum(1)
                / torch.clamp_min(seq_len, 1)[:, None])[:, None]
        return torch.cat([root, x], 1)

    def lang_feat_word_only(self, inputs, encoded, lang_score, mask, tables=None):
        """The words alone: ``(word_repr, q_mask, q_mask as f32, None)``."""
        B = mask.shape[0]
        q_mask = torch.cat([mask.new_zeros(B, 1), mask], 1)
        x = self._root_prepended(encoded["x"], mask, inputs["seq_len"])
        return self.word_encoder(x), q_mask, q_mask.float(), None

    def arc_tables(self, inputs, lang_score):
        """The DP passes the arc factors read, on the detached merged
        potentials of ``lang_score`` (K1 on the card): ``(log, max)``, each
        ``(per-sentence total, d/d dec, d/d attach)``; ``max`` is None where
        only the marginals are read (``word+alldep`` in training); None for
        the words alone."""
        mode = self.cfg.language_factor_mode
        if mode == "word":
            return None
        dec = lang_score["merged_dec"].detach()
        attach = lang_score["merged_attach"].detach()
        log = dmv_value_and_grads(dec, attach, inputs["seq_len"], "log")
        if mode == "word+alldep" and self.training:
            return log, None
        return log, dmv_value_and_grads(dec, attach, inputs["seq_len"], "max")

    def _arc_common(self, inputs, encoded, mask):
        """What both arc modes share: the word mask with the root slot, the
        root-prepended words and their word and child encodings."""
        q_mask = torch.cat([mask.new_zeros(mask.shape[0], 1), mask], 1)
        x = self._root_prepended(encoded["x"], mask, inputs["seq_len"])
        return q_mask, x, self.word_encoder(x), self.child_encoder(x)

    def lang_feat_max_tree(self, inputs, encoded, lang_score, mask, tables=None):
        """Words + arcs of the Viterbi tree; ``tables``: the passes of
        :meth:`arc_tables` (run here on ``lang_score`` when None)."""
        B = mask.shape[0]
        if tables is None:
            tables = self.arc_tables(inputs, lang_score)
        log, (vmax, gd_max, ga_max) = tables
        q_mask, x, word_repr, child_repr = self._arc_common(inputs, encoded, mask)
        arc_margin = log[2].sum(-1)  # [B, L+1, L+1]
        dep_reuse = {"log": log, "max": (vmax, gd_max, ga_max)}
        ind = ga_max.sum(-1)
        predicted = torch.cat(
            [torch.zeros(B, 1, dtype=torch.long, device=mask.device),
             torch.argmax(ind[:, :, 1:], dim=1)], 1)  # head of each position
        if self.cfg.add_marginal:
            # row q reads marg[q, head(q)]: the marginal of the REVERSED arc
            # (q -> head(q)), a quirk of the reference kept bit-for-bit
            arc_margin = torch.gather(arc_margin, 2, predicted[..., None])[..., 0]
        else:
            arc_margin = q_mask.float()
        txt_marginal = torch.cat([q_mask.to(arc_margin.dtype), arc_margin], 1)

        parent_x = torch.gather(x, 1, predicted[..., None].expand(-1, -1, x.shape[-1]))
        parent_repr = self.parent_encoder(parent_x)
        arc_repr = (
            torch.einsum("bcx,xhy,bcy->bch", child_repr, self.arc_encoder_w1,
                         parent_repr)
            + (child_repr + parent_repr) @ self.arc_encoder_w2
            + self.arc_encoder_b
        )
        txt = torch.cat([word_repr, arc_repr], 1)
        return txt, torch.cat([q_mask, q_mask], 1), txt_marginal, dep_reuse

    def lang_feat_all_arc(self, inputs, encoded, lang_score, mask, tables=None):
        """Words + every (head, dep) pair, head-major, weighted by the
        pair's arc marginal (the K1 log tables go to ``dep_reuse['log']``);
        words weigh 1, the root 0. The factorized bilinear of
        :meth:`lang_feat_max_tree` over all pairs, with its parameters. At
        eval the Viterbi-tree factors."""
        if not self.training:
            return self.lang_feat_max_tree(inputs, encoded, lang_score, mask, tables)
        B, L = mask.shape
        N = L + 1
        log = (tables if tables is not None else self.arc_tables(inputs, lang_score))[0]
        q_mask, x, word_repr, child_repr = self._arc_common(inputs, encoded, mask)
        pair_mask = (q_mask[:, :, None] & q_mask[:, None, :]).reshape(B, -1)
        arc_margin = log[2].sum(-1).reshape(B, -1)  # [B, N*N]
        txt_marginal = torch.cat([q_mask.to(arc_margin.dtype), arc_margin], 1)

        parent_repr = self.parent_encoder(x)
        # the child side through w1 first: [B, N, H, H], then every parent
        cw = torch.einsum("bcx,xhy->bchy", child_repr, self.arc_encoder_w1)
        arc_repr = (
            torch.einsum("bchy,bpy->bpch", cw, parent_repr)
            + (child_repr @ self.arc_encoder_w2)[:, None]
            + (parent_repr @ self.arc_encoder_w2)[:, :, None]
            + self.arc_encoder_b
        ).reshape(B, N * N, -1)
        txt = torch.cat([word_repr, arc_repr], 1)
        return txt, torch.cat([q_mask, pair_mask], 1), txt_marginal, {"log": log}

    def lang_feat(self, inputs, encoded, lang_score, mask, tables=None):
        """``(txt, txt_mask, txt_marginal, dep_reuse)`` of the configured
        language factors (``tables``: those of :meth:`arc_tables`)."""
        fn = {"word": self.lang_feat_word_only,
              "word+alldep": self.lang_feat_all_arc,
              }.get(self.cfg.language_factor_mode, self.lang_feat_max_tree)
        return fn(inputs, encoded, lang_score, mask, tables)

    def factors(self, inputs, encoded, vis_encoded, mask, tables):
        """The grounding's factors, from the parser's DP tables on:
        ``(vis, txt, dep_reuse)``, ``vis`` and ``txt`` as
        :meth:`vis_feat` and :meth:`lang_feat` pack them."""
        vis = self.vis_feat(inputs, vis_encoded)
        *txt, dep_reuse = self.lang_feat(inputs, encoded, None, mask, tables)
        return vis, tuple(txt), dep_reuse

    # -- reduced matching ----------------------------------------------------
    def gather_logit_train(self, vis, txt):
        """``(logit [B, A, Q], logit_v [B, A, V])``: maxima of the pairwise
        matching product without a ``[B, A, Q, V]`` tensor. A full-axis
        relation group is compacted to its strict upper triangle (the only
        pairs the mask keeps) and expanded back (-INF) afterwards; the
        compact training axis is used as it is. Under bf16 the fused
        kernels compute it (:class:`MatchMaxesFn`: K5, and K6 for the
        gradient); at f32 a factor-chunked stream under autograd, as in the
        JAX package, which also computes that case outside any kernel. Under
        a data group the captions are this rank's and the images every
        rank's: ``[B_local, A, *]``.
        """
        dp = self.data_group
        if self.cfg.bf16_matmul:
            args, maps = self.match_operands(vis, txt)
            logit, _, logit_v, _ = match_maxes_sharded(*args, dp)
        else:
            (vis_feat, txt_feat, vb, tb), maps = self.match_operands(vis, txt, dtype=None)
            (B, V), Q = vb.shape, tb.shape[1]
            chunk = min(V, self.cfg.eval_match_chunk)
            _check_match_budget(B, B * dp.world, Q, chunk, self.cfg)
            logit, logit_v = self._match_maxes_chunked(
                gather_rows(vis_feat.float(), dp), txt_feat.float(),
                gather_rows(vb, dp), tb, chunk)
        return logit, self._expand_rel_tri(logit_v, maps)

    def match_operands(self, vis, txt, dtype=torch.bfloat16):
        """``((vis, txt, vis_bias, txt_bias), maps)``: the matching
        maxes' operands (cast to ``dtype`` and contiguous, K5's inputs under
        bf16; as they are with ``dtype`` None), their f32 visibility biases
        (-INF off the masks) and the relation group's compaction maps of
        :meth:`_rel_tri_maps`."""
        maps = self._rel_tri_maps(vis[2], vis[0].device)
        vis_feat, vis_mask = vis[0], vis[1]
        if maps is not None:
            vis_feat, vis_mask = vis_feat[:, maps[0]], vis_mask[:, maps[0]]
        txt_feat, txt_mask = txt[0], txt[1]
        vb = -INF * (1.0 - vis_mask.float())
        tb = -INF * (1.0 - txt_mask.float())
        if dtype is None:
            return (vis_feat, txt_feat, vb, tb), maps
        return (vis_feat.to(dtype).contiguous(), txt_feat.to(dtype).contiguous(),
                vb.contiguous(), tb.contiguous()), maps

    @staticmethod
    def _match_maxes_chunked(vis, txt, vb, tb, chunk):
        """f32 maxes streamed over factor chunks (``[B, A, Q, chunk]`` at a
        time): max over v carried across chunks, max over q per chunk."""
        A, V, _ = vis.shape
        run = None
        parts = []
        for v0 in range(0, V, chunk):
            att = torch.einsum("bqd,avd->baqv", txt, vis[:, v0:v0 + chunk])
            att = att + vb[None, :, None, v0:v0 + chunk] + tb[:, None, :, None]
            m = att.amax(-1)
            run = m if run is None else torch.maximum(run, m)
            parts.append(att.amax(-2))
        return run, torch.cat(parts, -1)

    def _rel_tri_maps(self, split, device):
        """(keep, inv) index maps compacting the relation group to its
        strict upper triangle; dropped slots map to a sentinel column.
        Built on ``device`` (no host copy in the step). ``None`` without a
        relation group or when the axis is already compact (training)."""
        if "rel" not in self.vis_factor_names or split[1] != split[0] ** 2:
            return None
        P = split[0]
        starts = [0] + list(accumulate(split))
        keep = []
        for name, s0, w in zip(self.vis_factor_names, starts, split):
            if name == "rel":
                ti, tj = torch.triu_indices(P, P, 1, device=device)
                keep.append(s0 + ti * P + tj)
            else:
                keep.append(torch.arange(s0, s0 + w, device=device))
        keep = torch.cat(keep)
        inv = torch.full((int(sum(split)),), keep.numel(), dtype=torch.long,
                         device=device)
        inv[keep] = torch.arange(keep.numel(), device=device)
        return keep, inv

    @staticmethod
    def _expand_rel_tri(logit_v, maps):
        if maps is None:
            return logit_v
        pad = logit_v.new_full(logit_v.shape[:-1] + (1,), -INF)
        return torch.cat([logit_v, pad], -1)[..., maps[1]]

    # -- the full map ---------------------------------------------------------
    def gather_logit(self, vis, txt):
        """The ``[B, A]`` caption logits of ``gather_logit_mode='reduced'``:
        the full ``[B, A, Q, V]`` map (masked to -INF), each word's best
        factor, averaged over the caption with ``txt_marginal``. Under bf16
        the operands are rounded to bf16 and multiplied with f32
        accumulation, as the JAX package's einsum does. Under a data group,
        ``[B_local, A]``: this rank's captions against every image."""
        dp = self.data_group
        vis_feat = gather_rows(vis[0], dp)
        vis_mask = gather_rows(vis[1].float(), dp) > 0
        txt_feat, txt_mask, txt_marginal = txt[:3]
        if self.cfg.bf16_matmul:
            vis_feat = vis_feat.to(torch.bfloat16).float()
            txt_feat = txt_feat.to(torch.bfloat16).float()
        attmap = torch.einsum("avd,bqd->baqv", vis_feat, txt_feat)
        attmap = torch.where(vis_mask[None, :, None, :], attmap, -INF)
        attmap = torch.where(txt_mask[:, None, :, None], attmap, -INF)
        maxatt = attmap.amax(-1)  # [B, A, Q]
        return ((maxatt * txt_marginal[:, None]).sum(-1)
                / (txt_marginal.sum(1, keepdim=True) + 1e-9))

    def _diag_att(self, out, inputs, with_pen: bool):
        """Own-image [B, Q, V] matching block (f32) with masks and,
        optionally, the POS-prior penalty."""
        vis_feat, vis_mask, vis_split = out["vis_packed"][:3]
        txt_feat, txt_mask = out["txt_packed"][:2]
        att = torch.einsum("bvd,bqd->bqv", vis_feat.float(), txt_feat.float())
        att = torch.where(vis_mask[:, None, :], att, -INF)
        att = torch.where(txt_mask[:, :, None], att, -INF)
        if with_pen:
            att = att + self._pos_prior_mask(att, inputs["tag"], vis_split)
        return att

    def fuse_with_matching(self, inputs, vis_encoded, encoded, mask,
                           compact: bool = False):
        """Soft-match every word against the visual factors and add the
        matched (pre-projection) features back into the text encoding."""
        vis = self.vis_feat(inputs, vis_encoded, return_mid=True)
        word = self.lang_feat_word_only(inputs, encoded, None, mask)[0]
        fuse_logits = torch.einsum("bvd,bqd->bqv", vis[0], word[:, 1:])
        if compact:
            fuse_logits = fuse_logits + self._rel_logmult(vis[2], vis[0].device)
        attmap = torch.softmax(fuse_logits, 2)
        mid = gather_from_model(vis[3], self.model_group)
        x_aug = torch.einsum("bqv,bvh->bqh", attmap, mid)
        return {**encoded, "x": self.feat_layernorm(encoded["x"] + x_aug)}

    # -- forward --------------------------------------------------------------
    def forward(self, inputs: Dict[str, Any], with_grounding: bool = True):
        """The score dict; ``with_grounding=False`` stops after the
        dependency scores (the warm-up loss reads nothing else). It runs
        in the stretches that the pipeline's CUDA graphs replay in training
        (``training/graphs.py``): :meth:`potentials`, the DP passes of
        :meth:`arc_tables` (K1), :meth:`factors` and
        :meth:`match_operands`, the matching maxes (K5)."""
        cfg = self.cfg
        out, encoded, vis_encoded, mask = self.potentials(inputs)
        if not with_grounding:
            return out
        with span("vlgae.forward.grounding"):
            tables = self.arc_tables(inputs, out)
            vis, txt, dep_reuse = self.factors(inputs, encoded, vis_encoded, mask, tables)
            out.update({"vis_packed": vis, "txt_packed": txt})
            if dep_reuse is not None:
                out["dep_reuse"] = dep_reuse
            if cfg.gather_logit_mode == "simple" and cfg.loss_grounding_mode == "factor|ce":
                out["match_reduced"] = self.gather_logit_train(vis, txt)
                out["match_logit"] = out["match_reduced"][0]  # [B, A, Q]
            else:
                out["match_logit"] = self.gather_logit(vis, txt)
        return out

    def potentials(self, inputs: Dict[str, Any], frozen=None):
        """The forward up to the parser's scores and merged potentials:
        the visual factor heads, the text side, the fusion and the parser;
        ``frozen``: the frozen embedding items' words
        (``CompositeEmbedding.frozen``), computed beforehand. Returns
        ``(scores, encoded, vis_encoded, mask)``."""
        cfg = self.cfg
        token = inputs["token"]
        mask = (torch.arange(token.shape[1], device=token.device)[None, :]
                < inputs["seq_len"][:, None])
        compact = self.training and cfg.add_rel and cfg.compact_rel_train
        rel_pairs = None
        if compact:
            rel_pairs = self._rel_incl_pairs(inputs["vis_box_mask"].shape[1],
                                             token.device)
        with span("vlgae.forward.visual"):
            vis_encoded = self.vis_encoder(inputs, rel_pairs=rel_pairs)
        with span("vlgae.forward.text"):
            emb, aux = self.dependency.embedding(inputs, frozen)
            encoded = self.dependency.encoder(emb, mask)
        if cfg.feat_fuse_mode == "attention" and cfg.fuse_aug_with_matching:
            encoded = self.fuse_with_matching(inputs, vis_encoded, encoded, mask,
                                              compact=compact)
        with span("vlgae.forward.dmv"):
            out = dict(self.dependency(inputs, encoded, (emb, aux)))
        return out, encoded, vis_encoded, mask

    # -- grounding loss -----------------------------------------------------
    def _pos_prior_mask(self, attmap, tag, vis_split, scale: float = 100.0):
        """Subtract ``scale`` on the word rows (1..L) of tokens in a POS
        prior set, for every factor column outside that set's group."""
        L = tag.shape[1]
        Q, V = attmap.shape[-2], attmap.shape[-1]
        v_pos = torch.arange(V, device=attmap.device)
        pen = attmap.new_zeros((tag.shape[0], Q, V))
        offset = 0
        for name, width in zip(self.vis_factor_names, vis_split):
            if name == "img":
                offset += width
                continue
            # torch.isin by one comparison a set member: isin sorts (and
            # syncs with the host) when the set is large beside the batch
            ids = getattr(self, f"pos_for_{name}").to(tag.dtype)
            in_prior = (tag[..., None] == ids).any(-1)
            outside = (v_pos < offset) | (v_pos >= offset + width)  # [V]
            token_in_prior = torch.zeros(tag.shape[0], Q, dtype=torch.bool,
                                         device=tag.device)
            token_in_prior[:, 1:L + 1] = in_prior
            pen = pen - scale * (token_in_prior[:, :, None]
                                 & outside[None, None, :]).to(attmap.dtype)
            offset += width
        return pen

    def _own_images(self, B, device):
        """``(own [B, A], offset)``: each of this rank's captions marks its
        own image among all ranks' (the diagonal, offset by this rank's first
        row)."""
        dp = self.data_group
        offset = dp.rank * B
        rows = torch.arange(B, device=device)[:, None] + offset
        return rows == torch.arange(B * dp.world, device=device)[None, :], offset

    def loss_grounding_factor_ce(self, out, inputs):
        """The factor CE on the reduced maxes, their own-image entries from
        the recomputed diagonal block that carries the POS-prior penalty.
        Under a data group the text axis of ``logit_v`` is split over the
        ranks (its log-softmax sums across them) and the token count and
        the normalisers are global sums."""
        cfg = self.cfg
        dp = self.data_group
        txt_marginal = out["txt_packed"][2]
        vis_mask = out["vis_packed"][1]
        logit, logit_v = out["match_reduced"]
        B = logit.shape[0]
        att_d = self._diag_att(out, inputs, with_pen=cfg.loss_use_pos_prior)
        eye, offset = self._own_images(B, logit.device)
        logit = torch.where(eye[:, :, None], att_d.amax(-1)[:, None, :], logit)
        logit_v = torch.where(eye[:, :, None], att_d.amax(-2)[:, None, :], logit_v)
        # filler rows of the batch padding are masked out of both axes
        row = inputs["seq_len"] > 0
        row_all = gather_rows(row.float(), dp) > 0
        num_token = global_sum(inputs["seq_len"].sum(), dp)
        logit = torch.where(row_all[None, :, None], logit, -INF)
        logit = torch.log_softmax(logit, 1)
        diag = torch.diagonal(logit, offset, 0, 1).T  # [B, Q]
        txt2vis = -(diag * txt_marginal * row[:, None]).sum()
        # each term is normalised by a detached copy of itself: the value
        # is num_token, the gradient that of the term / its value
        loss = {"txt2vis": txt2vis / (global_sum(txt2vis.detach(), dp) + 1e-6)
                * num_token}
        if cfg.loss_vis2txt > 0:
            logit_v = torch.where(row[:, None, None], logit_v, -INF)
            logit_v = log_softmax_across(logit_v, dp)
            diag_v = torch.diagonal(logit_v, offset, 0, 1).T  # [B, V]
            vis2txt = -(diag_v * vis_mask * row[:, None]).sum()
            loss["mt_vis2txt"] = (cfg.loss_vis2txt * vis2txt
                                  / (global_sum(vis2txt.detach(), dp) + 1e-6) * num_token)
        return sum(loss.values()), loss

    def loss_grounding_cap_img(self, out, inputs):
        """Caption-image CE over the ``[B, A]`` caption logits of the
        reduced map, averaged over the real captions; filler rows of the
        batch padding are masked out of both axes."""
        dp = self.data_group
        row = inputs["seq_len"] > 0
        row_all = gather_rows(row.float(), dp) > 0
        logit = torch.where(row_all[None, :], out["match_logit"], -INF)
        diag = torch.diagonal(torch.log_softmax(logit, 1), dp.rank * row.shape[0])
        loss = -(diag * row).sum() / torch.clamp_min(global_sum(row.sum(), dp), 1)
        return loss, {"mt": loss}

    def loss(self, out, inputs, dep_loss, dep_aux=None, alpha=None,
             train: bool = True):
        """Interpolated joint objective ``(total, per-term dict)``; the
        grounding term counts only when two real captions have images.
        ``factor|ce`` is the same in training and at eval; ``cap_img|ce``
        contributes 0 at eval (``train=False``), as in the JAX package."""
        if alpha is None:
            alpha = self.cfg.grounding_interpolation
        if self.cfg.loss_grounding_mode == "factor|ce":
            mt_loss, mt_aux = self.loss_grounding_factor_ce(out, inputs)
        elif not train:
            mt_loss, mt_aux = dep_loss.new_zeros(()), {}
        else:
            mt_loss, mt_aux = self.loss_grounding_cap_img(out, inputs)
        real_avail = inputs["vis_available"] & (inputs["seq_len"] > 0)
        enough = (global_sum(real_avail.sum(), self.data_group) >= 2).to(mt_loss.dtype)
        mt_loss = mt_loss * enough * float(alpha > 0)
        return (alpha * mt_loss + (1 - alpha) * dep_loss,
                {**(dep_aux or {}), **mt_aux})

    # -- grounding decode (device part) -------------------------------------
    def decode_grounding_device(self, out, inputs, topk: int = 5):
        """``on_factor``: the top-``topk`` factors of each word and arc
        (``txt_to_factor_idx``) and each one's best image; ``on_img``: the
        best image of each caption alone (``txt_to_img [B]``)."""
        match_logit = out["match_logit"]
        if self.cfg.decode_grounding_mode == "on_img":
            return {"txt_to_img": match_logit.argmax(1)}
        factor2img = match_logit.argmax(1)  # [B, Q]
        logit = self.decode_grounding_logits(out, inputs)
        _, top_idx = exact_top_k(logit, topk)  # [B, Q, k]
        return {"txt_to_factor_idx": top_idx, "txt_to_img": factor2img}

    def decode_grounding_logits(self, out, inputs):
        """Diagonal decode logits [B, Q, V]: deep mask at -1e20, POS priors
        at -1e10, then the best-box heuristics."""
        cfg = self.cfg
        _, vis_mask, vis_split = out["vis_packed"][:3]
        logit = self._diag_att(out, inputs, with_pen=False)
        txt_mask = out["txt_packed"][1]
        logit = torch.where(vis_mask[:, None, :] & txt_mask[:, :, None], logit,
                            torch.tensor(-1e20, dtype=logit.dtype, device=logit.device))
        if cfg.decode_use_pos_prior:
            logit = logit + self._pos_prior_mask(logit, inputs["tag"], vis_split,
                                                 scale=1e10)
        if cfg.decode_use_heuristic:
            logit = self._decode_heuristic(logit, vis_split, inputs["token"].shape[1])
        return logit

    def _decode_heuristic(self, logit, vis_split, L):
        """Constrain rel/attr to best-aligned boxes."""
        names = self.vis_factor_names
        P = vis_split[0]
        box_logit = logit[..., :P]
        aligned_value = logit.amax(-1)  # [B, Q]
        box_max_val = box_logit.amax(-1)
        box_max_ind = box_logit.argmax(-1)
        B, Q = box_max_val.shape
        allowed = (box_max_val == aligned_value) & (box_max_val > -1e5)
        allowed_word = allowed.clone()
        allowed_word[:, L + 1:] = False
        onehot = nn.functional.one_hot(box_max_ind, P).bool()
        out_parts = [box_logit]
        offset = P
        for name, width in zip(names[1:], vis_split[1:]):
            part = logit[..., offset:offset + width]
            if name == "rel":
                am = (onehot & allowed_word[..., None]).any(1)  # [B, P]
                am2 = (am[:, :, None] & am[:, None, :]).reshape(B, 1, P * P)
                part = torch.where(am2, part, part - 100.0)
                part = part.reshape(B, Q, P, P)
                eye = torch.eye(P, dtype=torch.bool, device=logit.device)
                part = torch.where(eye[None, None], -1e10, part)
                part = part.reshape(B, Q, P * P)
            elif name == "attr":
                am = (onehot & allowed[..., None]).any(1)  # [B, P]
                part = torch.where(am[:, None, :], part, -1e10)
            out_parts.append(part)
            offset += width
        return torch.cat(out_parts, -1)

    # -- host-side formatting -------------------------------------------------
    def format_grounding(self, top_idx, vis_split, seq_len, box_index, txt_mask):
        """Map flat factor indices to (factor_name, box ids) lists."""
        names = self.vis_factor_names
        start_points = [0] + list(accumulate(vis_split))
        results = []
        top_idx = np.asarray(top_idx)
        txt_mask = np.asarray(txt_mask)
        for b in range(top_idx.shape[0]):
            inst = []
            for q in range(top_idx.shape[1]):
                if not txt_mask[b, q]:
                    continue
                token_out = []
                for idx in top_idx[b, q].tolist():
                    g = bisect_left(start_points, idx)
                    if g == len(start_points) or start_points[g] != idx:
                        g -= 1
                    name = names[g]
                    idx -= start_points[g]
                    if name == "rel":
                        P = vis_split[0]
                        token_out.append(
                            (name, (int(box_index[b][idx // P]),
                                    int(box_index[b][idx % P]))))
                    else:
                        token_out.append((name, int(box_index[b][idx])))
                inst.append(token_out)
            results.append(inst)
        return results
