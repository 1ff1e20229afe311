"""Discriminative neural DMV (counterpart of vlgae_tpu/models/ldndmv.py):
the forward (with the dropouts of its scorer stack in training), stand-alone
(``exp=lang_only``) or inside the joint model; the NLL, as a straight-through
linearisation around the reused DP results or as a DP of its own; the
warm-up losses against rule-count targets and against a frozen DMV's expected
counts; and the Viterbi and MBR decodes."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..struct import NEGINF, DependencyCRF, DMV1o, dmv_merge, dmv_value_and_grads
from ..struct.dmv import LEFT, RIGHT
from .nn import MLP, DMVFactorizedBilinear, DMVSkipConnectEncoder

# POS tags whose words may not act as heads
FUNCTION_POS = ("ADP", "AUX", "CCONJ", "SCONJ", "CONJ", "DET", "PART")


@dataclasses.dataclass(frozen=True)
class LDNDMVConfig:
    """The subset of vlgae_tpu's ``LDNDMVConfig`` that ``exp=vlgae`` and
    ``exp=lang_only`` read."""

    context_mode: str = "mean"  # hx | mean | none
    strict_pad_context: bool = False
    init_method: str = "y"  # 'y' | 'none'
    init_epoch: int = 0
    viterbi_training: bool = True
    mbr_decoding: bool = False
    extended_valence: bool = True
    function_mask: bool = False
    variational_mode: str = "none"
    hidden_size: int = 256
    mid_bottleneck: int = 0
    mid_n_mid: int = 0
    mid_dropout: float = 0.0
    ff_dropout: float = 0.33
    attach_rank: int = 16
    dec_rank: int = 16
    root_rank: int = 16
    root_emb_dim: int = 10
    dec_emb_dim: int = 10

    def __post_init__(self):
        if self.context_mode not in ("hx", "mean", "none"):
            raise NotImplementedError(
                f"context_mode={self.context_mode!r} is not ported")
        if self.variational_mode != "none":
            raise NotImplementedError(
                f"variational_mode={self.variational_mode!r} is not ported")
        if self.init_method not in ("y", "none"):
            raise NotImplementedError(
                f"init_method={self.init_method!r} (a pretrained DMV) is not ported")


class DiscriminativeNDMV(nn.Module):
    def __init__(self, cfg: LDNDMVConfig, embedding, encoder, n_enc: int,
                 token2word: Optional[Tuple[int, ...]] = None,
                 token2tag: Optional[Tuple[int, ...]] = None,
                 function_mask_ids: Tuple[int, ...] = ()):
        super().__init__()
        self.cfg = cfg
        self.embedding = embedding
        self.encoder = encoder
        H = cfg.hidden_size
        n_tok = sum(item.embed_size for item in embedding.items
                    if (item.name == "word_embedding" and token2word is not None)
                    or (item.name == "tag_embedding" and token2tag is not None))
        n_head_in = embedding.embed_size + (n_enc if cfg.context_mode != "none" else 0)
        p = cfg.ff_dropout
        self.head_ff = MLP(n_head_in, H, dropout=p)
        self.child_ff = MLP(n_tok, H, dropout=p)
        self.root_ff = MLP(cfg.root_emb_dim, H, dropout=p)
        self.dec_ff = MLP(cfg.dec_emb_dim, H, dropout=p)
        self.mid_ff = DMVSkipConnectEncoder(H, cfg.mid_bottleneck, cfg.mid_n_mid,
                                            cfg.mid_dropout)
        self.attach_scorer = DMVFactorizedBilinear(H, cfg.attach_rank)
        self.dec_scorer = DMVFactorizedBilinear(H, cfg.dec_rank)
        self.root_scorer = DMVFactorizedBilinear(H, cfg.root_rank)
        self.root_emb = nn.Parameter(torch.randn(1, cfg.root_emb_dim))
        self.dec_emb = nn.Parameter(torch.randn(2, cfg.dec_emb_dim))
        self.register_buffer(
            "token2word", None if token2word is None
            else torch.tensor(token2word, dtype=torch.long), persistent=False)
        self.register_buffer(
            "token2tag", None if token2tag is None
            else torch.tensor(token2tag, dtype=torch.long), persistent=False)
        self.register_buffer(
            "function_mask_ids", torch.tensor(function_mask_ids, dtype=torch.long),
            persistent=False)

    def token_emb(self):
        """Vocab-level token embeddings."""
        parts = []
        if self.token2word is not None:
            parts.append(self.embedding.embed_item("word_embedding", self.token2word))
        if self.token2tag is not None:
            parts.append(self.embedding.embed_item("tag_embedding", self.token2tag))
        return torch.cat(parts, -1)

    def extract_sent_repr(self, encoded, mask):
        cfg = self.cfg
        if cfg.context_mode == "none":
            return None
        x = encoded["x"]
        B, L, _ = x.shape
        if cfg.context_mode == "hx":
            # the last layer's final states of both directions [2, B, H]
            context = encoded["hiddens"].transpose(0, 1).reshape(B, 1, -1)
        elif cfg.strict_pad_context:
            context = x.mean(1, keepdim=True)
        else:
            denom = torch.clamp_min(mask.sum(-1, keepdim=True), 1)
            context = (torch.where(mask[..., None], x, 0.0).sum(1, keepdim=True)
                       / denom[..., None])
        if L > 1:
            context = context.expand(B, L, context.shape[-1])
        return context

    def forward(self, inputs: Dict[str, Any], encoded=None, emb_aux=None):
        """The score dict. The joint model hands over its own embedding and
        encoding (one dropout draw shared with its text side); stand-alone
        the module embeds and encodes itself."""
        cfg = self.cfg
        token = inputs["token"].long()
        b, n = token.shape
        mask = (torch.arange(n, device=token.device)[None, :]
                < inputs["seq_len"][:, None])
        emb, aux = self.embedding(inputs) if emb_aux is None else emb_aux
        if encoded is None:
            encoded = self.encoder(emb, mask)
        out: Dict[str, Any] = {"encoded": encoded, "emb": emb}
        context = self.extract_sent_repr(encoded, mask)
        h = emb if context is None else torch.cat([emb, context], -1)

        h_parent = self.mid_ff(self.head_ff(h))
        h_child = self.mid_ff(self.child_ff(self.token_emb()))[None]
        h_root = self.mid_ff(self.root_ff(self.root_emb))[None]
        h_dec = self.mid_ff(self.dec_ff(self.dec_emb))[None]

        # attach: [b, n, dir, val, n_token] -> gather child tokens
        attach_rule_t = torch.log_softmax(
            self.attach_scorer(h_parent, h_child, tokens_last=True), -1)
        if not cfg.extended_valence:
            attach_rule_t = torch.cat(
                [attach_rule_t[:, :, :, :1], attach_rule_t[:, :, :, :1]], 3)
        idx = token[:, None, None, None, :].expand(b, n, 2, 2, n)
        attach_prob = torch.gather(attach_rule_t, -1, idx).permute(0, 1, 4, 2, 3)
        ones = torch.ones(n, n, device=token.device)
        left_mask = torch.tril(ones, -1)[None, :, :, None]
        right_mask = torch.triu(ones, 1)[None, :, :, None]
        attach_prob = (attach_prob[..., LEFT, :] * left_mask
                       + attach_prob[..., RIGHT, :] * right_mask)
        if cfg.function_mask and self.function_mask_ids.numel():
            bad = torch.isin(inputs["tag"], self.function_mask_ids)
            attach_prob = torch.where(bad[:, :, None, None], NEGINF, attach_prob)
        out["attach"] = attach_prob

        dec_prob = torch.log_softmax(
            self.dec_scorer(h_parent, h_dec, tokens_last=True), -1)
        out["dec"] = dec_prob

        root_prob = torch.log_softmax(
            self.root_scorer(h_root, h_child).sum((-1, -2)), -1)[:, 0]
        root_prob = root_prob.expand(b, root_prob.shape[-1])
        out["root"] = torch.gather(root_prob, 1, token)

        out["merged_dec"], out["merged_attach"] = dmv_merge(
            out["dec"], out["attach"], out["root"])
        return out


def loss_nll(scores, lengths, viterbi: bool):
    """-(max or marginal) log-likelihood; zero-length rows are masked.

    With ``scores['dep_reuse']`` (the language factors' DP passes on
    detached copies of the same potentials) the loss is a straight-through
    linearisation: the value is the reused total, the gradient with respect
    to the potentials the reused tables, so no third DP runs. Without it
    (the stand-alone model) a DP of its own runs: the value-only inside pass
    when no gradient is wanted (the eval step), else the pair of
    :class:`~vlgae_tpu_torch.struct.DMVTotalFn`."""
    md, ma = scores["merged_dec"], scores["merged_attach"]
    reuse = (scores.get("dep_reuse") or {}).get("max" if viterbi else "log")
    if reuse is not None:
        per, gd, ga = reuse
        # (x - x.detach()) is exactly 0; it routes d loss/d x = the tables
        lin = (((md - md.detach()) * gd).sum(tuple(range(1, md.dim())))
               + ((ma - ma.detach()) * ga).sum(tuple(range(1, ma.dim()))))
        total = per.detach() + lin
    else:
        dist = DMV1o((md, ma), lengths)
        total = dist.max if viterbi else dist.partition
    nll = -torch.where(lengths > 0, total, 0.0).sum()
    return nll, {"nll": nll}


def loss_init_rules(scores, gold):
    """Count-matching warm-up loss of ``init_method='y'``: the scores
    against the per-sentence rule-count targets of ``generate_rule_1o``."""
    enll = (-(gold["dec_rule"] * scores["dec"]).sum()
            - (gold["attach_rule"] * scores["attach"]).sum()
            - (gold["root_rule"] * scores["root"]).sum())
    return enll, {"enll": enll}


def loss_init_pretrained(scores, dmv_scores, lengths):
    """Warm-up loss against a frozen DMV's expected counts: the scores'
    merged tables weighted by the log-semiring marginals of
    ``dmv_scores``'s merged tables (one fused DP pass, no gradient to the
    frozen DMV). No recipe calls it yet, as in vlgae_tpu."""
    _, gd, ga = dmv_value_and_grads(dmv_scores["merged_dec"].detach(),
                                    dmv_scores["merged_attach"].detach(), lengths, "log")
    enll = (-(gd * scores["merged_dec"]).sum()
            - (ga * scores["merged_attach"]).sum())
    return enll, {"enll": enll}


def decode(scores, lengths, mbr: bool):
    """Tree decode: heads ``[B, L]``.

    ``mbr``: the projective tree of the largest summed arc marginal (the
    Eisner CRF's argmax over the marginals); otherwise the Viterbi tree.
    ``scores['dep_reuse']`` (the joint model's DP passes on the same
    potentials) supplies the marginals or the Viterbi indicators without a
    DP pass of their own."""
    reuse = scores.get("dep_reuse") or {}
    if mbr:
        r = reuse.get("log")
        if r is not None:
            arc = r[2].sum(-1)
        else:
            arc = DMV1o((scores["merged_dec"].detach(), scores["merged_attach"].detach()),
                        lengths).marginals.sum(-1)
        return DependencyCRF(arc, lengths).argmax_heads
    r = reuse.get("max")
    if r is None:
        return DMV1o((scores["merged_dec"], scores["merged_attach"]),
                     lengths).argmax_heads
    ind = r[2].sum(-1)  # [B, N1, N1] arc indicators
    return torch.argmax(ind[:, :, 1:], dim=1)
