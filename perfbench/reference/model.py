"""The joint model of ``exp=vlgae`` in plain PyTorch: its training loss,
from the recipe's equations, on a dictionary of weights by name.

Precision follows the configuration: f32 throughout (TF32 off) but for the
visual factor heads (bf16 operands and output) and the matching product
(bf16 operands, f32 sums). Dropout masks are drawn from a given generator in
the order the recipe's forward draws them, each ``bernoulli(1 - p)`` of its
shape.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import dmv

INF = 1e9
OBJ_POS = ["NN", "NNS", "PRP", "NNP", "WDT", "WP", "NNPS"]
REL_POS = ["IN", "VBZ", "VBG", "VBN", "TO", "VB", "RB", "RP", "VBD", "CC",
           "VBP", "EX", "POS", "FW", "WRB", "MD", "RBR"]
ATTR_POS = ["DT", "JJ", "CD", "PRP$", "JJR", "JJS", "PDT"]
P_FF = 0.33  # the scorer MLPs, text encoder, word / child / parent encoders
P_MID = 0.3  # the skip-connect encoder
BERT = "dependency.embedding.transformer.bert."
TAG = "dependency.embedding.tag_embedding.embedding"


def param_shapes(c: dict, n_tag: int) -> dict:
    """``{name: shape}`` of every weight of the model of config ``c``."""
    w = c["widths"]
    h, m, r, mid, td = (w[k] for k in ("hidden", "match_hidden", "rank",
                                       "mid_bottleneck", "tag_dim"))
    b = c["bert"]
    H, I = b["hidden_size"], b["intermediate_size"]
    s = {BERT + "embeddings.word_embeddings.embedding": (b["vocab_size"], H),
         BERT + "embeddings.position_embeddings.embedding": (b["max_position_embeddings"], H),
         BERT + "embeddings.token_type_embeddings.embedding": (b["type_vocab_size"], H),
         BERT + "embeddings.LayerNorm.weight": (H,), BERT + "embeddings.LayerNorm.bias": (H,)}

    def lin(name, n_out, n_in, bias=True):
        s[name + ".weight"] = (n_out, n_in)
        if bias:
            s[name + ".bias"] = (n_out,)

    for k in range(b["num_hidden_layers"]):
        p = f"{BERT}encoder.layer.{k}."
        for q in ("query", "key", "value"):
            lin(p + "attention.self." + q, H, H)
        lin(p + "attention.output.dense", H, H)
        lin(p + "intermediate.dense", I, H)
        lin(p + "output.dense", H, I)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            s[p + ln + ".weight"] = s[p + ln + ".bias"] = (H,)
    emb = td + H
    s[TAG] = (n_tag, td)
    lin("dependency.encoder.linear", h, emb)
    lin("dependency.head_ff.linear", h, emb + h)
    lin("dependency.child_ff.linear", h, td)
    lin("dependency.root_ff.linear", h, 10)
    lin("dependency.dec_ff.linear", h, 10)
    for g in ("HASCHILD", "NOCHILD", "LEFT", "RIGHT"):
        lin(f"dependency.mid_ff.{g}.0", mid, h)
        lin(f"dependency.mid_ff.{g}.1", h, mid)
    for g in ("valence", "direction", "mid1", "mid2"):
        lin(f"dependency.mid_ff.{g}", h, h)
    for g in ("attach", "dec", "root"):
        lin(f"dependency.{g}_scorer.project1", r, h)
        lin(f"dependency.{g}_scorer.project2", r, h)
    s["dependency.root_emb"] = (1, 10)
    s["dependency.dec_emb"] = (2, 10)
    head = "vis_encoder."
    F_in = 2 * w["feat_dim"]
    s[head + "rel_fc_bias"] = (h,)
    lin(head + "rel_fc", h, F_in, bias=False)
    lin(head + "box_fc.linear", h, F_in)
    lin(head + "attr_fc.linear", h, F_in)
    lin("word_encoder.linear", m, h)
    lin("vis_mlp_pre_matching", m, h, bias=False)
    lin("child_encoder.linear", m, h)
    lin("parent_encoder.linear", m, h)
    s["arc_encoder_w1"] = (m, m, m)
    s["arc_encoder_w2"] = (m, m)
    s["arc_encoder_b"] = (m,)
    s["feat_layernorm.weight"] = s["feat_layernorm.bias"] = (h,)
    return s


def frozen(name: str) -> bool:
    """Leaves the recipe keeps out of the optimizer (the frozen BERT)."""
    return name.startswith(BERT)


class Drops:
    """Keep masks from ``gen`` in the order the forward asks for them."""

    def __init__(self, gen):
        self.gen = gen

    def __call__(self, x, shape, p):
        if p <= 0:
            return x
        keep = torch.empty(shape, dtype=x.dtype, device=x.device).bernoulli_(
            1 - p, generator=self.gen)
        return x * keep / (1 - p)


def leaky(x):
    return torch.where(x >= 0, x, x * 0.01)


def dense(W, name, x, bias=True):
    return F.linear(x, W[name + ".weight"], W[name + ".bias"] if bias else None)


def dense16(W, name, x, bias=True):
    """A dense layer on bf16 operands (and bias), its output back in f32."""
    b = W[name + ".bias"].to(torch.bfloat16) if bias else None
    return F.linear(x.to(torch.bfloat16), W[name + ".weight"].to(torch.bfloat16), b).float()


def mlp(W, name, x, drop, act=True, p=P_FF):
    """Linear, LeakyReLU, dropout shared along dim 1 (one mask a row and
    feature)."""
    y = dense(W, name + ".linear", x)
    if act:
        y = leaky(y)
    return drop(y, (y.shape[0], 1) + tuple(y.shape[2:]), p)


def layer_norm(W, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"], W[name + ".bias"], eps)


def bert(W, c, ids, mask):
    """The last hidden states of BERT [B, S, H] (post-LN layers, exact GELU;
    masked keys take the bias ``finfo(f32).min``)."""
    b = c["bert"]
    B, S = ids.shape
    H, n_h, eps = b["hidden_size"], b["num_attention_heads"], b["layer_norm_eps"]
    hd = H // n_h
    x = (W[BERT + "embeddings.word_embeddings.embedding"][ids]
         + W[BERT + "embeddings.position_embeddings.embedding"][:S][None]
         + W[BERT + "embeddings.token_type_embeddings.embedding"][0])
    x = layer_norm(W, BERT + "embeddings.LayerNorm", x, eps)
    bias = torch.where(mask[:, None, None, :], 0.0, torch.finfo(torch.float32).min)
    for k in range(b["num_hidden_layers"]):
        p = f"{BERT}encoder.layer.{k}."

        def split(t):
            return t.view(B, S, n_h, hd).transpose(1, 2)

        q = split(dense(W, p + "attention.self.query", x))
        kk = split(dense(W, p + "attention.self.key", x))
        v = split(dense(W, p + "attention.self.value", x))
        att = torch.softmax(q @ kk.transpose(-1, -2) / math.sqrt(hd) + bias, -1)
        ctx = (att @ v).transpose(1, 2).reshape(B, S, H)
        x = layer_norm(W, p + "attention.output.LayerNorm",
                       dense(W, p + "attention.output.dense", ctx) + x, eps)
        y = F.gelu(dense(W, p + "intermediate.dense", x))
        x = layer_norm(W, p + "output.LayerNorm", dense(W, p + "output.dense", y) + x, eps)
    return x


def vis_factors(W, c, x):
    """``(features [B, V, h], mask [B, V], split)``: boxes, box pairs (the
    inclusive upper triangle, as in training), attributes and the image (the
    mean box factor)."""
    feat = x["vis_box_feat"].float()
    head = "vis_encoder."
    box_mask = x["vis_box_mask"]
    B, P, _ = feat.shape
    inp = torch.cat([feat, feat.mean(1, keepdim=True).expand_as(feat)], -1)
    u = dense16(W, head + "rel_fc", inp, bias=False)
    ti, tj = torch.triu_indices(P, P, 0, device=feat.device)
    rel = (u[:, ti] + u[:, tj]) * 0.5 + W[head + "rel_fc_bias"]
    rel_mask = box_mask[:, ti] & box_mask[:, tj] & (ti != tj)[None]
    rel = leaky(rel)
    box = leaky(dense16(W, head + "box_fc.linear", inp))
    attr = leaky(dense16(W, head + "attr_fc.linear", inp))
    img = box.mean(1, keepdim=True)
    feats = torch.cat([box, rel, attr, img], 1)
    ones = torch.ones(B, 1, dtype=torch.bool, device=feat.device)
    mask = torch.cat([box_mask, rel_mask, box_mask, ones], 1)
    return feats, mask, (P, rel.shape[1], P, 1)


def root_prepended(x, mask, seq_len):
    root = (torch.where(mask[..., None], x, 0.0).sum(1)
            / torch.clamp_min(seq_len, 1)[:, None].float())[:, None]
    return torch.cat([root, x], 1)


def skip_encoder(W, x, drop):
    """The DMV skip-connect encoder: valence then direction branches,
    element-wise dropout, the mid pair."""
    p = "dependency.mid_ff."

    def bott(g, t):
        return dense(W, p + g + ".1", dense(W, p + g + ".0", t))

    h = torch.stack([bott("HASCHILD", x) + x, bott("NOCHILD", x) + x], -2)
    h = leaky(dense(W, p + "valence", leaky(h)))
    x_ = x[..., None, :]
    h = torch.stack([bott("LEFT", h) + x_, bott("RIGHT", h) + x_], -3)
    h = leaky(dense(W, p + "direction", leaky(h)))
    h = drop(h, h.shape, P_MID)
    return dense(W, p + "mid2", leaky(dense(W, p + "mid1", h)))


def scorer(W, g, x1, x2, tokens_last):
    a = dense(W, f"dependency.{g}_scorer.project1", x1)
    b = dense(W, f"dependency.{g}_scorer.project2", x2)
    if tokens_last:
        return torch.einsum("bhdve,cdve->bhdvc", a, b[0])
    return torch.einsum("bhdve,cdve->bhcdv", a, b[0])


def parser_scores(W, emb, x, mask, token, drop):
    """The merged DMV potentials ``(dec [B, N1, 2, 2, 2], attach [B, N1,
    N1, 2])`` of the discriminative neural DMV (tokens are tags)."""
    B, L = token.shape
    denom = torch.clamp_min(mask.sum(-1, keepdim=True), 1).float()
    ctx = (torch.where(mask[..., None], x, 0.0).sum(1, keepdim=True) / denom[..., None])
    h = torch.cat([emb, ctx.expand(B, L, ctx.shape[-1])], -1)
    h_parent = skip_encoder(W, mlp(W, "dependency.head_ff", h, drop), drop)

    def table(name, t):
        y = leaky(dense(W, name + ".linear", t))
        y = drop(y, (y.shape[0], 1), P_FF)
        return skip_encoder(W, y, drop)[None]

    h_child = table("dependency.child_ff", W[TAG])
    h_root = table("dependency.root_ff", W["dependency.root_emb"])
    h_dec = table("dependency.dec_ff", W["dependency.dec_emb"])
    rule = torch.log_softmax(scorer(W, "attach", h_parent, h_child, True), -1)
    idx = token[:, None, None, None, :].expand(B, L, 2, 2, L)
    att = torch.gather(rule, -1, idx).permute(0, 1, 4, 2, 3)  # [b, head, child, dir, val]
    ones = torch.ones(L, L, device=token.device)
    att = (att[..., dmv.LEFT, :] * torch.tril(ones, -1)[None, :, :, None]
           + att[..., dmv.RIGHT, :] * torch.triu(ones, 1)[None, :, :, None])
    dec = torch.log_softmax(scorer(W, "dec", h_parent, h_dec, True), -1)
    root = torch.log_softmax(scorer(W, "root", h_root, h_child, False).sum((-1, -2)), -1)[:, 0]
    root = torch.gather(root.expand(B, root.shape[-1]), 1, token)
    return dmv.merge(dec, att, root)


def pos_penalty(tag, pos_ids, split, Q, V, scale):
    """``-scale`` on the word rows of tags in a group's prior set, for every
    factor outside that group (the image group has no prior)."""
    B, L = tag.shape
    pen = torch.zeros(B, Q, V, device=tag.device)
    v = torch.arange(V, device=tag.device)
    off = 0
    for name, width in zip(("obj", "rel", "attr", "img"), split):
        if name != "img":
            inside = torch.isin(tag, pos_ids[name])
            rows = torch.zeros(B, Q, dtype=torch.bool, device=tag.device)
            rows[:, 1:L + 1] = inside
            outside = (v < off) | (v >= off + width)
            pen = pen - scale * (rows[:, :, None] & outside[None, None, :]).float()
        off += width
    return pen


def forward(W, c, x, tag_names, drop):
    """What the training loss reads: potentials, factors, maps; the arcs
    are those of the Viterbi tree."""
    seq_len = x["seq_len"].long()
    token = x["token"].long()
    B, L = token.shape
    mask = torch.arange(L, device=token.device)[None] < seq_len[:, None]
    vis, vis_mask, split = vis_factors(W, c, x)
    tag_emb = W[TAG][x["tag"].long()]
    sub, sub_mask = x["subword"].long(), x["subword_mask"].bool()
    with torch.no_grad():
        hs = bert(W, c, sub, sub_mask)
    first, last = x["subword_first"].long(), x["subword_last"].long()
    pos = torch.arange(sub.shape[1], device=sub.device)
    span = ((pos[None, None] >= first[..., None]) & (pos[None, None] <= last[..., None])).float()
    words = (span @ hs) / torch.clamp_min(last - first + 1, 1).float()[..., None]
    emb = torch.cat([tag_emb, words], -1)
    enc = dense(W, "dependency.encoder.linear", emb)
    enc = drop(enc, enc.shape, P_FF)
    # fusion of the matched visual features into the text encoding
    proj = F.linear(vis, W["vis_mlp_pre_matching.weight"])
    word = mlp(W, "word_encoder", root_prepended(enc, mask, seq_len), drop, act=False)
    logits = torch.einsum("bvd,bqd->bqv", proj, word[:, 1:])
    P = split[0]
    ti, tj = torch.triu_indices(P, P, 0, device=vis.device)
    mult = torch.cat([torch.zeros(P, device=vis.device), (ti != tj).float() * math.log(2.0),
                      torch.zeros(split[2] + split[3], device=vis.device)])
    logits = logits + mult
    aug = torch.einsum("bqv,bvh->bqh", torch.softmax(logits, 2), vis)
    enc = layer_norm(W, "feat_layernorm", enc + aug, 1e-6)
    md, ma = parser_scores(W, emb, enc, mask, token, drop)
    # language factors: words and the arcs of the Viterbi tree
    q_mask = torch.cat([torch.zeros_like(mask[:, :1]), mask], 1)
    _, _, g_log = dmv.value_and_grads(md, ma, seq_len, "log")
    xr = root_prepended(enc, mask, seq_len)
    word_repr = mlp(W, "word_encoder", xr, drop, act=False)
    child_repr = mlp(W, "child_encoder", xr, drop)
    _, _, g_max = dmv.value_and_grads(md, ma, seq_len, "max")
    ind = g_max.sum(-1)
    best_heads = torch.argmax(ind[:, :, 1:], dim=1)
    heads = torch.cat([torch.zeros_like(seq_len[:, None]), best_heads], 1)
    # row q reads the marginal of the arc q -> head(q) (the recipe's quirk)
    margin = torch.gather(g_log.sum(-1), 2, heads[..., None])[..., 0]
    txt_marginal = torch.cat([q_mask.float(), margin], 1)
    parent = torch.gather(xr, 1, heads[..., None].expand(-1, -1, xr.shape[-1]))
    parent_repr = mlp(W, "parent_encoder", parent, drop)
    arc = (torch.einsum("bcx,xhy,bcy->bch", child_repr, W["arc_encoder_w1"], parent_repr)
           + (child_repr + parent_repr) @ W["arc_encoder_w2"] + W["arc_encoder_b"])
    txt = torch.cat([word_repr, arc], 1)
    txt_mask = torch.cat([q_mask, q_mask], 1)
    pos_ids = {k: torch.tensor([i for i, t in enumerate(tag_names) if t in s], device=token.device)
               for k, s in (("obj", OBJ_POS), ("rel", REL_POS), ("attr", ATTR_POS))}
    tied = ((ind % 1) != 0).flatten(1).any(1)  # a Viterbi tie splits the indicators
    return {"md": md, "ma": ma, "seq_len": seq_len, "tied": tied,
            "vis": proj, "vis_mask": vis_mask, "split": split, "txt": txt,
            "txt_mask": txt_mask, "txt_marginal": txt_marginal, "pos_ids": pos_ids,
            "tag": x["tag"].long()}


def match_maxes(vis, vis_mask, txt, txt_mask):
    """``(logit [B, A, Q], logit_v [B, A, V])``: the maxima of the matching
    product of every caption against every image, masked rows at -1e9, on
    bf16 operands with f32 sums."""
    vb = -INF * (1.0 - vis_mask.float())
    tb = -INF * (1.0 - txt_mask.float())
    v16 = vis.to(torch.bfloat16).float()
    t16 = txt.to(torch.bfloat16).float()
    att = torch.einsum("bqd,avd->baqv", t16, v16) + vb[None, :, None, :] + tb[:, None, :, None]
    return att.amax(-1), att.amax(-2)


def own_block(o, pen_scale):
    """The own-image ``[B, Q, V]`` block in f32, masked, with the prior."""
    att = torch.einsum("bvd,bqd->bqv", o["vis"], o["txt"])
    att = torch.where(o["vis_mask"][:, None, :], att, -INF)
    att = torch.where(o["txt_mask"][:, :, None], att, -INF)
    Q, V = att.shape[1:]
    return att + pos_penalty(o["tag"], o["pos_ids"], o["split"], Q, V, pen_scale)


def loss(o, x, alpha):
    """The joint objective per token: Viterbi NLL and the factor CE of the
    grounding, interpolated by ``alpha``."""
    seq_len = o["seq_len"]
    best = dmv.total(o["md"], o["ma"], seq_len, "max")
    nll = -torch.where(seq_len > 0, best, 0.0).sum()
    logit, logit_v = match_maxes(o["vis"], o["vis_mask"], o["txt"], o["txt_mask"])
    att = own_block(o, 100.0)
    B = logit.shape[0]
    eye = torch.eye(B, dtype=torch.bool, device=logit.device)
    logit = torch.where(eye[:, :, None], att.amax(-1)[:, None, :], logit)
    logit_v = torch.where(eye[:, :, None], att.amax(-2)[:, None, :], logit_v)
    row = seq_len > 0
    n_tok = seq_len.sum()
    logit = torch.log_softmax(torch.where(row[None, :, None], logit, -INF), 1)
    diag = torch.diagonal(logit, 0, 0, 1).T
    t2v = -(diag * o["txt_marginal"] * row[:, None]).sum()
    logit_v = torch.log_softmax(torch.where(row[:, None, None], logit_v, -INF), 0)
    diag_v = torch.diagonal(logit_v, 0, 0, 1).T
    v2t = -(diag_v * o["vis_mask"] * row[:, None]).sum()
    mt = t2v / (t2v.detach() + 1e-6) * n_tok + v2t / (v2t.detach() + 1e-6) * n_tok
    enough = ((x["vis_available"].bool() & row).sum() >= 2).float()
    mt = mt * enough * float(alpha > 0)
    total = alpha * mt + (1 - alpha) * nll
    return total / torch.clamp_min(n_tok, 1)
