"""The family of ``exp=vlgae`` with granite-4.0-h in BERT's place
(``vlgae-granite4hsmall``): the same joint model downstream of the word
features, the caption subwords through a frozen Mamba2 + GQA + routed-MoE
stack (``reference/granite_hybrid.py``) whose MoE layers hold a slice of
the experts (kernel K7).

It reaches the frozen pieces it shares with ``vlgae`` without changing
them: the corpus (``core/corpus.py``, ``write_bert_dir`` writing the
configuration's granite ``config.json`` beside the WordPiece vocabulary),
the reference's inputs (``reference/inputs.py``), the downstream pieces of
``reference/model.py`` and ``reference/dmv.py``, the clip and Adam of
``reference/train.py``, the count of ``flops/model.py`` and the K1, K5 and
K6 entries of ``families/vlgae.py``. ``reference/model.py::forward`` calls
BERT by name, so :func:`forward` here is its copy with this encoder in
BERT's place.

**Routing ties.** Top-k routing is a discrete choice: the program's and the
reference's roundings flip a few near-tied choices a batch, and a flip
moves a position's state by a few percent. So :func:`program_extra` runs
the port's frozen encoder on the first batch (its weights unchanged since
the first step) and keeps its choices and logits in this module
(``HANDED``): ``harness.main`` calls it before ``reference_train``, which
calls :func:`first_steps`, which takes the handover and clears it. On that
batch the reference routes on its own f32 logits and, at a (layer,
position) where the program's set differs,
takes the program's set only where every expert of the two sets' symmetric
difference scores within :data:`TAU` of the reference's k-th logit
(:func:`follow_ties`; a tie), else keeps its own (a misroute, which
``route_sel`` reads as at least 1/71). Later batches route on the
reference's own scores; their near ties (positions whose k-th and
(k+1)-th logits lie within ``TAU``) are counted. Where nothing was handed
over (``harness.control_readings``) the reference routes on its own
throughout. The counts go to standard error as one ``granite routing``
line.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..core import corpus
from ..core.record import Kernel
from ..flops import granite as count
from ..reference import dmv, inputs, model
from ..reference import granite_hybrid as enc
from ..reference.train import BETAS, CLIP, EPS, lr_at
from . import vlgae

PREFIX = model.BERT  # the encoder sits where BERT sits: transformer.bert.
# Keys of a configuration file that are the harness's, not the model's
HARNESS_KEYS = ("recipe", "family", "about", "source", "overrides", "vision", "widths",
                "precision", "max_len_train", "batch_size", "corpus_images", "reduced",
                "assumed", "deployment")
# The tie margin: 1.5 times the largest gap between the program's and the
# reference's router logits at one (layer, position), 0.0664, that eight
# sound seeds showed with every choice followed (PERF.md, the cell's limits)
TAU = 0.1
# A_log 0 (A = -1 on every head) and dt_bias -4 (softplus(-4 + N(0, 1.28))
# spans dt of about 0.001 to 0.1, the published init's range)
A_LOG, DT_BIAS = 0.0, -4.0
HANDED: dict = {}
PREC = enc.Prec()  # the reference's precision; only low_precision_control lowers it


def granite(c: dict) -> dict:
    """The model's keys of configuration ``c`` (its ``config.json``)."""
    return {k: v for k, v in c.items() if k not in HARNESS_KEYS}


def param_shapes(c: dict, n_tag: int) -> dict:
    """The downstream weights of ``reference/model.py`` (built on a stub of
    BERT of the encoder's width and no layers, whose tables are dropped) and
    the encoder's under ``PREFIX``."""
    H = c["hidden_size"]
    stub = dict(c, bert={"hidden_size": H, "intermediate_size": 1, "num_hidden_layers": 0,
                         "vocab_size": 1, "max_position_embeddings": 1, "type_vocab_size": 1})
    s = {k: v for k, v in model.param_shapes(stub, n_tag).items() if not k.startswith(PREFIX)}
    return s | enc.param_shapes(granite(c), PREFIX)


def weight_rule(name: str, shape: tuple):
    """Encoder leaves: norm scales and ``D`` 1, ``A_log`` :data:`A_LOG`,
    ``dt_bias`` :data:`DT_BIAS`, the conv's bias 0 and taps N(0, 1/width),
    every other matrix (embedding, projections, router, experts) N(0,
    0.02); the rest by ``vlgae``'s rule."""
    if not name.startswith(PREFIX):
        return vlgae.weight_rule(name, shape)
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("norm.weight") or leaf == "D":
        return "one", 1.0
    if leaf == "A_log":
        return "zero", A_LOG
    if leaf == "dt_bias":
        return "one", DT_BIAS
    if leaf == "bias":
        return "zero", 0.0
    if name.endswith("conv1d.weight"):
        return "normal", shape[-1] ** -0.5
    return "normal", 0.02


def write_inputs(c: dict, traffic: dict, seed: int, workdir: str) -> None:
    """The corpus under ``workdir/vlparse`` and the granite directory
    (``config.json`` of the configuration's model keys, WordPiece
    ``vocab.txt``) under ``workdir/granite``."""
    root = os.path.join(workdir, "vlparse")
    corpus.make_corpus(root, seed, traffic["images"], traffic["length"],
                       int(c["max_len_train"]), c["vision"])
    corpus.write_bert_dir(os.path.join(workdir, "granite"), corpus.corpus_words(root),
                          granite(c))


def overrides(c: dict, workdir: str) -> list:
    root = os.path.join(workdir, "vlparse")
    return [c["recipe"], f"root={workdir}",
            f"datamodule.train_path={root}/train",
            f"datamodule.train_init_path={root}/init",
            f"datamodule.dev_path={root}/val",
            f"datamodule.test_path={root}/test",
            f"datamodule.sg_path={root}/vlparse.json",
            f"embedding.transformer.args.model={os.path.join(workdir, 'granite')}",
            *c["overrides"]]


def reference_inputs(c: dict, workdir: str, split: str):
    return inputs.Corpus(os.path.join(workdir, "vlparse"), os.path.join(workdir, "granite"),
                         split, c["vision"])


step_sizes = vlgae.step_sizes


def widths(c: dict, n_tag: int) -> dict:
    g = granite(c)
    return dict(c["widths"], bert={"hidden_size": g["hidden_size"], "num_hidden_layers": 0,
                                   "intermediate_size": 0},
                granite=g, n_token=n_tag)


def step_ops(w: dict, steps: list, launches: dict, train: bool) -> list:
    """Each step's operations: ``vlgae``'s count without BERT, plus the
    encoder's on the step's real subwords and K7's pairs of the step's
    launches (one a MoE layer)."""
    base = vlgae.step_ops(w, steps, launches, train)
    per = len(launches["k7"]) // max(1, len(steps))
    out = []
    for i, (ops, rec) in enumerate(zip(base, steps)):
        g = count.encoder_ops(w["granite"], rec["subword_len"],
                              launches["k7"][i * per:(i + 1) * per])
        out.append({k: ops.get(k, 0) + g.get(k, 0) for k in set(ops) | set(g)})
    return out


def _k7_take(x, sel, gates, e0, e1, mask, w_in, w_out):
    return sel.detach(), mask.detach(), int(e0), int(e1), int(x.shape[1]), int(w_out.shape[-1])


def _k7_bound(kept):
    sel, mask, e0, e1, H, inter = kept
    held = (sel >= e0) & (sel < e1) & mask[:, None]
    live = {"pairs": int(held.sum()), "experts": int(torch.unique(sel[held]).numel()),
            "rows": int(held.any(1).sum()), "live": int(mask.sum()), "k": int(sel.shape[1])}
    return count.k7_bound(H, inter, **live), live["pairs"]


KERNELS = vlgae.KERNELS + [
    Kernel("k7", "vlgae_tpu_torch.ops.moe", "moe_experts", _k7_take, _k7_bound)]


# -- routing ties --------------------------------------------------------------

def follow_ties(logits, own, program, tau: float):
    """``(sel, ties)``: per row the program's set where it differs from the
    reference's own top-k only by experts scoring within ``tau`` of the
    reference's k-th logit, else the reference's own; the rows taken."""
    kth = logits.gather(1, own).min(1).values
    own_m = torch.zeros_like(logits, dtype=torch.bool).scatter(1, own, True)
    prog_m = torch.zeros_like(own_m).scatter(1, program, True)
    differ = own_m != prog_m
    near = (logits - kth[:, None]).abs() <= tau
    tie = differ.any(1) & (~differ | near).all(1)
    return torch.where(tie[:, None], program, own), int(tie.sum())


def near_ties(logits, k: int, tau: float) -> int:
    """Rows whose k-th and (k+1)-th logits lie within ``tau``."""
    top = logits.topk(k + 1, -1).values
    return int((top[:, k - 1] - top[:, k] < tau).sum())


class Routing:
    """The reference's choices for one batch: with the program's handed-over
    choices (batch 0) by :func:`follow_ties`, else its own; counting ties,
    near ties and the largest logit gap to the program's."""

    def __init__(self, live, handed=None):
        self.live, self.handed = live, handed
        self.ties = self.near = 0
        self.gaps = []  # a layer's largest gap between the program's and these logits

    def __call__(self, layer, logits, own):
        lg = logits[self.live]
        k = own.shape[1]
        self.near += near_ties(lg, k, TAU)
        if self.handed is None:
            return own
        prog = self.handed["sel"][layer].to(own.device)
        self.gaps.append(float((lg - self.handed["logits"][layer].to(lg.device)).abs().max()))
        sel = own.clone()
        sel[self.live], n = follow_ties(lg, own[self.live], prog, TAU)
        self.ties += n
        return sel


def program_extra(pipe, batch) -> dict:
    """The port's frozen encoder on the first batch: ``encoder_out`` (the
    last normed state at the real subwords, f32) and ``route_sel`` (each
    real subword's sorted choices a layer); the choices and logits are kept
    in ``HANDED`` for :func:`first_steps`."""
    encoder = pipe.model.dependency.embedding.transformer.bert
    dev = next(encoder.parameters()).device
    sub = torch.as_tensor(np.asarray(batch["subword"])).to(dev).long()
    mask = torch.as_tensor(np.asarray(batch["subword_mask"])).to(dev).bool()
    routes = []
    with torch.no_grad():
        out = encoder(sub, mask, routes)[-1]
    live = mask.reshape(-1)
    sel = [s[live].sort(-1).values.cpu() for s, _ in routes]
    HANDED.clear()
    HANDED.update(sel=sel, logits=[lg[live].float().cpu() for _, lg in routes])
    return {"encoder_gap": out[mask].float().cpu().numpy(),
            "route_sel": torch.stack(sel).numpy()}


# -- the reference's first steps ----------------------------------------------

def forward(W, c, x, tag_names, drop, route=None):
    """``reference/model.py::forward`` with the granite encoder in BERT's
    place; also returns the encoder's last state and choices."""
    seq_len = x["seq_len"].long()
    token = x["token"].long()
    B, L = token.shape
    mask = torch.arange(L, device=token.device)[None] < seq_len[:, None]
    vis, vis_mask, split = model.vis_factors(W, c, x)
    tag_emb = W[model.TAG][x["tag"].long()]
    sub, sub_mask = x["subword"].long(), x["subword_mask"].bool()
    with torch.no_grad():
        hs, routes = enc.encoder(W, PREFIX, granite(c), sub, sub_mask, PREC, route)
    first, last = x["subword_first"].long(), x["subword_last"].long()
    pos = torch.arange(sub.shape[1], device=sub.device)
    span = ((pos[None, None] >= first[..., None]) & (pos[None, None] <= last[..., None])).float()
    words = (span @ hs) / torch.clamp_min(last - first + 1, 1).float()[..., None]
    emb = torch.cat([tag_emb, words], -1)
    enc_ = model.dense(W, "dependency.encoder.linear", emb)
    enc_ = drop(enc_, enc_.shape, model.P_FF)
    proj = F.linear(vis, W["vis_mlp_pre_matching.weight"])
    word = model.mlp(W, "word_encoder", model.root_prepended(enc_, mask, seq_len), drop,
                     act=False)
    logits = torch.einsum("bvd,bqd->bqv", proj, word[:, 1:])
    P = split[0]
    ti, tj = torch.triu_indices(P, P, 0, device=vis.device)
    mult = torch.cat([torch.zeros(P, device=vis.device), (ti != tj).float() * math.log(2.0),
                      torch.zeros(split[2] + split[3], device=vis.device)])
    logits = logits + mult
    aug = torch.einsum("bqv,bvh->bqh", torch.softmax(logits, 2), vis)
    enc_ = model.layer_norm(W, "feat_layernorm", enc_ + aug, 1e-6)
    md, ma = model.parser_scores(W, emb, enc_, mask, token, drop)
    q_mask = torch.cat([torch.zeros_like(mask[:, :1]), mask], 1)
    _, _, g_log = dmv.value_and_grads(md, ma, seq_len, "log")
    xr = model.root_prepended(enc_, mask, seq_len)
    word_repr = model.mlp(W, "word_encoder", xr, drop, act=False)
    child_repr = model.mlp(W, "child_encoder", xr, drop)
    _, _, g_max = dmv.value_and_grads(md, ma, seq_len, "max")
    ind = g_max.sum(-1)
    best_heads = torch.argmax(ind[:, :, 1:], dim=1)
    heads = torch.cat([torch.zeros_like(seq_len[:, None]), best_heads], 1)
    margin = torch.gather(g_log.sum(-1), 2, heads[..., None])[..., 0]
    txt_marginal = torch.cat([q_mask.float(), margin], 1)
    parent = torch.gather(xr, 1, heads[..., None].expand(-1, -1, xr.shape[-1]))
    parent_repr = model.mlp(W, "parent_encoder", parent, drop)
    arc = (torch.einsum("bcx,xhy,bcy->bch", child_repr, W["arc_encoder_w1"], parent_repr)
           + (child_repr + parent_repr) @ W["arc_encoder_w2"] + W["arc_encoder_b"])
    txt = torch.cat([word_repr, arc], 1)
    txt_mask = torch.cat([q_mask, q_mask], 1)
    pos_ids = {k: torch.tensor([i for i, t in enumerate(tag_names) if t in s], device=token.device)
               for k, s in (("obj", model.OBJ_POS), ("rel", model.REL_POS),
                            ("attr", model.ATTR_POS))}
    tied = ((ind % 1) != 0).flatten(1).any(1)
    return {"md": md, "ma": ma, "seq_len": seq_len, "tied": tied,
            "vis": proj, "vis_mask": vis_mask, "split": split, "txt": txt,
            "txt_mask": txt_mask, "txt_marginal": txt_marginal, "pos_ids": pos_ids,
            "tag": x["tag"].long(), "encoder_out": hs[sub_mask], "routes": routes}


def first_steps(W0, c, batches, tag_names, seed, alpha):
    """``reference/train.py::first_steps`` on :func:`forward`, the frozen
    encoder's leaves not copied; ``extra``: batch 0's encoder output
    (``encoder_gap``) and final choices (``route_sel``); ``routes``: batch
    0's choices and logits, as :func:`program_extra` hands the program's
    over. Prints the routing counts to standard error."""
    dev = next(iter(W0.values())).device
    W = {k: (v if model.frozen(k) else v.detach().clone()) for k, v in W0.items()}
    names = [k for k in sorted(W) if not model.frozen(k)]
    for k in names:
        W[k].requires_grad_(True)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
    m = {k: torch.zeros_like(W[k]) for k in names}
    v = {k: torch.zeros_like(W[k]) for k in names}
    out = {"loss": [], "grad": {}, "change": {}, "tied": []}
    stats = {"ties": [], "near_ties": [], "logit_gap": None, "tau": TAU}
    handed = dict(HANDED) or None  # consumed here: a later run without a handover routes alone
    HANDED.clear()
    for step, x in enumerate(batches):
        live = x["subword_mask"].bool().reshape(-1)
        route = Routing(live, handed if step == 0 else None)
        o = forward(W, c, x, tag_names, model.Drops(gen), route)
        if step == 0:
            out["extra"] = {
                "encoder_gap": o["encoder_out"].float().cpu().numpy(),
                "route_sel": torch.stack([s[live].sort(-1).values
                                          for _, s in o["routes"]]).cpu().numpy()}
            stats["logit_gap"] = route.gaps if route.handed else None
            out["routes"] = {"sel": [s[live].sort(-1).values.cpu() for _, s in o["routes"]],
                             "logits": [lg[live].cpu() for lg, _ in o["routes"]]}
        stats["ties"].append(route.ties)
        stats["near_ties"].append(route.near)
        L = model.loss(o, x, alpha)
        grads = torch.autograd.grad(L, [W[k] for k in names], allow_unused=True)
        grads = [torch.zeros_like(W[k]) if g is None else g for k, g in zip(names, grads)]
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        scale = torch.where(norm < CLIP, torch.ones_like(norm), CLIP / norm)
        grads = [g * scale for g in grads]
        out["loss"].append(float(L.detach()))
        out["tied"].append(int(o["tied"].sum()))
        if step == 0:
            out["grad"] = {k: float(g.norm()) for k, g in zip(names, grads)}
        t = step + 1
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (v[k].sqrt() / (1 - BETAS[1] ** t) ** 0.5).add_(EPS)
                W[k].addcdiv_(m[k], denom, value=-lr_at(step) / (1 - BETAS[0] ** t))
        del o, L, grads
    out["change"] = {k: float((W[k].detach() - W0[k]).norm()) for k in names}
    print("granite routing: " + json.dumps(stats), file=sys.stderr)
    return out


def low_precision_control(cell_name: str, seed: int) -> dict:
    """The control below the configuration's precision, at the cell's size
    on the card: the reference with bf16 product outputs, a bf16 residual
    stream and the router on bf16 operands in the program's place (its
    first batch's choices handed over as the program's are), against the
    reference as configured, on the rows of the cell's first three
    batches."""
    import gc
    import tempfile

    from ..core import compare, harness, manifest, program

    global PREC
    cell = manifest.cell(manifest.load(), cell_name)
    c = cell["config"]
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        write_inputs(c, cell["traffic"], seed, tmp)
        pipe = program.build(c, seed, tmp)
        it = program.epochs(pipe, cell["traffic"]["split"])
        first = {"batches": [], "real": []}
        for _ in range(3):
            x, _, real = program.next_batch(it, program.nospan)
            first["batches"].append(program.host_copy(x))
            first["real"].append(real)
        del pipe, it
        gc.collect()
        torch.cuda.empty_cache()
        HANDED.clear()
        PREC = enc.Prec(low=True)
        try:
            low = harness.reference_train(torch, cell, seed, first, tmp)
        finally:
            PREC = enc.Prec()
        HANDED.update(low["routes"])
        ref = harness.reference_train(torch, cell, seed, first, tmp)
        return compare.train_readings(low, ref)
