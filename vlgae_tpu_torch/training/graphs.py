"""The joint phase's train step as CUDA graphs of its kernel-free stretches.

The step dispatches some 1,500 small operations from Python, and the card
waits on the host for most of it. Here every stretch of plain PyTorch
between two hand-written kernels is captured once per shape key into a CUDA
graph and replayed; the kernels stay eager calls of their Python entry
points, on the step's own tensors, between the replays (their launch
counters and the arguments a caller records stay those of each step)::

    the frozen embedding items (BERT; the granite stage with K7)    eager
    S1 potentials: visual heads, text side, fusion, parser, merge   graph
    K1 twice (log, max) on the merged potentials                    eager
    S2 factors: vis_feat, the word/child/parent/arc encoders and
       K5's operands                                                graph
    K5 (MatchMaxesFn)                                               eager
    S3 loss: factor CE, the NLL from K1's tables, interpolation,
       reduction                                                    graph
    backward: S3; K6 (MatchMaxesFn.backward); S2; S1                graphs, K6 eager
    optimizer: clip, Adam at device learning rates, gradients
       zeroed                                                       graph

Each stretch is a :class:`Segment` of named tensors; its backward is
``torch.autograd.grad`` from its outputs' cotangents to its inputs, the
parameters' shares added into their ``.grad``, whose storage stays put.
The chain gives the gradients of the eager step's ``loss.backward()``
bit for bit (each tensor's cotangents arrive in the same order).

A batch of a new key (:func:`graph_key`: everything the stretches' Python
reads) runs the chain eagerly, and that step is the warm-up; then the key's
six graphs are captured, and its later batches replay them. Every key's
graphs share one memory pool in capture order: a step replays one key's
graphs in capture order, and what must outlive a step (parameters,
gradients, Adam's state, the graphs' input slots) is allocated outside
the pool. The pipeline's dropout generator is registered with every graph,
so a replay draws what the eager step would (capture draws nothing).
Tensors handed to a kernel or returned to the caller are the step's own,
not a slot a later replay overwrites.

:func:`graphs_apply` says where the graphed step applies; everything else
keeps the eager step. On the CPU the chain runs eagerly, without capture.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Dict

import torch

from ..models.embedding import CompositeEmbedding
from ..ops.match import match_maxes_sharded
from ..utils import trace
from ..utils.trace import span

Tensors = Dict[str, torch.Tensor]


def graphs_apply(pipe) -> bool:
    """Whether ``pipe``'s joint-phase step runs as :class:`StepGraphs`: the
    joint model on the card in a single process (no ``torch.distributed``
    group: data and model world 1, no FSDP), max-tree language factors,
    bf16 matching (K5/K6) with the factor-CE grounding, one update a batch,
    Adam without weight decay, and frozen embedding encoders that draw
    nothing. Decided from the configuration and the world alone."""
    if not pipe.is_joint or pipe.device.type != "cuda" or pipe.world.group is not None:
        return False
    cfg = pipe.model.cfg
    trainer = pipe.cfg.get("trainer") or {}
    opt = pipe.optimizer
    emb = pipe.dep.embedding
    return (cfg.language_factor_mode == "word+maxdep" and cfg.bf16_matmul
            and cfg.gather_logit_mode == "simple" and cfg.loss_grounding_mode == "factor|ce"
            and int(trainer.get("accumulate_grad_batches", 1) or 1) == 1
            and isinstance(opt.opt, torch.optim.Adam)
            and all(g["weight_decay"] == 0 for g in opt.opt.param_groups)
            and all(getattr(emb, item.name).frozen for item in emb.items
                    if item.kind == "transformer"))


def graph_key(inputs: Tensors, frozen: Tensors, init_phase: bool, alpha: float) -> tuple:
    """The shape key of a batch: its padded size ``B``, ``pad_len``, the
    box count, the phase, the grounding coefficient, and the shape and type
    of every tensor the graphs take (all set by the first three)."""
    B, L = inputs["token"].shape
    P = inputs["vis_box_mask"].shape[1]
    slots = sorted(_slotted(inputs, frozen).items())
    return (B, L, P, bool(init_phase), float(alpha),
            tuple((k, tuple(v.shape), v.dtype) for k, v in slots))


def _slotted(inputs: Tensors, frozen: Tensors) -> Tensors:
    """What S1 reads: the batch (without the frozen items' subword fields,
    which only those items read) and the frozen items' words."""
    skip = CompositeEmbedding.SUBWORD_FIELDS if frozen else ()
    out = {"in." + k: v for k, v in inputs.items() if k not in skip and torch.is_tensor(v)}
    out.update({"frozen." + k: v for k, v in frozen.items()})
    return out


@contextlib.contextmanager
def _capturing():
    """The span ``vlgae.graph.capture``, with no garbage collected inside:
    a CUDA graph freed meanwhile (one that some dropped object held) would
    end the capture, so the garbage goes first."""
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        with span("vlgae.graph.capture"):
            yield
    finally:
        if was:
            gc.enable()


def _leaf(v):
    """A segment's input: a detached alias, a leaf requiring grad where the
    value did."""
    if not torch.is_tensor(v):
        return v
    return v.detach().requires_grad_(v.requires_grad)


def _slot(v):
    """A replay's input slot shaped as ``v`` (its ``requires_grad`` kept)."""
    return torch.empty_like(v).requires_grad_(v.requires_grad)


def _fill(slots: Tensors, values: Tensors) -> None:
    """Copy into each slot the step's tensor, unless it is the slot itself
    (an earlier graph's output)."""
    with torch.no_grad():
        for k, slot in slots.items():
            v = values[k]
            if v.data_ptr() != slot.data_ptr():
                slot.copy_(v)


class Segment:
    """One kernel-free stretch ``fn(dict of named tensors) -> dict``: run
    eagerly under autograd (:meth:`forward`, :meth:`backward`) or, once
    captured (:meth:`capture_forward`, :meth:`capture_backward`),
    replayed; a replay first copies the step's tensors into the input
    slots. The backward adds the parameters' shares into ``grads`` (one
    for each of ``params``) and returns the inputs' cotangents."""

    def __init__(self, fn, params, grads):
        self.fn, self.params, self.grads = fn, params, grads
        self.fwd = self.bwd = None
        self.slots = self.gslots = None
        self.ins = self.outs = self.gins = None

    def forward(self, ins: Tensors) -> Tensors:
        if self.fwd is None:
            self.ins = {k: _leaf(v) for k, v in ins.items()}
            with torch.enable_grad():
                self.outs = self.fn(self.ins)
        else:
            _fill(self.slots, ins)
            self.fwd.replay()
        return self.outs

    def backward(self, gouts: Tensors) -> Tensors:
        if self.bwd is None:
            return self._grad(gouts)
        _fill(self.gslots, gouts)
        self.bwd.replay()
        return self.gins

    def _grad(self, gouts: Tensors) -> Tensors:
        names = [k for k, g in gouts.items() if g is not None]
        diff = [k for k, v in self.ins.items() if torch.is_tensor(v) and v.requires_grad]
        got = torch.autograd.grad([self.outs[k] for k in names],
                                  [self.ins[k] for k in diff] + self.params,
                                  [gouts[k] for k in names], allow_unused=True)
        shares = [(g, r) for g, r in zip(self.grads, got[len(diff):]) if r is not None]
        if shares:
            torch._foreach_add_([g for g, _ in shares], [r for _, r in shares])
        return {k: r for k, r in zip(diff, got) if r is not None}

    def capture_forward(self, slots: Tensors, capture) -> Tensors:
        # detached: an earlier segment's captured outputs keep no graph alive
        self.slots = {k: _leaf(v) for k, v in slots.items() if torch.is_tensor(v)}
        self.fwd = capture(lambda: self.forward(self.slots))
        return self.outs

    def capture_backward(self, gslots: Tensors, capture) -> Tensors:
        self.gslots = {k: v for k, v in gslots.items() if v is not None}

        def run():
            self.gins = self._grad(self.gslots)

        self.bwd = capture(run)
        return self.gins

    def release(self) -> None:
        """Drop the autograd graph of the last eager or captured forward
        (it holds the parameters' gradient accumulators on the stream it
        ran on); keep its tensors, each ``requires_grad`` as it was."""
        def detach(d):
            return None if d is None else {k: _leaf(v) for k, v in d.items()}

        self.ins, self.outs = detach(self.ins), detach(self.outs)


class StepGraphs:
    """The joint phase's step of ``pipe`` through :class:`Segment` s:
    :meth:`grad_step` (forward and backward into the parameters'
    ``.grad``), :meth:`apply_step` (clip, Adam, gradients zeroed). On the
    card each key's stretches are captured after its first, eager, step,
    and the optimizer after the first update. Counters: ``graph.capture``
    (keys captured), ``graph.replay`` and ``graph.eager`` (steps replayed,
    steps run eagerly); a capture runs in the span ``vlgae.graph.capture``."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.model = pipe.model
        opt = pipe.optimizer
        opt.on_device()
        self.params = list(opt.params)
        # gradients at fixed addresses: the graphs add into them, Adam's
        # graph reads and zeroes them
        self.grads = [torch.zeros_like(p) for p in self.params]
        self.one = torch.ones((), device=pipe.device)
        self.keys: Dict[tuple, dict] = {}
        self.opt_graph = None
        # the visual factor groups' widths: S2 sets them, S3 reads them
        self.split = None
        self.holds_grads = False
        self.capturing = pipe.device.type == "cuda"
        if self.capturing:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(pipe.device)

    # -- the stretches --------------------------------------------------------
    def _segments(self, alpha: float) -> dict:
        seg = lambda fn: Segment(fn, self.params, self.grads)  # noqa: E731
        return {"s1": seg(self._potentials), "s2": seg(self._factors),
                "s3": seg(lambda t: self._loss(t, alpha))}

    @staticmethod
    def _inputs(t: Tensors) -> Tensors:
        return {k[3:]: v for k, v in t.items() if k.startswith("in.")}

    def _potentials(self, t: Tensors) -> Tensors:
        """S1: the forward up to the merged potentials (``potentials``)."""
        frozen = {k[7:]: v for k, v in t.items() if k.startswith("frozen.")}
        out, encoded, vis_encoded, _ = self.model.potentials(self._inputs(t), frozen)
        res = {"merged_dec": out["merged_dec"], "merged_attach": out["merged_attach"],
               "x": encoded["x"], **{"vis." + k: v for k, v in vis_encoded.items()}}
        for k in ("kl", "emb_kl"):
            if out.get(k) is not None:
                res[k] = out[k]
        return res

    def _factors(self, t: Tensors) -> Tensors:
        """S2: the grounding's factors from K1's tables, and K5's operands."""
        model = self.model
        inputs = self._inputs(t)
        token = inputs["token"]
        mask = (torch.arange(token.shape[1], device=token.device)[None, :]
                < inputs["seq_len"][:, None])
        vis_encoded = {k[4:]: v for k, v in t.items() if k.startswith("vis.")}
        tables = tuple(tuple(t[f"{kind}.{i}"] for i in range(3)) for kind in ("log", "max"))
        vis, txt, _ = model.factors(inputs, {"x": t["x"]}, vis_encoded, mask, tables)
        operands, maps = model.match_operands(vis, txt)
        assert maps is None, "training keeps the relation group compact"
        self.split = vis[2]
        return {"vis": vis[0], "vis_mask": vis[1], "txt": txt[0], "txt_mask": txt[1],
                "txt_marginal": txt[2], **dict(zip(("k5.vis", "k5.txt", "k5.vis_bias",
                                                    "k5.txt_bias"), operands))}

    def _loss(self, t: Tensors, alpha: float) -> Tensors:
        """S3: the objective (``Pipeline.loss_terms``) from the stretches'
        and the kernels' outputs."""
        tables = {kind: tuple(t[f"{kind}.{i}"] for i in range(3)) for kind in ("log", "max")}
        out = {"merged_dec": t["merged_dec"], "merged_attach": t["merged_attach"],
               "kl": t.get("kl"), "emb_kl": t.get("emb_kl"), "dep_reuse": tables,
               "vis_packed": (t["vis"], t["vis_mask"], self.split),
               "txt_packed": (t["txt"], t["txt_mask"], t["txt_marginal"]),
               "match_reduced": (t["logit"], t["logit_v"])}
        total, aux = self.pipe.loss_terms(out, self._inputs(t), alpha)
        return {"loss": total, **{"term." + k: v for k, v in aux.items()}}

    # -- one step ---------------------------------------------------------------
    def _run(self, inputs: Tensors, alpha: float):
        """The forward and backward of one step: the frozen items, then the
        key's graphs replayed if it is captured, else the stretches eagerly
        (fresh segments), the kernels eager between them. Returns ``(key,
        segments, replayed, loss, terms, what a capture shapes its slots
        from)``, the loss and terms the step's own tensors."""
        model = self.model
        with span("vlgae.forward"):
            with span("vlgae.forward.text"):
                frozen = model.dependency.embedding.frozen(inputs)
            key = graph_key(inputs, frozen, False, alpha)
            segs = self.keys.get(key)
            replay = segs is not None
            if not replay:
                segs = self._segments(alpha)
            s1, s2, s3 = segs["s1"], segs["s2"], segs["s3"]
            # a kernel's arguments may be kept by a caller (a recorder of
            # launches): the step's own tensors, never a slot that the
            # next replay overwrites
            own = ((lambda t: t.detach().clone()) if replay  # noqa: E731
                   else (lambda t: t.detach()))
            o1 = s1.forward(_slotted(inputs, frozen))
            ins = {k: v for k, v in (s1.slots if replay else s1.ins).items()
                   if k.startswith("in.")}
            with span("vlgae.forward.grounding"):
                log, mx = model.arc_tables(inputs, {k: own(o1[k]) for k in (
                    "merged_dec", "merged_attach")})
                k1 = {f"{kind}.{i}": v for kind, tab in (("log", log), ("max", mx))
                      for i, v in enumerate(tab)}
                o2 = s2.forward(self._s2_ins(ins, o1, k1))
                vis_k, txt_k = (own(o2[k]).requires_grad_() for k in ("k5.vis", "k5.txt"))
                logit, _, logit_v, _ = match_maxes_sharded(
                    vis_k, txt_k, own(o2["k5.vis_bias"]), own(o2["k5.txt_bias"]),
                    model.data_group)
        with span("vlgae.loss"):
            o3 = s3.forward(self._s3_ins(ins, o1, k1, o2, {"logit": logit,
                                                           "logit_v": logit_v}))
            res = {k: v.detach() for k, v in o3.items()}
            if replay:  # the caller keeps them past the next replay
                res = dict(zip(res, torch.stack(list(res.values())).unbind()))
        with span("vlgae.backward"):
            g3 = s3.backward({"loss": self.one})
            dvis, dtxt = torch.autograd.grad((logit, logit_v), (vis_k, txt_k),
                                             (own(g3["logit"]), own(g3["logit_v"])))
            g2 = s2.backward({"k5.vis": dvis, "k5.txt": dtxt, "vis": g3.get("vis"),
                              "txt": g3.get("txt")})
            s1.backward(self._s1_gouts(o1, g3, g2))
        loss = res.pop("loss")
        terms = {k[5:]: v for k, v in res.items()}
        return key, segs, replay, loss, terms, (k1, dvis, dtxt)

    @staticmethod
    def _s2_ins(ins, o1, k1):
        return {**ins, **k1, "x": o1["x"], **{k: v for k, v in o1.items() if k.startswith("vis.")}}

    @staticmethod
    def _s3_ins(ins, o1, k1, o2, k5):
        return {**ins, **k1, **k5,
                **{k: o1[k] for k in ("merged_dec", "merged_attach", "kl", "emb_kl") if k in o1},
                **{k: o2[k] for k in ("vis", "vis_mask", "txt", "txt_mask", "txt_marginal")}}

    @staticmethod
    def _s1_gouts(o1, g3, g2):
        """S1's output cotangents: the parser's potentials (and KL terms)
        from S3, the encoding and the visual heads from S2."""
        return {k: g for gins in (g3, g2) for k, g in gins.items() if k in o1}

    def grad_step(self, inputs: Tensors, alpha: float):
        """Forward and backward of one joint-phase batch (uploaded), the
        gradients added into ``.grad``: replays where the batch's key is
        captured, else the eager chain and, on the card, the key's capture.
        Returns the loss and terms, the step's own tensors."""
        for p, g in zip(self.params, self.grads):
            if p.grad is not g:
                p.grad = g
        key, segs, replay, loss, terms, shapes = self._run(inputs, alpha)
        trace.count("graph.replay" if replay else "graph.eager")
        if not replay and self.capturing:
            for seg in segs.values():
                seg.release()
            with _capturing():
                self.keys[key] = self._capture(segs, shapes, alpha)
            trace.count("graph.capture")
        self.holds_grads = True
        return loss, terms

    def apply_step(self, step: int) -> None:
        """Clip, Adam and zeroed gradients (``Optimizer.update_on_device``)
        at update ``step``'s learning rates: eagerly the first time, then
        captured and replayed."""
        opt = self.pipe.optimizer
        opt.set_lr_on_device(step)
        if self.opt_graph is not None:
            self.opt_graph.replay()
        else:
            opt.update_on_device()
            if self.capturing:
                with _capturing():
                    self.opt_graph = self._graph(opt.update_on_device)
        self.holds_grads = False

    # -- capture --------------------------------------------------------------
    def _graph(self, fn):
        """``fn``'s device work captured into a CUDA graph of the shared
        pool on the side stream, the dropout generator registered (nothing
        runs)."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.pipe.generator)
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            # thread_local: the data module's producer thread may pin host
            # memory meanwhile
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(self.stream)
        return graph

    def _capture(self, eager: dict, shapes, alpha: float) -> dict:
        """A key's six graphs; the slots shaped as the tensors of its eager
        step: ``eager`` (its segments, released) and ``shapes`` (K1's
        results, K6's)."""
        k1, dvis, dtxt = shapes
        segs = self._segments(alpha)
        s1, s2, s3 = segs["s1"], segs["s2"], segs["s3"]
        cap = self._graph
        torch.cuda.synchronize(self.pipe.device)
        in1 = {k: _slot(v) for k, v in eager["s1"].ins.items()}
        ins = {k: v for k, v in in1.items() if k.startswith("in.")}
        k1 = {k: _slot(v) for k, v in k1.items()}
        k5 = {k: _slot(eager["s3"].ins[k]) for k in ("logit", "logit_v")}
        o1 = s1.capture_forward(in1, cap)
        o2 = s2.capture_forward(self._s2_ins(ins, o1, k1), cap)
        s3.capture_forward(self._s3_ins(ins, o1, k1, o2, k5), cap)
        g3 = s3.capture_backward({"loss": self.one}, cap)
        g2 = s2.capture_backward({"k5.vis": _slot(dvis), "k5.txt": _slot(dtxt),
                                  "vis": g3.get("vis"), "txt": g3.get("txt")}, cap)
        s1.capture_backward(self._s1_gouts(o1, g3, g2), cap)
        for seg in segs.values():
            seg.release()
        return segs
