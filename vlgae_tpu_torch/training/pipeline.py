"""Training and evaluation pipeline (counterpart of
vlgae_tpu/training/pipeline.py), for the joint model and for the stand-alone
parser: the train step (forward, backward, clip,
Adam) and its accumulation form, the epoch loop with the warm-up phase,
the per-epoch grounding coefficient, mid-epoch validation and device-side
loss sums, checkpoints with ``torch.save``, the eval step, metrics and the
CoNLL+ALIGN prediction writer.

Under ``torchrun`` the pipeline is one rank of a data-parallel world
(:mod:`vlgae_tpu_torch.parallel`): every rank walks the same global
batches, pads each to a power of two and a multiple of the world size,
steps on its own rows and sums the gradients; evaluation sums the metric
states and merges the predictions on every rank; only rank 0 writes
checkpoints, which hold the whole state at every world size, with FSDP or
without (the CLIs write the predictions on rank 0). With
``trainer.model_parallel = m`` the world is a ``(data, model)`` grid: the
``m`` ranks of a model group hold the same rows and a slice each of the
tensor-parallel parameters, and everything above spans the data group.

``trainer.progress_bar`` (default on) shows an ASCII ``tqdm`` bar over an
epoch's batches when ``tqdm`` imports and stderr is a terminal.
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.conll import write_conll_rows
from ..models.embedding import StaticItem, normalize_embedding_
from ..models.ldndmv import decode as ldndmv_decode
from ..models.ldndmv import loss_init_rules, loss_nll
from ..models.nn import set_batch_rows, set_dropout_generator
from ..models.text_encoder import RNNEncoder
from ..parallel.mesh import (barrier, full_shapes, full_state_dict, full_tensor,
                             gather_predictions, global_sum, init_distributed,
                             load_full_state_dict, local, pad_batch_to_devices, replicate,
                             shard_batch, shard_like, shard_params, split_mesh,
                             sum_across_processes, tensor_parallel)
from ..utils.fn import coeff_at, parse_coeff_schedule, reduce_loss
from ..utils.trace import span
from . import metrics as metrics_mod
from .graphs import StepGraphs, graphs_apply
from .optim import Optimizer


def pad_batch_pow2(batch: dict, min_b: int = 8):
    """Pad the batch axis to the next power of two (at least ``min_b``).

    Filler rows replicate row 0 with ``seq_len`` zeroed, exactly as the JAX
    package pads for its compile shapes: the fillers take part in the
    cross-image argmax of the decode, so predictions depend on them.
    Returns (batch, real_size).
    """
    return pad_batch_to_devices(batch, 1, pow2=True, min_b=min_b)


def init_params(model: torch.nn.Module, seed: int) -> None:
    """Random weights from ``seed`` (an explicit CPU generator, so the
    draw does not depend on the device): biases and mixing weights 0,
    norm scales 1, BERT and ViT tables/kernels N(0, 0.02), static embeddings
    N(0, 1) (or their pretrained table), other matrices N(0, 1/fan_in);
    an ``RNNEncoder`` by its ``init_version``."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias" or leaf.endswith("_bias") or leaf == "weights":
                p.zero_()
            elif leaf == "gamma" or (leaf == "weight" and p.dim() == 1):
                p.fill_(1.0)
            else:
                x = torch.randn(p.shape, generator=g)
                if ".bert." in f".{name}" or ".vit." in f".{name}":
                    x = x * 0.02
                elif leaf not in ("embedding", "root_emb", "dec_emb"):
                    x = x * (p.shape[-1] if p.dim() == 2 else p.shape[0]) ** -0.5
                p.copy_(x)
        for m in model.modules():
            if isinstance(m, RNNEncoder):
                m.reset_parameters(g)
            elif isinstance(m, StaticItem) and m.pretrained is not None:
                m.embedding.copy_(m.pretrained)


def _progress_bar(it, total, desc, enable=True):
    """An ASCII ``tqdm`` bar over ``it``, or ``it`` itself when disabled,
    when stderr is not a terminal or when ``tqdm`` does not import."""
    if not enable or not sys.stderr.isatty():
        return it
    try:
        from tqdm import tqdm
    except Exception:
        return it
    return tqdm(it, total=total, desc=desc, ascii=True, leave=False)


class Pipeline:
    """Owns the model, the datamodule, the optimizer, the dropout
    generator, the metrics (dev and test) and this process's place in the
    world of processes (``world``), on the data axis (``dp``) and on the
    model axis (``mp``)."""

    def __init__(self, model, dm, cfg: Dict[str, Any], device="cuda",
                 workdir: str = ".", seed: int = 0):
        from ..predict import setup_device  # (predict imports this module)

        trainer = cfg.get("trainer") or {}
        # the card unless the caller names the CPU; raises without a card.
        # Under torchrun: cuda:LOCAL_RANK (NCCL) or the CPU (gloo), the
        # world split into (data, model) by trainer.model_parallel
        self.world = init_distributed(setup_device(device))
        self.dp, self.mp, mesh = split_mesh(
            self.world, int(trainer.get("model_parallel", 1) or 1))
        self.device = self.dp.device
        self.model = model.to(self.device).eval()
        self.dm = dm
        self.cfg = cfg
        self.workdir = workdir
        # the joint model wraps the parser; ``exp=lang_only`` is the parser alone
        self.is_joint = hasattr(model, "dependency")
        if self.is_joint:
            model.data_group = self.dp
        self.dep = model.dependency if self.is_joint else model
        self.dep_cfg = self.dep.cfg
        self.loss_reduction_mode = (cfg.get("pipeline") or {}).get(
            "loss_reduction_mode", "token")
        self.metrics = [self._build_metric_node(cfg.get("metric") or {})
                        for _ in range(2)]
        interp = (cfg.get("model", {}) or {}).get("grounding_interpolation", 0.5)
        self.alpha_schedule = (parse_coeff_schedule(interp)
                               if isinstance(interp, str) else None)
        self.alpha = float(interp) if self.alpha_schedule is None else None
        # dropout masks of every module come from this device generator
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        set_dropout_generator(self.model, self.generator)
        self.optimizer: Optional[Optimizer] = None
        self.step = 0
        self.epoch = 0
        self.best = None
        self.watch_field = cfg.get("watch_field", "val/loss")
        self.watch_mode = cfg.get("watch_mode", "min")
        # per-term loss means of the latest mid-epoch training window
        self.window_train_terms: Dict[str, float] = {}
        emb = self.dep.embedding
        self._batch_normalize = any(
            item.kind == "static" and item.normalize_time == "batch"
            for item in emb.items)
        # pretrained ViT backbone weights over the random init
        vit_weights = (cfg.get("vis_encoder") or {}).get("vit_weights")
        if vit_weights:
            from ..models.vis_encoder import graft_vit_params, load_vit_params

            vis = getattr(self.model, "vis_encoder", None)
            if not hasattr(vis, "vit_config"):
                raise ValueError("vis_encoder.vit_weights is set but the model's "
                                 "vis_encoder is not a VisViTPatchEncoder")
            graft_vit_params(self.model, load_vit_params(str(vit_weights), vis.vit_config))
        # the same weights on every rank, then each model rank's slice of the
        # tensor-parallel leaves; trainer.fsdp shards the large leaves no
        # tensor-parallel rule took (a single process without a group has
        # nothing to shard them over)
        replicate(self.model, self.world)
        tensor_parallel(self.model, self.mp)
        if trainer.get("fsdp") and self.dp.group is not None:
            shard_params(self.model, self.dp, int(trainer.get("fsdp_min_size", 1 << 16)),
                         mesh)
        # seconds of each eval step of the last evaluate(): batch upload,
        # forward, loss and decode, ending when the results reach the host
        self.step_times: List[float] = []
        self.step_sizes: List[int] = []
        # wandb histograms of parameters and gradients, and a
        # torch.profiler stepped once an update (train.py sets them)
        self.watcher = None
        self.profiler = None
        # the joint phase's step as CUDA graphs (training/graphs.py): whether
        # they apply (decided at the first joint step), and the graphs
        self._graphable: Optional[bool] = None
        self.graphs = None

    def _build_metric_node(self, node):
        """Instantiate a metric from a config node (``_target_`` matched by
        class name in :mod:`.metrics`); without one the flagship default
        (attachment alone for the stand-alone parser)."""
        if not isinstance(node, dict) or "_target_" not in node:
            if not self.is_joint:
                return metrics_mod.DependencyParsingMetric()
            return metrics_mod.MultiMetric(
                metrics_mod.DependencyParsingMetric(),
                box=metrics_mod.BoxRelMatchingMetric(),
                img=metrics_mod.FactorImageMatchingMetric())
        cls = getattr(metrics_mod, str(node["_target_"]).rsplit(".", 1)[-1], None)
        if cls is None:
            raise ValueError(f"unknown metric _target_: {node['_target_']}")
        if cls is metrics_mod.MultiMetric:
            subs = {k: self._build_metric_node(v) for k, v in node.items()
                    if k != "_target_"}
            return metrics_mod.MultiMetric(subs.pop("main", None), **subs)
        return cls(**{k: v for k, v in node.items()
                      if k != "_target_" and not isinstance(v, dict)})

    # -- setup -----------------------------------------------------------------
    def setup_optimizer(self) -> Optimizer:
        """Adam over the trainable parameters; a frozen transformer item's
        BERT and a frozen ViT backbone stay out."""
        train_cfg = self.cfg.get("datamodule", {}).get("train_dataloader", {}) or {}
        n_batches = max(1, len(self.dm.datasets.get("train", [1]))
                        // max(int(train_cfg.get("batch_size", 32)), 1))
        frozen = [rf"\b{item.name}\b.*bert"
                  for item in self.dep.embedding.items
                  if item.kind == "transformer" and not item.requires_grad]
        vis = getattr(self.model, "vis_encoder", None)
        if hasattr(vis, "vit_config") and not vis.requires_grad:
            frozen.append(r"vis_encoder\.vit\b")
        self.optimizer = Optimizer(
            self.model, self.cfg.get("optimizer", {"args": {"lr": 1e-3}}),
            self.cfg.get("scheduler"), steps_per_epoch=n_batches,
            gradient_clip_val=self.cfg.get("trainer", {}).get("gradient_clip_val", 0.0),
            frozen_patterns=frozen, dp=self.dp)
        self.graphs = None  # captured on the previous optimizer's state
        return self.optimizer

    def normalize_embeddings(self, when: str) -> None:
        """Re-whiten the static embedding tables scheduled for ``when``
        (begin | epoch | batch), count-weighted where the vocab counts."""
        emb = self.dep.embedding
        for item in emb.items:
            if item.kind != "static" or item.normalize_time != when:
                continue
            vocab = getattr(self.dm, "vocabs", {}).get(item.field)
            counts = None
            if vocab is not None and getattr(vocab, "word_count", None):
                counts = [vocab.word_count.get(w, 1) for w in vocab.idx2word]
            table = getattr(emb, item.name).embedding
            whole = full_tensor(table)  # a sharded table's statistics span its rows
            with torch.no_grad():
                normalize_embedding_(whole, item.normalize_method, counts)
                if whole is not table:
                    local(table).copy_(shard_like(whole, table))

    def load_weights(self, path: str) -> None:
        """A port checkpoint (``.pt``: the ``torch.save`` of a training
        checkpoint or of a bare ``state_dict``) or the JAX package's params
        as a flat ``.npz`` of flax paths; only the weights are read."""
        if str(path).endswith(".npz"):
            from ..convert import flax_to_torch

            with np.load(path) as f:
                flat = {k: f[k] for k in f.files}
            state = flax_to_torch(flat, self.model, full_shapes(self.model))
        else:
            state = torch.load(path, map_location="cpu", weights_only=True)
            state = state.get("model", state)
        load_full_state_dict(self.model, state)

    def current_lr(self) -> float:
        if self.optimizer is not None:
            return self.optimizer.lr_at(self.step)
        return float(self.cfg.get("optimizer", {}).get("args", {}).get("lr", 1e-3))

    def plateau_step(self, value) -> None:
        """Feed the watched metric to ReduceLROnPlateau, if configured."""
        plateau = self.optimizer.plateau if self.optimizer is not None else None
        if plateau is None or value is None:
            return
        plateau.step(float(value), self.optimizer.base_lr)

    def _alpha(self, epoch: int) -> float:
        if self.alpha_schedule is not None:
            return float(coeff_at(self.alpha_schedule, epoch))
        return self.alpha

    # -- loss and the train step ----------------------------------------------
    def compute_loss(self, inputs, gold, init_phase: bool, alpha: float):
        """The training objective ``(total, per-term dict)``, reduced per
        the configured mode: in the warm-up phase the dependency scores
        against the rule counts, else the NLL, interpolated with the
        grounding loss in the joint model."""
        model = self.model
        with span("vlgae.forward"):
            out = (model(inputs, with_grounding=not init_phase) if self.is_joint
                   else model(inputs))
        with span("vlgae.loss"):
            if init_phase:
                total, aux = loss_init_rules(out, gold)
                return self.reduce(total, aux, inputs["seq_len"])
            return self.loss_terms(out, inputs, alpha)

    def loss_terms(self, out, inputs, alpha: float):
        """The joint phase's objective from the forward's scores: the NLL,
        interpolated with the grounding loss in the joint model, reduced;
        ``(total, per-term dict)``."""
        lengths = inputs["seq_len"]
        with span("vlgae.loss.dmv"):
            total, aux = loss_nll(out, lengths, viterbi=self.dep_cfg.viterbi_training)
        if self.is_joint:
            with span("vlgae.loss.grounding"):
                total, aux = self.model.loss(out, inputs, total, aux, alpha)
        return self.reduce(total, aux, lengths)

    def reduce(self, total, aux, lengths):
        """``(total, aux)`` reduced per the configured mode over the counts
        of the global batch: each rank's loss is its share."""
        num_token = torch.clamp_min(global_sum(lengths.sum(), self.dp), 1)
        n_sent = torch.clamp_min(global_sum((lengths > 0).sum(), self.dp), 1)
        mode = self.loss_reduction_mode
        total = reduce_loss(total, num_token, n_sent, mode)
        aux = {k: reduce_loss(v, num_token, n_sent, mode) for k, v in aux.items()}
        return total, aux

    def grad_step(self, x, y, init_phase: bool, alpha: float):
        """Upload this rank's rows of a padded batch, run forward and
        backward (gradients add into ``.grad``), through the step's CUDA
        graphs where they apply (:attr:`graphs`). Returns the detached loss
        and terms (this rank's shares) on the device."""
        self.model.train()
        inputs = shard_batch(x, self.dp)
        gold = shard_batch(y, self.dp)
        B = len(x["seq_len"])
        set_batch_rows(self.model, (*self.dp.rows(B), B) if self.dp.sharded else None)
        graphs = self._step_graphs(init_phase)
        if graphs is not None:
            return graphs.grad_step(inputs, alpha)
        loss, aux = self.compute_loss(inputs, gold, init_phase, alpha)
        with span("vlgae.backward"):
            loss.backward()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def apply_step(self, n_accumulated: int = 1) -> None:
        """Average the accumulated gradients, sum them over the ranks,
        clip, update, clear."""
        with span("vlgae.optimizer"):
            if self.graphs is not None and self.graphs.holds_grads:
                if self.watcher is not None and self.watcher.should_log(self.step):
                    self._log_trees()
                self.graphs.apply_step(self.step)
                self._stepped()
                return
            if n_accumulated > 1:
                for p in self.optimizer.params:
                    if p.grad is not None:
                        local(p.grad).mul_(1.0 / n_accumulated)
            self.optimizer.sum_grads()
            if self.watcher is not None and self.watcher.should_log(self.step):
                self._log_trees()
            self.optimizer.update(self.step)
            self.optimizer.zero_grad()
        self._stepped()

    def _log_trees(self) -> None:
        """This update's global gradients, at the parameters before it;
        every rank gathers the sharded leaves, the writer logs them."""
        self.watcher.log_trees(self.step, (
            (n, full_tensor(p.detach(), p),
             None if p.grad is None else full_tensor(p.grad, p))
            for n, p in self.model.named_parameters()))

    def _stepped(self) -> None:
        self.step += 1
        if self.profiler is not None:
            self.profiler.step()

    def _step_graphs(self, init_phase: bool):
        """The step's CUDA graphs (:class:`~.graphs.StepGraphs`, built at
        their first step) where they apply to this pipeline and phase, else
        None (the eager step)."""
        if init_phase:
            return None
        if self._graphable is None:
            self._graphable = graphs_apply(self)
        if not self._graphable:
            return None
        if self.graphs is None:
            self.graphs = StepGraphs(self)
        return self.graphs

    def train_step(self, x, y, init_phase: bool, alpha: float):
        """One update on one padded batch; returns the loss and terms as
        device tensors (no host sync)."""
        with span("vlgae.train_step"):
            loss, aux = self.grad_step(x, y, init_phase, alpha)
            self.apply_step()
        return loss, aux

    def train_epoch(self, epoch: int, val_fn: Optional[Callable] = None,
                    val_check_interval: float = 1.0):
        """One training epoch: the warm-up split and rule targets while
        ``epoch < init_epoch`` (``init_method='y'``), the epoch's grounding
        coefficient, batches padded to a power of two (x and y), loss sums
        kept on the device and read once per validation window and at the
        end (summed over the ranks), and ``val_fn()`` every
        ``val_check_interval`` of the epoch."""
        if self.optimizer is None:
            self.setup_optimizer()
        self.epoch = epoch
        init_phase = (epoch < self.dep_cfg.init_epoch
                      and self.dep_cfg.init_method == "y")
        split = ("train_init" if init_phase and "train_init" in self.dm.datasets
                 else "train")
        # rule targets only in the warm-up; then drop the per-instance caches
        if self.dm.include_init_rules and not init_phase:
            for ds in self.dm.datasets.values():
                for inst in ds:
                    inst.pop("_init_rules", None)
        self.dm.include_init_rules = init_phase
        alpha = self._alpha(epoch)
        trainer = self.cfg.get("trainer", {}) or {}
        loss_sum, loss_n = None, 0
        aux_sums: Dict[str, torch.Tensor] = {}
        win_sums: Dict[str, torch.Tensor] = {}
        win_n = 0
        t0 = time.time()
        sampler_len = len(self.dm.sampler(split))
        val_every = (max(1, int(sampler_len * val_check_interval))
                     if val_fn is not None and 0 < val_check_interval < 1 else None)
        fast_dev_run = int(trainer.get("fast_dev_run", 0) or 0)
        accum = int(trainer.get("accumulate_grad_batches", 1) or 1)
        pending = 0
        bar = _progress_bar(self.dm.batches(split), total=sampler_len,
                            desc=f"epoch {epoch}", enable=trainer.get("progress_bar", True))
        for i, (x, y) in enumerate(bar):
            if fast_dev_run and i >= fast_dev_run:
                break
            if val_every and i > 0 and i % val_every == 0:
                self.window_train_terms = {
                    f"train/{k}": v / max(win_n, 1)
                    for k, v in self._host_sums(win_sums).items()}
                win_sums, win_n = {}, 0
                val_fn()
            if self._batch_normalize:
                self.normalize_embeddings("batch")
            if init_phase and "dec_rule" not in y:
                raise RuntimeError(
                    "init_method='y' warm-up needs dec_rule/attach_rule/root_rule "
                    "in the batch; set dm.include_init_rules")
            x, _ = pad_batch_to_devices(x, self.world.world, pow2=True)
            y, _ = pad_batch_to_devices(y, self.world.world, pow2=True)
            if accum <= 1:
                loss, aux = self.train_step(x, y, init_phase, alpha)
            else:
                loss, aux = self.grad_step(x, y, init_phase, alpha)
                pending += 1
                if pending == accum:
                    self.apply_step(pending)
                    pending = 0
            loss_sum = loss if loss_sum is None else loss_sum + loss
            loss_n += 1
            for k, v in aux.items():
                aux_sums[k] = v if k not in aux_sums else aux_sums[k] + v
                win_sums[k] = v if k not in win_sums else win_sums[k] + v
            win_n += 1
        if pending:
            self.apply_step(pending)
        sums = self._host_sums({"loss": loss_sum, **aux_sums} if loss_n else {})
        stats = {"train/loss": sums.pop("loss") / loss_n if loss_n else 0.0,
                 "train/time": time.time() - t0,
                 "train/init_phase": init_phase}
        for k, v in sums.items():
            stats[f"train/{k}"] = v / loss_n
        return stats

    def _host_sums(self, sums: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Device-side loss sums read on the host, each summed over the
        ranks (one all-reduce)."""
        if not sums:
            return {}
        total = global_sum(torch.stack([v.float() for v in sums.values()]), self.dp)
        return dict(zip(sums, (float(v) for v in total.cpu())))

    # -- checkpoints -------------------------------------------------------------
    def save_checkpoint(self, name: str = "last") -> str:
        """``<workdir>/checkpoint/<name>.pt``: weights, Adam and plateau
        state, the dropout generator, step, epoch, best, and the host RNG
        state of the training data (sampler epochs, box sampling). The
        weights and moments are whole at every world size, with FSDP or
        without, and at every ``(data, model)`` shape; every rank takes part
        in gathering them and rank 0 writes."""
        folder = os.path.join(self.workdir, "checkpoint")
        path = os.path.join(folder, f"{name}.pt")
        state = {
            "model": full_state_dict(self.model),
            "optimizer": (self.optimizer.state_dict()
                          if self.optimizer is not None else None),
            "generator": self.generator.get_state(),
            "step": self.step, "epoch": self.epoch, "best": self.best,
            "data": self.dm.train_state(),
        }
        if self.world.rank == 0:
            os.makedirs(folder, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save(state, tmp)
            os.replace(tmp, path)
        barrier(self.world)
        return path

    def load_checkpoint(self, path: str, load_training_state: bool = False):
        """Restore the weights (strict) and, for a resume, everything else
        :meth:`save_checkpoint` wrote."""
        if not load_training_state:
            self.load_weights(path)
            return
        state = torch.load(path, map_location="cpu", weights_only=True)
        load_full_state_dict(self.model, state["model"])
        if self.optimizer is None:
            self.setup_optimizer()
        if state.get("optimizer") is not None:
            self.optimizer.load_state_dict(state["optimizer"])
            self.graphs = None  # captured on the replaced Adam state
        self.generator.set_state(state["generator"])
        self.step, self.epoch, self.best = state["step"], state["epoch"], state["best"]
        self.dm.load_train_state(state["data"])

    def is_better(self, value) -> bool:
        if value is None or not math.isfinite(float(value)):
            return False
        if self.best is None:
            return True
        return value < self.best if self.watch_mode == "min" else value > self.best

    # -- eval step ------------------------------------------------------------
    @torch.no_grad()
    def eval_step(self, x: Dict[str, np.ndarray], alpha: float = 0.5
                  ) -> Dict[str, np.ndarray]:
        """The eval step on this rank's rows of the padded batch ``x``: its
        heads, decodes and its share of the loss."""
        model = self.model.eval()
        inputs = shard_batch(x, self.dp)
        out = model(inputs)
        lengths = inputs["seq_len"]
        total, _ = loss_nll(out, lengths, viterbi=self.dep_cfg.viterbi_training)
        heads = ldndmv_decode(out, lengths, mbr=self.dep_cfg.mbr_decoding)
        if not self.is_joint:
            return {"arc": heads.cpu().numpy(), "loss": total.cpu().numpy()}
        total, _ = model.loss(out, inputs, total, alpha=alpha, train=False)
        g = model.decode_grounding_device(out, inputs)
        res = {"arc": heads, "loss": total, "txt_to_img": g["txt_to_img"]}
        if "txt_to_factor_idx" in g:  # on_factor
            res["txt_to_factor_idx"] = g["txt_to_factor_idx"]
            res["txt_mask"] = out["txt_packed"][1]
        res = {k: v.cpu().numpy() for k, v in res.items()}
        if "txt_to_factor_idx" in res:
            res["vis_split"] = np.asarray(out["vis_packed"][2])
        return res

    def evaluate(self, split: str = "dev", metric_idx: int = 0):
        """Metrics and predictions (by sample id) of ``split``: each rank
        evaluates its rows of every batch; the metric states and the loss
        sums are summed over the ranks and the predictions merged, on every
        rank."""
        metric = self.metrics[metric_idx]
        metric.reset()
        # the epoch's grounding coefficient: val/loss is the trained objective
        alpha = self._alpha(self.epoch)
        loss_sum, token_sum = 0.0, 0
        all_outputs = {}
        self.step_times, self.step_sizes = [], []
        for x, y in self.dm.batches(split, shuffle=False):
            xp, real = pad_batch_to_devices(x, self.world.world, pow2=True)
            start, stop = self.dp.rows(len(xp["seq_len"]))
            t0 = time.perf_counter()
            res = self.eval_step(xp, alpha)
            self.step_times.append(time.perf_counter() - t0)
            self.step_sizes.append(real)
            # this rank's real rows: [start, start + mine) of the batch
            mine = max(0, min(stop, real) - start)
            res = {k: v[:mine] if (v.ndim > 0 and k != "vis_split") else v
                   for k, v in res.items()}
            loss_sum += float(res["loss"])
            x = {k: v[start:start + mine] for k, v in x.items()}
            y = {k: v[start:start + mine] for k, v in y.items()}
            token_sum += int(x["seq_len"].sum())
            if mine == 0:
                continue
            if "txt_to_img" in res:  # image indices relative to this rank's rows
                res["txt_to_img"] = res["txt_to_img"] - start
            mask = (np.arange(x["word"].shape[1])[None, :]
                    < np.asarray(x["seq_len"])[:, None])
            predict = {"arc": res["arc"]}
            if "txt_to_factor_idx" in res:
                vis_split = tuple(int(s) for s in res["vis_split"])
                box_index = x.get("vis_box_index", np.tile(
                    np.arange(vis_split[0])[None], (res["arc"].shape[0], 1)))
                predict["txt_to_factor"] = self.model.format_grounding(
                    res["txt_to_factor_idx"], vis_split,
                    np.asarray(x["seq_len"]), box_index, res["txt_mask"])
                predict["txt_to_img"] = [res["txt_to_img"][j][res["txt_mask"][j]]
                                         for j in range(res["arc"].shape[0])]
            elif "txt_to_img" in res:  # on_img: one image per caption
                predict["txt_to_img"] = list(res["txt_to_img"])
            metric.update(predict, y, mask)
            for j, sid in enumerate(np.asarray(x["id"])):
                n = int(x["seq_len"][j])
                rec = {"arc": res["arc"][j, :n].tolist()}
                if "txt_to_factor" in predict:
                    rec["txt_to_factor"] = predict["txt_to_factor"][j]
                all_outputs[int(sid)] = rec
        if self.dp.group is not None:
            metric.sync(lambda vec: sum_across_processes(vec, self.dp))
            all_outputs = gather_predictions(all_outputs, self.dp)
            loss_sum, token_sum = sum_across_processes([loss_sum, token_sum], self.dp)
        result = metric.compute()
        result["loss"] = float(loss_sum) / max(int(token_sum), 1)
        return result, all_outputs

    # -- prediction writing -------------------------------------------------
    def write_predictions(self, path: str, split: str, outputs: Dict[int, dict]):
        """CoNLL rows ``ID FORM POS HEAD ALIGN`` (ALIGN: word factors, then
        arc factors, tab-separated), the format ``eval.py`` scores; under
        ``decode_grounding_mode='on_img'`` the column is the placeholder
        ``X`` (two of them, tab-separated, with arc factors); the
        stand-alone parser writes no ALIGN column. (Under data parallelism
        the CLIs call it on rank 0 alone.)"""
        ds = self.dm.datasets[split]
        jcfg = self.model.cfg if self.is_joint else None
        on_img = jcfg is not None and jcfg.decode_grounding_mode == "on_img"
        placeholder = "X" if on_img and jcfg.language_factor_mode == "word" else "X\tX"
        with open(path, "w", encoding="utf-8") as f:
            for inst in ds:
                rec = outputs.get(inst["id"])
                if rec is None:
                    continue
                n = inst["seq_len"]
                factors = rec.get("txt_to_factor")
                rows = []
                for i in range(n):
                    tag = inst["tag"][i] if "tag" in inst else "-"
                    head = rec["arc"][i] if i < len(rec["arc"]) else 0
                    row = [i + 1, inst["raw_word"][i], tag, head]
                    if factors is not None:
                        row.append(self._format_factor(factors, i, n))
                    elif on_img:
                        row.append(placeholder)
                    rows.append(row)
                write_conll_rows(f, rows)

    @staticmethod
    def _format_factor(factors, idx, length):
        """ALIGN column."""
        def conv(item):
            t, x = item
            if isinstance(x, tuple):
                return f"{t} {x[0]}-{x[1]}"
            return f"{t} {x}"

        if len(factors) > length:
            return "\t".join(["|".join(map(conv, factors[idx])),
                              "|".join(map(conv, factors[idx + length]))])
        return "|".join(map(conv, factors[idx]))
