"""Evaluation pipeline (counterpart of the eval half of
vlgae_tpu/training/pipeline.py): batches -> eval step -> metrics and the
CoNLL+ALIGN prediction writer. No optimizer and no train loop yet.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from ..data.conll import write_conll_rows
from ..models.ldndmv import decode as ldndmv_decode
from ..models.ldndmv import loss_nll
from . import metrics as metrics_mod


def pad_batch_pow2(batch: dict, min_b: int = 8):
    """Pad the batch axis to the next power of two (at least ``min_b``).

    Filler rows replicate row 0 with ``seq_len`` zeroed, exactly as the JAX
    package pads for its compile shapes: the fillers take part in the
    cross-image argmax of the decode, so predictions depend on them.
    Returns (batch, real_size).
    """
    B = next(iter(batch.values())).shape[0]
    target = max(min_b, 1 << (B - 1).bit_length())
    pad = target - B
    if pad == 0:
        return batch, B
    out = {}
    for k, v in batch.items():
        filler = np.repeat(np.asarray(v[:1]), pad, axis=0)
        if k == "seq_len":
            filler = np.zeros_like(filler)
        out[k] = np.concatenate([np.asarray(v), filler], axis=0)
    return out, B


def init_params(model: torch.nn.Module, seed: int) -> None:
    """Random weights from ``seed`` (an explicit CPU generator, so the
    draw does not depend on the device): biases and mixing weights 0,
    norm scales 1, BERT tables/kernels N(0, 0.02), static embeddings
    N(0, 1), other matrices N(0, 1/fan_in)."""
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
                if ".bert." in f".{name}":
                    x = x * 0.02
                elif leaf not in ("embedding", "root_emb", "dec_emb"):
                    x = x * (p.shape[-1] if p.dim() == 2 else p.shape[0]) ** -0.5
                p.copy_(x)


def _to_device(x: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in x.items()}


class Pipeline:
    """Owns the model, the datamodule and the metrics."""

    def __init__(self, model, dm, cfg: Dict[str, Any], device="cpu"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.dm = dm
        self.cfg = cfg
        self.dep_cfg = model.dep_cfg
        self.metrics = [self._build_metric_node(cfg.get("metric") or {})]
        interp = (cfg.get("model", {}) or {}).get("grounding_interpolation", 0.5)
        if isinstance(interp, str):
            raise NotImplementedError(
                "a scheduled grounding_interpolation is not ported")
        self.alpha = float(interp)
        # seconds of each eval step of the last evaluate(): batch upload,
        # forward, loss and decode, ending when the results reach the host
        self.step_times: List[float] = []
        self.step_sizes: List[int] = []

    def _build_metric_node(self, node):
        """Instantiate a metric from a config node (``_target_`` matched by
        class name in :mod:`.metrics`); the flagship default without one."""
        if not isinstance(node, dict) or "_target_" not in node:
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

    # -- weights -------------------------------------------------------------
    def load_weights(self, path: str) -> None:
        """A port checkpoint (``torch.save`` of the state_dict, ``.pt``) or
        the JAX package's params as a flat ``.npz`` of flax paths."""
        if str(path).endswith(".npz"):
            from ..convert import flax_to_torch

            with np.load(path) as f:
                flat = {k: f[k] for k in f.files}
            state = flax_to_torch(flat, self.model)
        else:
            state = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(state, strict=True)

    # -- eval step ------------------------------------------------------------
    @torch.no_grad()
    def eval_step(self, x: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        model = self.model
        inputs = _to_device(x, self.device)
        out = model(inputs)
        lengths = inputs["seq_len"]
        dep_loss, _ = loss_nll(out, lengths, viterbi=self.dep_cfg.viterbi_training)
        total = model.loss(out, inputs, dep_loss, self.alpha)
        heads = ldndmv_decode(out, lengths, mbr=self.dep_cfg.mbr_decoding)
        g = model.decode_grounding_device(out, inputs)
        res = {"arc": heads, "loss": total, "txt_to_img": g["txt_to_img"],
               "txt_to_factor_idx": g["txt_to_factor_idx"],
               "txt_mask": out["txt_packed"][1]}
        res = {k: v.cpu().numpy() for k, v in res.items()}
        res["vis_split"] = np.asarray(out["vis_packed"][2])
        return res

    def evaluate(self, split: str = "dev"):
        metric = self.metrics[0]
        metric.reset()
        loss_sum, token_sum = 0.0, 0
        all_outputs = {}
        self.step_times, self.step_sizes = [], []
        for x, y in self.dm.batches(split, shuffle=False):
            xp, real = pad_batch_pow2(x)
            t0 = time.perf_counter()
            res = self.eval_step(xp)
            self.step_times.append(time.perf_counter() - t0)
            self.step_sizes.append(real)
            res = {k: v[:real] if (v.ndim > 0 and v.shape[0] >= real
                                   and k != "vis_split") else v
                   for k, v in res.items()}
            loss_sum += float(res["loss"])
            token_sum += int(x["seq_len"].sum())
            mask = (np.arange(x["word"].shape[1])[None, :]
                    < np.asarray(x["seq_len"])[:, None])
            vis_split = tuple(int(s) for s in res["vis_split"])
            box_index = x.get("vis_box_index", np.tile(
                np.arange(vis_split[0])[None], (res["arc"].shape[0], 1)))
            predict = {
                "arc": res["arc"],
                "txt_to_factor": self.model.format_grounding(
                    res["txt_to_factor_idx"], vis_split,
                    np.asarray(x["seq_len"]), box_index, res["txt_mask"]),
                "txt_to_img": [res["txt_to_img"][j][res["txt_mask"][j]]
                               for j in range(res["arc"].shape[0])],
            }
            metric.update(predict, y, mask)
            for j, sid in enumerate(np.asarray(x["id"])):
                n = int(x["seq_len"][j])
                all_outputs[int(sid)] = {
                    "arc": res["arc"][j, :n].tolist(),
                    "txt_to_factor": predict["txt_to_factor"][j],
                }
        result = metric.compute()
        result["loss"] = loss_sum / max(token_sum, 1)
        return result, all_outputs

    # -- prediction writing -------------------------------------------------
    def write_predictions(self, path: str, split: str, outputs: Dict[int, dict]):
        """CoNLL rows ``ID FORM POS HEAD ALIGN`` (ALIGN: word factors, then
        arc factors, tab-separated), the format ``eval.py`` scores."""
        ds = self.dm.datasets[split]
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
