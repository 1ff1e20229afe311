"""Evaluation metrics (NumPy accumulators; a copy of
vlgae_tpu/training/metrics.py). States are plain float accumulators."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

EPS = 1e-12


class MetricBase:
    def reset(self):
        for k in self._state_names():
            setattr(self, k, 0.0)
        # non-state flags derived from what update() saw must clear too
        # (has_label would otherwise stick across evaluations and emit
        # spurious las/lcm zeros forever after one labeled batch)
        if hasattr(self, "has_label"):
            self.has_label = False

    def _state_names(self) -> List[str]:
        return [k for k in vars(self) if k.startswith("s_")]

    def state_vector(self) -> np.ndarray:
        return np.array([getattr(self, k) for k in sorted(self._state_names())])

    def load_state_vector(self, vec):
        for k, v in zip(sorted(self._state_names()), vec):
            setattr(self, k, float(v))

    def sync(self, reduce_fn):
        """Reduce the summed states across processes before compute
        (``reduce_fn``: a vector to its sum over ranks)."""
        self.load_state_vector(reduce_fn(self.state_vector()))

    def compute(self) -> Dict[str, float]:
        raise NotImplementedError


class DependencyParsingMetric(MetricBase):
    """UAS/UCM (+LAS/LCM when labeled) (ref: metric.py:18-61)."""

    def __init__(self):
        self.s_correct_arcs = 0.0
        self.s_correct_rels = 0.0
        self.s_total = 0.0
        self.s_n_ucm = 0.0
        self.s_n_lcm = 0.0
        self.s_n = 0.0
        self.has_label = False

    def update(self, predict, gold, mask):
        arc_pred = np.asarray(predict["arc"])
        arc_gold = np.asarray(gold["arc"])
        mask = np.asarray(mask)
        arc_ok = (arc_pred == arc_gold) & mask
        self.s_n += mask.shape[0]
        self.s_total += mask.sum()
        lens = mask.sum(1)
        self.s_n_ucm += (arc_ok.sum(1) == lens).sum()
        self.s_correct_arcs += arc_ok[mask].sum()
        if "rel" in predict:
            self.has_label = True
            rel_ok = (np.asarray(predict["rel"]) == np.asarray(gold["rel"])) & arc_ok
            self.s_n_lcm += (rel_ok.sum(1) == lens).sum()
            self.s_correct_rels += rel_ok[mask].sum()

    def compute(self):
        out = {
            "ucm": 100 * self.s_n_ucm / (self.s_n + EPS),
            "uas": 100 * self.s_correct_arcs / (self.s_total + EPS),
        }
        if self.has_label:
            out["lcm"] = 100 * self.s_n_lcm / (self.s_n + EPS)
            out["las"] = 100 * self.s_correct_rels / (self.s_total + EPS)
        return out


class FactorImageMatchingMetric(MetricBase):
    """txt->img retrieval over factors (ref: metric.py:64-83)."""

    def __init__(self):
        self.s_correct = 0.0
        self.s_total = 0.0

    def update(self, predict, gold, mask):
        if "txt_to_img" not in predict:
            return
        for i, row in enumerate(predict["txt_to_img"]):
            row = np.asarray(row)
            self.s_total += row.size
            self.s_correct += (row == i).sum()

    def compute(self):
        return {"acc": 100 * self.s_correct / (self.s_total + 1e-6)}


class CaptionImageMatchingMetric(MetricBase):
    """caption->img retrieval: caption i found image i (ref: metric.py:86-105)."""

    def __init__(self):
        self.s_correct = 0.0
        self.s_total = 0.0

    def update(self, predict, gold, mask):
        if "txt_to_img" not in predict:
            return
        t2i = np.asarray(predict["txt_to_img"])
        self.s_total += len(t2i)
        self.s_correct += (t2i == np.arange(len(t2i))).sum()

    def compute(self):
        return {"acc": 100 * self.s_correct / (self.s_total + 1e-6)}


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_iou(b1, b2):
    """IoU of broadcast box arrays [..., 4]."""
    area1, area2 = box_area(b1), box_area(b2)
    lt = np.maximum(b1[..., :2], b2[..., :2])
    rb = np.minimum(b1[..., 2:], b2[..., 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1 + area2 - inter + EPS)


class BoxRelMatchingMetric(MetricBase):
    """In-training grounding accuracy: IoU@0.5 of predicted vs gold boxes
    per factor type, rel matched in either orientation
    (ref: metric.py:108-208)."""

    def __init__(self):
        self.s_correct_obj = 0.0
        self.s_correct_attr = 0.0
        self.s_correct_rel = 0.0
        self.s_correct_r_rel = 0.0
        self.s_total_obj = 0.0
        self.s_total_attr = 0.0
        self.s_total_rel = 0.0

    def update(self, predict, gold, mask):
        if "sg_box" not in gold or "txt_to_factor" not in predict:
            return
        proposal = np.asarray(gold["vis_box"])  # [B, P, 4]
        gold_type = np.asarray(gold["sg_type"])  # [B, L]
        gold_box = np.asarray(gold["sg_box"]).reshape(
            *gold_type.shape, 2, 4
        )  # [B, L, 2(pair), 4]
        mask = np.asarray(mask)
        seq_len = mask.sum(1)

        for b, inst in enumerate(predict["txt_to_factor"]):
            for t, cands in enumerate(inst[: int(seq_len[b])]):
                gt = gold_type[b, t]
                if gt == 0:
                    continue
                if gt == 1:
                    self.s_total_obj += 1
                elif gt == 2:
                    self.s_total_attr += 1
                else:
                    self.s_total_rel += 1
                hit = r_hit = False
                for type_str, idx in cands:
                    type_id = {"obj": 1, "attr": 2, "rel": 3}.get(type_str, 0)
                    if gt in (1, 2) and type_id in (1, 2) and type_id > 0:
                        box = proposal[b, idx if isinstance(idx, int) else idx[0]]
                        if pairwise_iou(box, gold_box[b, t, 0]) > 0.5:
                            hit = True
                    elif gt == 3 and type_id == 3 and isinstance(idx, tuple):
                        b1 = proposal[b, idx[0]]
                        b2 = proposal[b, idx[1]]
                        if (pairwise_iou(b1, gold_box[b, t, 0]) > 0.5
                                and pairwise_iou(b2, gold_box[b, t, 1]) > 0.5):
                            hit = True
                        if (pairwise_iou(b2, gold_box[b, t, 0]) > 0.5
                                and pairwise_iou(b1, gold_box[b, t, 1]) > 0.5):
                            r_hit = True
                if gt == 1 and hit:
                    self.s_correct_obj += 1
                elif gt == 2 and hit:
                    self.s_correct_attr += 1
                elif gt == 3:
                    if hit:
                        self.s_correct_rel += 1
                    if r_hit or hit:
                        self.s_correct_r_rel += 1

    def compute(self):
        rel = max(self.s_correct_rel, self.s_correct_r_rel)
        total = self.s_total_obj + self.s_total_attr + self.s_total_rel
        return {
            "acc": 100 * (self.s_correct_obj + self.s_correct_attr + rel)
            / (total + EPS),
            "obj": 100 * self.s_correct_obj / (self.s_total_obj + EPS),
            "attr": 100 * self.s_correct_attr / (self.s_total_attr + EPS),
            "rel": 100 * self.s_correct_rel / (self.s_total_rel + EPS),
        }


class MultiMetric(MetricBase):
    """Dict-of-metrics combinator, 'main' unprefixed (ref: metric.py:253-281)."""

    def __init__(self, main: MetricBase = None, **others: MetricBase):
        self.main = main
        self.others = others

    def _all(self):
        return ([self.main] if self.main is not None else []) + list(
            self.others.values()
        )

    def reset(self):
        for m in self._all():
            m.reset()

    def update(self, predict, gold, mask):
        for m in self._all():
            m.update(predict, gold, mask)

    def sync(self, reduce_fn):
        for m in self._all():
            m.sync(reduce_fn)

    def compute(self):
        out = dict(self.main.compute()) if self.main is not None else {}
        for name, m in self.others.items():
            for k, v in m.compute().items():
                out[f"{name}/{k}"] = v
        return out
