"""The numbers that decide ``correct`` for a training cell: the program's
first steps against the reference's, each leaf's norms compared by their
gap, relative to the larger of the reference's norm of that leaf and of the
median leaf (some gradients are all but zero), and the program's inputs
against those the reference read from the corpus files."""

from __future__ import annotations

import math
import statistics

import numpy as np


def _gap(p: float, r: float, floor: float) -> float:
    return abs(p - r) / max(r, floor, 1e-30)


def train_readings(prog: dict, ref: dict) -> dict:
    """``loss1_rel`` (the first step), ``loss_rel`` (worst step),
    ``grad_gap`` (worst leaf of the first gradient), ``change_gap`` (worst
    leaf of the change after the steps, leaves whose reference gradient is
    under a thousandth of the median leaf's left out: they move by round-off
    alone) and ``input_diff`` (entries of the program's batches that differ
    from the reference's inputs); and the family's further numbers, from
    the ``extra`` of each side (:func:`extra_readings`)."""
    rel = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"])]
    g_med = statistics.median(ref["grad"].values())
    grad = {n: _gap(prog["grad"][n], r, g_med) for n, r in ref["grad"].items()}
    counted = [n for n, r in ref["grad"].items() if r >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][n] for n in counted)
    change = {n: _gap(prog["change"][n], ref["change"][n], c_med) for n in counted}
    worst_g = max(grad, key=grad.get)
    worst_c = max(change, key=change.get)
    out = {"loss1_rel": rel[0], "loss_rel": max(rel), "grad_gap": grad[worst_g],
           "grad_gap_median": statistics.median(grad.values()),
           "change_gap": change[worst_c],
           "change_gap_median": statistics.median(change.values()),
           "input_diff": float(ref.get("input_diff", 0)),
           "_worst": {"grad": worst_g, "change": worst_c,
                      "left_out": sorted(set(ref["grad"]) - set(counted))}}
    return out | extra_readings(prog.get("extra", {}), ref.get("extra", {}))


def extra_readings(prog: dict, ref: dict) -> dict:
    """A family's further numbers: for each name of the reference's
    ``extra`` that the program also gave, the largest entry of the gap
    between the two (numbers or host arrays) over the largest entry of the
    reference's; infinite where their shapes differ. A name the program did
    not give has no reading."""
    out = {}
    for k, r in ref.items():
        if k in prog:
            p, r = np.asarray(prog[k], np.float64), np.asarray(r, np.float64)
            out[k] = (float(np.abs(p - r).max() / max(np.abs(r).max(), 1e-30))
                      if p.shape == r.shape else math.inf)
    return out


def judge(readings: dict, limits: dict) -> tuple:
    """``(correct, checks)``: each number beside its limit; correct when
    every number is at most its limit. A limit with no reading is not
    correct (its value is None)."""
    checks = {k: {"value": readings.get(k), "limit": limits[k]} for k in limits}
    ok = all(v["value"] is not None and v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
