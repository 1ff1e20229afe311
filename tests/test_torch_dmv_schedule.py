"""The one-barrier schedule of the DMV kernels (``csrc/dmv_common.cuh``:
``inside_fill_1b`` for every mapping of the inside kernel, K2/K3a/K4, and
K1's inside pass; ``outside_fill_1b`` for K3b and K1's outside pass),
modelled on the CPU.

1. An index model walks both passes, in both semirings, for every sentence
   length of n1 = 2..101: per width step, every chart cell each task (a start
   ``i``) reads and writes, as the kernels' loops index them. It asserts that
   every cell a task reads lies in the span triangle and is either behind the
   last barrier (narrower in the inside pass, wider in the outside pass, or
   an input) or the task's own same-width cell, handed over in registers;
   that no two tasks write one cell (but the max semiring's marks, which
   only ever write a 1 to a narrower cell and are read behind a barrier);
   and that every cell of the triangle is written once.
2. A value model runs the same schedule in NumPy: NaN in every cell not yet
   written (a read ahead of its barrier poisons the result), writes applied
   at the barrier, the same-width term folded in last from the task's own
   values, the log outside pass in its log-marginal form, the max semiring's
   same-width incomplete-span marks voted, not stored.
   It is held against the port's plain versions (``dmv_inside_charts_plain``,
   ``dmv_outside_plain``) on tie-free potentials: in the max semiring in
   f32, bit-equal charts and indicators (the fold changes no float sum); in
   log in f64, within 1e-5 of the f32 plain version (its round-off).
3. A lane model of ``inside_fill_1b`` on one warp (the warp mapping of
   ``csrc/dmv_inside.cu``, n1 <= 9, nt = 32): per width the groups of
   ``group_lanes`` lanes, each lane's strided share of the split terms with
   the same-width terms selected to -inf, the xor butterflies, and the fold
   (``lse_get`` / ``lse_fold``) as the kernel computes them, against the
   plain charts with the same tolerances as 2.
4. K1 (``csrc/dmv_fused.cu``) composed as it runs: the value model's inside
   pass, then its outside pass on the same charts at a cotangent of one,
   held against ``vlgae_tpu``'s ``dmv_value_and_grads_fast`` (the JAX scan
   on the CPU) on tie-free potentials with lengths 0 and 1 among them: in
   log in f64 within 1e-5 + 1e-5|x| of JAX's f32, in max in f32 exactly.
   And the log-marginal form's own round-off: the whole composition in f32
   at n1 = 101 (captions of 86-100 words) against the plain version in f64,
   within K1's tolerance on the card (5e-4 + 1e-4|x|, ``chip_smoke.py``'s
   ``K1_GRAD_ATOL`` / ``K1_GRAD_RTOL``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlgae_tpu.struct.distributions import dmv_value_and_grads_fast
from vlgae_tpu_torch.ops.dmv_cuda import group_lanes
from vlgae_tpu_torch.struct import (dmv_inside_charts_plain, dmv_merge, dmv_outside_plain,
                                    dmv_value_and_grads_plain)

HC, NC, LEFT, RIGHT, GO, STOP = 0, 1, 0, 1, 0, 1
NEG = -1e12


# ---------------------------------------------------------------------------
# 1. The index model

def _ranges(lo, hi):
    """``(task, t)`` flat arrays for t in [lo[i], hi[i]) of each task i."""
    lo, hi = np.asarray(lo), np.asarray(hi)
    cnt = np.maximum(hi - lo, 0)
    task = np.repeat(np.arange(len(lo)), cnt)
    start = np.repeat(lo, cnt)
    off = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return task, start + off


def inside_step(L, w):
    """Reads and writes of width step ``w`` of ``inside_fill_1b``: lists of
    ``(chart, width, start, task, handoff)`` and ``(chart, width, start,
    task)``; a task is a start ``i``."""
    n = L + 1
    i = np.arange(n - w)
    full = np.full(len(i), w)
    reads = []
    task, t = _ranges(np.zeros_like(i), full)  # the incomplete spans' splits
    reads += [("Cr", t, task, task, False), ("Cl", w - 1 - t, task + 1 + t, task, False)]
    task, t = _ranges(np.ones_like(i), full)  # Cl[w][i]: t >= 1
    reads += [("Il", w - t, task + t, task, False), ("Cl", t, task, task, False)]
    task, t = _ranges(np.zeros_like(i), full - 1)  # Cr[w][i]: t <= w - 2
    reads += [("Ir", t + 1, task, task, False), ("Cr", w - 1 - t, task + 1 + t, task, False)]
    # the folded same-width terms: Il[w][i] + Cl[0][i], Ir[w][i] + Cr[0][i+w]
    reads += [("Il", full, i, i, True), ("Ir", full, i, i, True),
              ("Cl", 0 * i, i, i, False), ("Cr", 0 * i, i + w, i, False)]
    writes = [(c, full, i, i) for c in ("Il", "Ir", "Cl", "Cr")]
    return reads, writes, []


def outside_log_step(L, w):
    """Width step ``w`` (``L`` down to 0) of ``outside_fill_1b`` in the log
    semiring (log-marginals: OCl/OCr of the complete spans, OA and AS, the
    split sums' log-marginals and values)."""
    n = L + 1
    i = np.arange(n - w)
    full = np.full(len(i), w)
    nW = L - i - w
    reads = [("Cl", full, i, i, False), ("Cr", full, i, i, False)]
    # the consumers of Cl/Cr[w][i] over [i, i+w]: the wider Cl[W][i] it
    # closes, the split sums A[W][i] it starts
    task, k = _ranges(np.zeros_like(i), nW)
    W = w + 1 + k
    reads += [("OCl", W, task, task, False), ("Cl", W, task, task, False),
              ("Il", W - w, task + w, task, False)]
    reads += [("OA", W, task, task, False), ("AS", W, task, task, False),
              ("Cl", W - 1 - w, task + 1 + w, task, False)]
    # the spans from j < i over it: the split sums A[w+i-j][j] it ends, the
    # wider Cr[w+i-j][j] it closes
    task, j = _ranges(np.zeros_like(i), i)
    reads += [("OA", w + task - j, j, task, False), ("AS", w + task - j, j, task, False),
              ("Cr", task - 1 - j, j, task, False)]
    reads += [("OCr", w + task - j, j, task, False), ("Cr", w + task - j, j, task, False),
              ("Ir", task - j, j, task, False)]
    writes = [("OCl", full, i, i), ("OCr", full, i, i)]
    if w >= 1:
        # Il[w][i]: t < i, Ir[w][i]: t >= 1, then the same-width terms
        task, t = _ranges(np.zeros_like(i), i)
        reads += [("OCl", w + task - t, t, task, False), ("Cl", w + task - t, t, task, False),
                  ("Cl", task - t, t, task, False)]
        task, t = _ranges(np.ones_like(i), nW + 1)
        reads += [("OCr", w + t, task, task, False), ("Cr", w + t, task, task, False),
                  ("Cr", t, task + w, task, False)]
        reads += [("OCl", full, i, i, True), ("OCr", full, i, i, True),
                  ("Cl", 0 * i, i, i, False), ("Cr", 0 * i, i + w, i, False),
                  ("Il", full, i, i, False), ("Ir", full, i, i, False)]
        writes += [("OA", full, i, i), ("AS", full, i, i)]
    return reads, writes, []


def outside_max_step(L, w):
    """Width step ``w`` (``L`` down to 1) of ``outside_fill_1b`` in the max
    semiring: flag reads, and the marks it may push (all split points)."""
    n = L + 1
    i = np.arange(n - w)
    full = np.full(len(i), w)
    # the task's own flags, set by wider spans
    reads = [(c, full, i, i, False) for c in ("OCl", "OCr", "OIl", "OIr")]
    reads += [("Cl", full, i, i, False), ("Cr", full, i, i, False)]
    marks = []
    task, t = _ranges(np.zeros_like(i), full)
    # marked complete spans: both parts of each best split; the same-width
    # incomplete part (Il[w][i] at t = 0, Ir[w][i] at t = w - 1) goes by vote
    reads += [("Il", w - t, task + t, task, False), ("Cl", t, task, task, False),
              ("Ir", t + 1, task, task, False), ("Cr", w - 1 - t, task + 1 + t, task, False)]
    marks += [("OCl", t, task, task), ("OCr", w - 1 - t, task + 1 + t, task)]
    marks += [("OIl", (w - t)[t > 0], (task + t)[t > 0], task[t > 0]),
              ("OIr", (t + 1)[t < w - 1], task[t < w - 1], task[t < w - 1])]
    # the incomplete spans' split sums and the parts of their best splits
    reads += [("Cr", t, task, task, False), ("Cl", w - 1 - t, task + 1 + t, task, False)]
    marks += [("OCr", t, task, task), ("OCl", w - 1 - t, task + 1 + t, task)]
    return reads, [], marks


def walk(n1, L, step, widths, ready, outputs):
    """Runs the steps of one pass over a sentence of length ``L`` and checks
    every read and write (see the module's docstring)."""
    written = {c: np.zeros((n1, n1), bool) for c in outputs}
    for w in widths:
        reads, writes, marks = step(L, w)
        now = {c: np.full((n1, n1), -1) for c in ready}
        for chart, width, start, task in writes:
            assert (width + start <= L).all()
            assert (now[chart][width, start] == -1).all(), "two tasks write one cell"
            assert not written[chart][width, start].any(), "a cell written twice"
            now[chart][width, start] = task
        for chart, width, start, task in marks:
            # a mark is a 1 written to a narrower flag, never read in this step
            assert (width < w).all() and (width >= 0).all() and (width + start <= L).all()
        for chart, width, start, task, handoff in reads:
            assert (width >= 0).all() and (start >= 0).all() and (width + start <= L).all()
            if handoff:
                assert (now[chart][width, start] == task).all(), "a hand-off from another task"
            else:
                assert ready[chart][width, start].all(), f"{chart} read before its barrier"
                assert (now[chart][width, start] == -1).all(), f"{chart} read in its own step"
            if chart in ("OCl", "OCr", "OIl", "OIr") and step is outside_max_step:
                assert (width >= w).all(), "a flag read before every mark of it is in"
        for chart, width, start, task in writes:
            ready[chart][width, start] = True
            written[chart][width, start] = True
    tri = np.add.outer(np.arange(n1), np.arange(n1)) <= L  # [width, start]
    for chart, lo in outputs.items():
        want = tri.copy()
        want[:lo] = False
        assert (written[chart] == want).all(), f"{chart} not written once on the triangle"


def _triangle(n1, L, lo=0):
    tri = np.add.outer(np.arange(n1), np.arange(n1)) <= L
    tri[:lo] = False
    return tri


@pytest.mark.parametrize("which", ["inside", "outside_log", "outside_max"])
def test_one_barrier_schedule_reads_only_cells_behind_a_barrier(which):
    for n1 in range(2, 102):
        L = n1 - 1
        if which == "inside":
            ready = {"Cr": _triangle(n1, L) & (np.arange(n1) == 0)[:, None],
                     "Cl": _triangle(n1, L) & (np.arange(n1) == 0)[:, None],
                     "Ir": np.zeros((n1, n1), bool), "Il": np.zeros((n1, n1), bool)}
            walk(n1, L, inside_step, range(1, L + 1), ready,
                 {"Ir": 1, "Il": 1, "Cr": 1, "Cl": 1})
            assert all(ready[c][_triangle(n1, L, 1 if c[0] == "I" else 0)].all()
                       for c in ready)
        else:
            ready = {c: _triangle(n1, L, 1 if c[0] == "I" else 0)
                     for c in ("Cr", "Cl", "Ir", "Il")}
            if which == "outside_log":
                ready.update({c: np.zeros((n1, n1), bool) for c in ("OCr", "OCl", "OA", "AS")})
                walk(n1, L, outside_log_step, range(L, -1, -1), ready,
                     {"OCr": 0, "OCl": 0, "OA": 1, "AS": 1})
            else:
                # the flags are zeroed (and the root seeded) before the first
                # width; marks fill them in from wider to narrower
                ready.update({c: _triangle(n1, L) for c in ("OCr", "OCl", "OIr", "OIl")})
                walk(n1, L, outside_max_step, range(L, 0, -1), ready, {})


def test_one_barrier_schedule_halves_the_dependent_steps():
    """A pass over a sentence of n1 - 1 words is n1 - 1 barrier-ended width
    steps (plus width 0 of the log outside pass), where the two-barrier
    fills take two a width."""
    for n1 in (17, 51, 57, 101):
        L = n1 - 1
        assert len(range(1, L + 1)) == n1 - 1  # inside
        assert len(range(L, 0, -1)) == n1 - 1  # max outside
        assert len(range(L, -1, -1)) == n1  # log outside: width 0 too
        assert 2 * L == 2 * (n1 - 1)  # inside_fill / outside_fill


# ---------------------------------------------------------------------------
# 2. The value model

def _red(kind, xs, dtype):
    xs = np.asarray(xs, dtype)
    if kind == "max":
        return xs.max()
    m = xs.max()
    return m + np.log(np.exp(xs - m).sum())


def inside_model(dec, att, L, kind, dtype):
    n1, n = dec.shape[0], L + 1
    C = {c: np.full((n1, n1, 2), np.nan, dtype) for c in ("Cr", "Cl", "Ir", "Il")}
    C["Cr"][0, :n] = dec[:n, RIGHT, :, STOP]
    C["Cl"][0, :n] = dec[:n, LEFT, :, STOP]
    Cr, Cl, Ir, Il = (C[c] for c in ("Cr", "Cl", "Ir", "Il"))
    for w in range(1, L + 1):
        pending = []
        for i in range(n - w):
            al = _red(kind, [Cr[t, i, NC] + Cl[w - 1 - t, i + 1 + t, HC] for t in range(w)], dtype)
            ar = _red(kind, [Cr[t, i, HC] + Cl[w - 1 - t, i + 1 + t, NC] for t in range(w)], dtype)
            il = [al + (att[i + w, i, v] + dec[i + w, LEFT, v, GO]) for v in (0, 1)]
            ir = [ar + (att[i, i + w, v] + dec[i, RIGHT, v, GO]) for v in (0, 1)]
            cl = [_red(kind, [Il[w - t, i + t, v] + Cl[t, i, NC] for t in range(1, w)]
                       + [il[v] + Cl[0, i, NC]], dtype) for v in (0, 1)]
            cr = [_red(kind, [Ir[t + 1, i, v] + Cr[w - 1 - t, i + 1 + t, NC]
                              for t in range(w - 1)] + [ir[v] + Cr[0, i + w, NC]], dtype)
                  for v in (0, 1)]
            if i == 0 and w != L:
                cr = [NEG, NEG]
            pending += [(Il, i, il), (Ir, i, ir), (Cl, i, cl), (Cr, i, cr)]
        for X, i, val in pending:  # the barrier
            X[w, i] = val
    return Cr[L, 0, NC], C


def outside_log_model(dec, att, C, L, go, dtype=np.float64):
    """The log-marginal form: every value inside + outside - log Z, a term
    the consumer's log-marginal plus its split's log-weight; every value in
    ``dtype`` (f32 as the kernels compute, f64 for the comparisons)."""
    n1, n = dec.shape[0], L + 1
    Cr, Cl, Ir, Il = (C[c] for c in ("Cr", "Cl", "Ir", "Il"))
    OCr, OCl, OA, AS = (np.full((n1, n1, 2), np.nan, dtype) for _ in range(4))
    GA, GD = np.zeros((n1, n1, 2), dtype), np.zeros((n1, 2, 2, 2), dtype)

    def lse(xs):
        xs = np.asarray(xs, dtype)
        if not len(xs) or (xs == -np.inf).all():
            return dtype(-np.inf)
        return _red("log", xs, dtype)

    for w in range(L, -1, -1):
        pending = []
        for i in range(n - w):
            nW = L - i - w
            ocl, ocr = [[], []], [[], []]
            for k in range(nW):
                W = w + 1 + k
                for u in (0, 1):
                    ocl[NC].append(OCl[W, i, u] + ((Il[W - w, i + w, u] + Cl[w, i, NC])
                                                   - Cl[W, i, u]))
                ocr[NC].append(OA[W, i, LEFT] + ((Cr[w, i, NC] + Cl[W - 1 - w, i + 1 + w, HC])
                                                 - AS[W, i, LEFT]))
                ocr[HC].append(OA[W, i, RIGHT] + ((Cr[w, i, HC] + Cl[W - 1 - w, i + 1 + w, NC])
                                                  - AS[W, i, RIGHT]))
            for j in range(i):
                W = w + i - j
                ocl[HC].append(OA[W, j, LEFT] + ((Cr[i - 1 - j, j, NC] + Cl[w, i, HC])
                                                 - AS[W, j, LEFT]))
                ocl[NC].append(OA[W, j, RIGHT] + ((Cr[i - 1 - j, j, HC] + Cl[w, i, NC])
                                                  - AS[W, j, RIGHT]))
                for u in (0, 1):
                    ocr[NC].append(OCr[W, j, u] + ((Ir[i - j, j, u] + Cr[w, i, NC]) - Cr[W, j, u]))
            if w == L:
                ocr[NC].append(dtype(0))  # the seed
            vl, vr = [lse(x) for x in ocl], [lse(x) for x in ocr]
            if i == 0 and 1 <= w != L:
                vr = [-np.inf, -np.inf]
            pending += [(OCl, i, vl), (OCr, i, vr)]
            if w >= 1:
                lil = [lse([OCl[w + i - j, j, v] + ((Il[w, i, v] + Cl[i - j, j, NC])
                                                   - Cl[w + i - j, j, v]) for j in range(i)]
                           + [vl[v] + ((Il[w, i, v] + Cl[0, i, NC]) - Cl[w, i, v])])
                       for v in (0, 1)]
                lir = [lse([OCr[w + t, i, v] + ((Ir[w, i, v] + Cr[t, i + w, NC]) - Cr[w + t, i, v])
                            for t in range(1, nW + 1)]
                           + [vr[v] + ((Ir[w, i, v] + Cr[0, i + w, NC]) - Cr[w, i, v])])
                       for v in (0, 1)]
                GA[i + w, i] = [go * np.exp(x) for x in lil]
                GA[i, i + w] = [go * np.exp(x) for x in lir]
                arc_l = att[i + w, i] + dec[i + w, LEFT, :, GO]
                arc_r = att[i, i + w] + dec[i, RIGHT, :, GO]
                vl_, vr_ = int(arc_l[1] > arc_l[0]), int(arc_r[1] > arc_r[0])
                pending += [(OA, i, [lse(lil), lse(lir)]),
                            (AS, i, [Il[w, i, vl_] - arc_l[vl_], Ir[w, i, vr_] - arc_r[vr_]])]
        for X, i, val in pending:
            X[w, i] = val
    GD[:n, RIGHT, :, STOP] = go * np.exp(OCr[0, :n])
    GD[:n, LEFT, :, STOP] = go * np.exp(OCl[0, :n])
    return _go_sums(GD, GA, n)


def _go_sums(GD, GA, n):
    for h in range(n):
        GD[h, LEFT, :, GO] = GA[h, :h].sum(0)
        GD[h, RIGHT, :, GO] = GA[h, h + 1:n].sum(0)
    return GD, GA


def outside_max_model(C, L, go):
    n1, n = C["Cr"].shape[0], L + 1
    Cr, Cl, Ir, Il = (C[c] for c in ("Cr", "Cl", "Ir", "Il"))
    OCr, OCl, OIr, OIl = (np.zeros((n1, n1, 2), bool) for _ in range(4))
    OCr[L, 0, NC] = True
    GA, GD = np.zeros((n1, n1, 2), np.float32), np.zeros((n1, 2, 2, 2), np.float32)
    for w in range(L, 0, -1):
        marks = []
        for i in range(n - w):
            same_l, same_r = [False, False], [False, False]  # the vote
            for t in range(w):
                for v in (0, 1):
                    if OCl[w, i, v] and Il[w - t, i + t, v] + Cl[t, i, NC] == Cl[w, i, v]:
                        marks.append((OCl, t, i, NC))
                        if t == 0:
                            same_l[v] = True
                        else:
                            marks.append((OIl, w - t, i + t, v))
                    if OCr[w, i, v] and Ir[t + 1, i, v] + Cr[w - 1 - t, i + 1 + t, NC] \
                            == Cr[w, i, v]:
                        marks.append((OCr, w - 1 - t, i + 1 + t, NC))
                        if t == w - 1:
                            same_r[v] = True
                        else:
                            marks.append((OIr, t + 1, i, v))
            pl = [bool(OIl[w, i, v]) or same_l[v] for v in (0, 1)]
            pr = [bool(OIr[w, i, v]) or same_r[v] for v in (0, 1)]
            GA[i + w, i] = [go * np.float32(x) for x in pl]
            GA[i, i + w] = [go * np.float32(x) for x in pr]
            for marked, vr, vl in ((any(pl), NC, HC), (any(pr), HC, NC)):
                if not marked:
                    continue
                sums = [Cr[t, i, vr] + Cl[w - 1 - t, i + 1 + t, vl] for t in range(w)]
                best = max(sums)
                for t in range(w):
                    if sums[t] == best:
                        marks += [(OCr, t, i, vr), (OCl, w - 1 - t, i + 1 + t, vl)]
        for X, width, start, v in marks:  # the barrier
            assert width < w
            X[width, start, v] = True
    GD[:n, RIGHT, :, STOP] = go * OCr[0, :n].astype(np.float32)
    GD[:n, LEFT, :, STOP] = go * OCl[0, :n].astype(np.float32)
    return _go_sums(GD, GA, n)


def _batch(lengths, n1, seed):
    rng = np.random.default_rng(seed)
    B, n = len(lengths), n1 - 1
    parts = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
             for s in ((B, n, 2, 2, 2), (B, n, n, 2), (B, n))]
    dec, attach = dmv_merge(*parts)
    return dec, attach, torch.tensor(lengths)


@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("lengths,n1", [((1, 0), 2), ((2, 1, 0), 3), ((4, 0, 3), 5),
                                        ((8, 1, 5, 0), 9), ((11, 6, 2), 12)])
def test_one_barrier_model_equals_the_plain_version(kind, lengths, n1):
    dec, attach, lens = _batch(lengths, n1, sum(lengths) + n1)
    total, charts = dmv_inside_charts_plain(dec, attach, lens, kind)
    gout = torch.arange(1, len(lengths) + 1, dtype=torch.float32) * 0.25
    g_dec, g_att = dmv_outside_plain(dec, attach, lens, gout, total, charts, kind)
    dtype = np.float32 if kind == "max" else np.float64
    for b, L in enumerate(lengths):
        d, a = dec[b].numpy().astype(dtype), attach[b].numpy().astype(dtype)
        got_total, C = inside_model(d, a, L, kind, dtype)
        want = charts[b].numpy()
        for c, name in enumerate(("Cr", "Cl", "Ir", "Il")):
            tri = _triangle(n1, L, 1 if name[0] == "I" else 0)
            if kind == "max":  # f32 sums in the kernels' order: bit-equal
                np.testing.assert_array_equal(C[name][tri], want[c][tri])
            else:
                np.testing.assert_allclose(C[name][tri], want[c][tri], rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got_total, float(total[b]), rtol=0 if kind == "max" else 1e-6,
                                   atol=0 if kind == "max" else 1e-5)
        # the outside pass on the plain charts, as the kernel reads them
        Cp = {name: want[c].astype(dtype) for c, name in enumerate(("Cr", "Cl", "Ir", "Il"))}
        go = float(gout[b])
        if kind == "max":
            gd, ga = outside_max_model(Cp, L, np.float32(go))
            np.testing.assert_array_equal(gd, g_dec[b].numpy())
            np.testing.assert_array_equal(ga, g_att[b].numpy())
        else:
            gd, ga = outside_log_model(d, a, Cp, L, go)
            np.testing.assert_allclose(gd, g_dec[b].numpy(), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(ga, g_att[b].numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# 3. The lane model of the warp mapping

def _butterfly(xs, op):
    """The xor-butterfly of ``group_max`` / ``group_sum`` over one group's
    lane values: every lane ends with the same value."""
    xs = list(xs)
    off = len(xs) >> 1
    while off:
        xs = [op(xs[g], xs[g ^ off]) for g in range(len(xs))]
        off >>= 1
    return xs[0]


def _lse_get(m, s, dtype):
    return m + np.log(s) if s > 0 else dtype(NEG)


def _lse_fold(m, s, x):
    mm = max(m, x)
    r = 0.0 if mm == -np.inf else mm
    return r + np.log((s * np.exp(m - r) if s > 0 else 0.0) + np.exp(x - r))


def inside_lanes_model(dec, att, L, kind, dtype, nt=32):
    """``inside_fill_1b`` lane by lane for one sentence on ``nt`` threads:
    cells not yet written hold NaN (a read ahead of the barrier poisons the
    result unless the kernel's select discards it, as it does the same-width
    cells); writes land at the width's barrier."""
    n1, n = dec.shape[0], L + 1
    ninf = dtype(-np.inf)
    C = {c: np.full((n1, n1, 2), np.nan, dtype) for c in ("Cr", "Cl", "Ir", "Il")}
    C["Cr"][0, :n] = dec[:n, RIGHT, :, STOP]
    C["Cl"][0, :n] = dec[:n, LEFT, :, STOP]
    Cr, Cl, Ir, Il = (C[c] for c in ("Cr", "Cl", "Ir", "Il"))
    for w in range(1, L + 1):
        ncell = n - w
        G = group_lanes(ncell, w, nt)
        assert ncell * G <= nt
        pending = []
        for i in range(ncell):
            def terms(t):
                lo, hi = t > 0, t < w - 1
                cl_nc, cr_nc = Cl[t, i, NC], Cr[w - 1 - t, i + 1 + t, NC]
                il, ir = Il[w - t, i + t], Ir[t + 1, i]
                return (Cr[t, i, NC] + Cl[w - 1 - t, i + 1 + t, HC],
                        Cr[t, i, HC] + Cl[w - 1 - t, i + 1 + t, NC],
                        *(il[v] + cl_nc if lo else ninf for v in (0, 1)),
                        *(ir[v] + cr_nc if hi else ninf for v in (0, 1)))
            lanes = [[terms(t) for t in range(gl, w, G)] for gl in range(G)]
            # six reductions: Il and Ir (w terms each), Cl[v] and Cr[v] (the
            # narrower terms)
            # np.maximum keeps a NaN (a read ahead of its barrier); the
            # kernel's fmaxf would drop it
            m = [_butterfly([np.max([ninf] + [x[k] for x in lane]) for lane in lanes],
                            np.maximum) for k in range(6)]
            al, ar = m[0], m[1]
            if kind == "log":
                # the sums of exp(term - reference): an empty one keeps 0
                ref = m[:2] + [dtype(0) if x == -np.inf else x for x in m[2:]]
                s = [_butterfly([sum((np.exp(x[k] - ref[k]) for x in lane), dtype(0))
                                 for lane in lanes], lambda a, b: a + b) for k in range(6)]
                al, ar = _lse_get(m[0], s[0], dtype), _lse_get(m[1], s[1], dtype)
            il = [al + (att[i + w, i, v] + dec[i + w, LEFT, v, GO]) for v in (0, 1)]
            ir = [ar + (att[i, i + w, v] + dec[i, RIGHT, v, GO]) for v in (0, 1)]
            # the same-width terms folded in last: Cl's split 0, Cr's split w - 1
            xl = [il[v] + Cl[0, i, NC] for v in (0, 1)]
            xr = [ir[v] + Cr[0, i + w, NC] for v in (0, 1)]
            if kind == "max":
                cl = [np.maximum(m[2 + v], xl[v]) for v in (0, 1)]
                cr = [np.maximum(m[4 + v], xr[v]) for v in (0, 1)]
            else:
                cl = [_lse_fold(m[2 + v], s[2 + v], xl[v]) for v in (0, 1)]
                cr = [_lse_fold(m[4 + v], s[4 + v], xr[v]) for v in (0, 1)]
            if i == 0 and w != L:
                cr = [NEG, NEG]  # single root
            pending += [(Il, i, il), (Ir, i, ir), (Cl, i, cl), (Cr, i, cr)]
        for X, i, val in pending:  # __syncwarp()
            X[w, i] = val
    return Cr[L, 0, NC], C


@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("n1", range(2, 10))
def test_warp_lane_model_equals_the_plain_version(kind, n1):
    lengths = sorted({n1 - 1, 0, 1, (n1 - 1) // 2, n1 - 2}, reverse=True)
    dec, attach, lens = _batch(lengths, n1, 100 + n1)
    total, charts = dmv_inside_charts_plain(dec, attach, lens, kind)
    dtype = np.float32 if kind == "max" else np.float64
    for b, L in enumerate(lengths):
        d, a = dec[b].numpy().astype(dtype), attach[b].numpy().astype(dtype)
        got_total, C = inside_lanes_model(d, a, L, kind, dtype)
        want = charts[b].numpy()
        for c, name in enumerate(("Cr", "Cl", "Ir", "Il")):
            tri = _triangle(n1, L, 1 if name[0] == "I" else 0)
            assert not np.isnan(C[name][tri]).any(), name
            if kind == "max":  # the fold changes no float sum: bit-equal
                np.testing.assert_array_equal(C[name][tri], want[c][tri])
            else:
                np.testing.assert_allclose(C[name][tri], want[c][tri], rtol=1e-5, atol=1e-5)
        if kind == "max":
            assert got_total == total[b].numpy()
        else:
            np.testing.assert_allclose(got_total, float(total[b]), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# 4. K1's composition

def k1_model(dec, att, L, kind, dtype):
    """K1 on one sentence: the inside pass, then the outside pass on the
    same charts in place, at a cotangent of one; ``(total, g_dec,
    g_attach)``."""
    total, C = inside_model(dec, att, L, kind, dtype)
    if kind == "max":
        gd, ga = outside_max_model(C, L, np.float32(1))
    else:
        gd, ga = outside_log_model(dec, att, C, L, 1.0, dtype)
    return total, gd, ga


@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("lengths,n1", [((1, 0), 2), ((0, 2, 1), 3), ((4, 1, 0, 3), 5),
                                        ((8, 0, 1, 5), 9), ((11, 1, 6, 0), 12),
                                        ((16, 0, 1, 9), 17)])
def test_k1_composition_equals_jax(kind, lengths, n1):
    dec, attach, lens = _batch(lengths, n1, 7 * n1 + len(lengths))
    want = [np.asarray(x) for x in dmv_value_and_grads_fast(
        jnp.asarray(dec.numpy()), jnp.asarray(attach.numpy()),
        jnp.asarray(lens.numpy(), jnp.int32), kind)]
    dtype = np.float32 if kind == "max" else np.float64
    for b, L in enumerate(lengths):
        d, a = dec[b].numpy().astype(dtype), attach[b].numpy().astype(dtype)
        got = k1_model(d, a, L, kind, dtype)
        assert not any(np.isnan(g).any() for g in got)
        for g, w in zip(got, (want[0][b], want[1][b], want[2][b])):
            if kind == "max":  # f32 sums in the same order, 0/1 indicators
                np.testing.assert_array_equal(np.asarray(g, np.float32), w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_k1_log_marginal_form_in_f32_at_n1_101_stays_within_k1s_tolerance():
    """The round-off of K1's log outside pass on the long-caption path
    (n1 = 101, 86-100 words): inside and outside in f32, the outside in its
    log-marginal form, whose values stay near 0 where the outside scores of
    the old form were as large as log Z; held against the plain version in
    f64 at K1's gradient tolerance on the card, and its total at K1's total
    tolerance."""
    lengths, n1 = (100, 87), 101
    dec, attach, lens = _batch(lengths, n1, 101)
    want = [x.numpy() for x in dmv_value_and_grads_plain(dec, attach, lens, "log",
                                                         torch.float64)]
    for b, L in enumerate(lengths):
        d, a = dec[b].numpy(), attach[b].numpy()
        total, gd, ga = k1_model(d, a, L, "log", np.float32)
        assert gd.dtype == ga.dtype == np.float32
        assert abs(float(total) - want[0][b]) <= 1e-3 + 1e-5 * abs(want[0][b])
        for g, w in ((gd, want[1][b]), (ga, want[2][b])):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=5e-4)
