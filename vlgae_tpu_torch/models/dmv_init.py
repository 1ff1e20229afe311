"""DMV initialisers (counterpart of vlgae_tpu/models/dmv_init.py; host
NumPy):

* :func:`km_init`: the Klein-and-Manning harmonic soft-count tables of the
  classic DMV, with the first-child decision normalisation;
* :func:`good_init`: DMV tables recovered from head sequences;
* :func:`generate_rule_1o`: per-sentence rule-count targets of the neural
  DMV's ``init_method='y'`` warm-up.

Valence conventions match :mod:`vlgae_tpu_torch.struct.dmv`: HASCHILD=0,
NOCHILD=1, GO=0, STOP=1, LEFT=0, RIGHT=1; the farthest child in each
direction is generated with NOCHILD.
"""

from __future__ import annotations

import numpy as np

from ..struct.dmv import GO, HASCHILD, LEFT, NOCHILD, RIGHT, STOP


def _harmonic(n: int) -> float:
    """``1 + 1/2 + ... + 1/n`` (0 for n = 0), summed in that order."""
    total = 0.0
    for k in range(1, n + 1):
        total += 1.0 / k
    return total


def km_init(token_seqs, n_token: int, smooth: float):
    """Harmonic initializer from raw token-id sequences.

    Returns (dec [n,2,2,2], trans [n,n,2,2], root [n]) log-prob tables.
    """
    dec = np.zeros((n_token, 2, 2, 2))
    root = np.zeros((n_token,))
    trans = np.zeros((n_token, n_token, 2, 2))
    norm_counter = np.full(dec.shape, smooth)

    # group by length so the per-position loops vectorize over sentences
    by_len = {}
    for toks in token_seqs:
        by_len.setdefault(len(toks), []).append(toks)

    for word_num, group in sorted(by_len.items()):
        tok = np.asarray(group)  # [B, n]
        change = np.zeros((word_num, 2))
        np.add.at(root, tok, 1.0 / word_num)
        if word_num > 1:
            for child_i in range(word_num):
                child_sum = _harmonic(child_i) + _harmonic(word_num - child_i - 1)
                scale = (word_num - 1) / word_num / child_sum
                for head_i in range(word_num):
                    if child_i == head_i:
                        continue
                    direction = RIGHT if head_i <= child_i else LEFT
                    diff = scale / abs(head_i - child_i)
                    np.add.at(
                        trans, (tok[:, head_i], tok[:, child_i], direction),
                        diff,
                    )
                    change[head_i, direction] += diff
        _update_decision(change, norm_counter, tok, dec)

    trans += smooth
    dec += smooth
    root += smooth
    es = _first_child_update(norm_counter, dec)
    norm_counter *= 0.9 * es
    dec += norm_counter

    root /= root.sum()
    trans /= trans.sum(1, keepdims=True)
    dec /= dec.sum(3, keepdims=True)
    return np.log(dec), np.log(trans), np.log(root)


def _update_decision(change, norm_counter, tok, dec):
    """(ref: km_init.py:18-30)"""
    for i in range(tok.shape[1]):
        pos = tok[:, i]
        for d in (0, 1):
            if change[i, d] > 0:
                np.add.at(norm_counter, (pos, d, NOCHILD, GO), 1.0)
                np.add.at(norm_counter, (pos, d, HASCHILD, GO), -1.0)
                np.add.at(dec, (pos, d, HASCHILD, GO), change[i, d])
                np.add.at(norm_counter, (pos, d, NOCHILD, STOP), -1.0)
                np.add.at(norm_counter, (pos, d, HASCHILD, STOP), 1.0)
                np.add.at(dec, (pos, d, NOCHILD, STOP), 1.0)
            else:
                np.add.at(dec, (pos, d, NOCHILD, STOP), 1.0)


def _first_child_update(norm_counter, dec):
    """(ref: km_init.py:33-39)"""
    all_param = dec.flatten()
    all_norm = norm_counter.flatten()
    mask = (all_param <= 0) | (all_norm >= 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = -all_param / all_norm
    ratio[mask] = 1.0
    return np.min(ratio)


def recovery_valences(heads):
    """Per-position valences + head valences from a head sequence
    (ref: good_init.py:8-31). ``heads``: 1-based list."""
    n = len(heads)
    left_most = np.arange(n)
    right_most = np.arange(n)
    for idx, h in enumerate(heads):
        if h in (0, n + 1):
            continue
        h -= 1
        if idx < left_most[h]:
            left_most[h] = idx
        if idx > right_most[h]:
            right_most[h] = idx
    valences = np.empty((n, 2), dtype=np.int64)
    head_valences = np.empty(n, dtype=np.int64)
    for idx, h in enumerate(heads):
        h -= 1
        valences[idx, 0] = NOCHILD if left_most[idx] == idx else HASCHILD
        valences[idx, 1] = NOCHILD if right_most[idx] == idx else HASCHILD
        if h > idx:
            head_valences[idx] = NOCHILD if left_most[h] == idx else HASCHILD
        else:
            head_valences[idx] = NOCHILD if right_most[h] == idx else HASCHILD
    return valences, head_valences


def good_init(token_seqs, head_seqs, n_token: int, smooth: float):
    """Recover DMV tables from (gold-ish) trees (ref: good_init.py:34-103).

    Bit-pinned against the reference tables (tests/golden/init_ref.npz).
    NOTE the semantics differ from :func:`generate_rule_1o` on purpose:
    the batch initializer counts NO GO decision for root attachments
    (generate_rule_1o keeps good_init_nn's root-row quirk) and counts
    EVERY root-headed child in the root table (not just the first).
    """
    dec_counter = np.zeros((n_token, 2, 2, 2))
    trans_counter = np.zeros((n_token, n_token, 2, 2))
    root_counter = np.zeros((n_token,))

    for toks, heads in zip(token_seqs, head_seqs):
        toks = np.asarray(toks)
        heads = np.asarray(heads, np.int64)
        n = len(toks)
        valences, head_valences = recovery_valences(list(heads))
        child = np.arange(n)

        # STOP decisions of every token, per side (ref: good_init.py:67-68)
        np.add.at(dec_counter, (toks, LEFT, valences[:, 0], STOP), 1.0)
        np.add.at(dec_counter, (toks, RIGHT, valences[:, 1], STOP), 1.0)

        real = heads > 0
        np.add.at(root_counter, (toks[~real],), 1.0)

        h = heads[real] - 1
        c = child[real]
        d = (h < c).astype(np.int64)  # RIGHT = 1 (head left of child)
        hv = head_valences[real]
        np.add.at(dec_counter, (toks[h], d, hv, GO), 1.0)
        np.add.at(trans_counter, (toks[h], toks[c], d, hv), 1.0)

    root_counter += smooth
    root_param = np.log(root_counter / root_counter.sum())
    trans_counter += smooth
    trans_param = np.log(trans_counter / trans_counter.sum(1, keepdims=True))
    dec_counter += smooth
    dec_param = np.log(dec_counter / dec_counter.sum(3, keepdims=True))
    return dec_param, trans_param, root_param


def generate_rule_1o(heads):
    """Rule counts of one sentence from its 1-based heads (0 = root).

    Per-head outermost dependents define the GO valences; each token's own
    outermost flags define its STOP valences. A root-headed child reads and
    writes row ``-1`` (the last token's row), the reference's quirk, which
    numpy's negative indexing reproduces.

    Returns dict(dec_rule [n,2,2,2], attach_rule [n,n,2], root_rule [n]).
    """
    heads = np.asarray(heads, np.int64)
    n = heads.shape[0]
    child = np.arange(n)
    head = heads - 1  # -1 = attached to the root
    real = head >= 0
    is_left = child < head  # root-headed children fall to RIGHT

    decision = np.zeros((n, 2, 2, 2))
    attach = np.zeros((n, n, 2))
    root = np.zeros((n,))
    root[int(np.argmax(~real))] = 1

    # outermost dependent on each side of every head
    left_most = np.arange(n)
    right_most = np.arange(n)
    lm_sel = real & is_left
    rm_sel = real & ~is_left
    np.minimum.at(left_most, head[lm_sel], child[lm_sel])
    np.maximum.at(right_most, head[rm_sel], child[rm_sel])

    # GO decisions and attachments: NOCHILD iff the child is the head's
    # outermost dependent on that side
    most = np.where(is_left, left_most[head], right_most[head])
    val_go = np.where(most == child, NOCHILD, HASCHILD)
    d = np.where(is_left, LEFT, RIGHT)
    np.add.at(decision, (head, d, val_go, GO), 1.0)
    attach[head[real], child[real], val_go[real]] += 1.0

    # STOP decisions of every token, per side
    val_l = np.where(left_most == child, NOCHILD, HASCHILD)
    val_r = np.where(right_most == child, NOCHILD, HASCHILD)
    decision[child, LEFT, val_l, STOP] += 1.0
    decision[child, RIGHT, val_r, STOP] += 1.0
    return {"dec_rule": decision, "attach_rule": attach, "root_rule": root}
