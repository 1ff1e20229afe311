"""Per-sentence rule-count targets of the ``init_method='y'`` warm-up
(counterpart of ``generate_rule_1o`` in vlgae_tpu/models/dmv_init.py;
host NumPy).

Valence conventions match :mod:`vlgae_tpu_torch.struct.dmv`: HASCHILD=0,
NOCHILD=1, GO=0, STOP=1, LEFT=0, RIGHT=1; the farthest child in each
direction is generated with NOCHILD.
"""

from __future__ import annotations

import numpy as np

from ..struct.dmv import GO, HASCHILD, LEFT, NOCHILD, RIGHT, STOP


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
