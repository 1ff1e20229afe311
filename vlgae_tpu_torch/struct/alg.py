"""Decode-time tree algorithms outside the semiring framework (host NumPy;
copied from vlgae_tpu/struct/alg.py).

First-order Eisner decoding on the card is
:class:`vlgae_tpu_torch.struct.DependencyCRF` (argmax = the gradient of the
max, no backtracking). This module holds the host decoders: first-order
Eisner with backtracking (a test oracle), second-order (sibling) Eisner,
the grandparent-factored log-partition, non-projective MST
(Chu-Liu/Edmonds, Tarjan's components) and the tree predicates. They run
at decode or IO time on small per-sentence inputs.
"""

from __future__ import annotations

import numpy as np

NEG = -1e18


def isprojective(heads) -> bool:
    """Projectivity check incl. partial annotation (ref: alg.py:287-319).

    ``heads``: 1-based head ids per word; ``-1`` = unannotated; 0 = root.
    """
    pairs = [(h, d) for d, h in enumerate(heads, 1) if h >= 0]
    for i, (hi, di) in enumerate(pairs):
        for hj, dj in pairs[i + 1:]:
            (li, ri), (lj, rj) = sorted([hi, di]), sorted([hj, dj])
            if li <= hj <= ri and hi == dj:
                return False
            if lj <= hi <= rj and hj == di:
                return False
            if (li < lj < ri or li < rj < ri) and (li - lj) * (ri - rj) > 0:
                return False
    return True


def istree(heads, proj=False, multiroot=False) -> bool:
    """Validity predicate for a head sequence (ref: deptree.py:325-378)."""
    n = len(heads)
    if any(h < 0 or h > n for h in heads):
        return False
    if sum(1 for h in heads if h == 0) == 0:
        return False
    if not multiroot and sum(1 for h in heads if h == 0) > 1:
        return False
    # reachability from root
    children = {}
    for d, h in enumerate(heads, 1):
        if h == d:
            return False
        children.setdefault(h, []).append(d)
    seen, stack = set(), [0]
    while stack:
        u = stack.pop()
        for v in children.get(u, []):
            if v in seen:
                return False
            seen.add(v)
            stack.append(v)
    if len(seen) != n:
        return False
    if proj and not isprojective(heads):
        return False
    return True


def eisner(scores, seq_len):
    """Batched first-order Eisner Viterbi with backtracking.

    ``scores``: [B, N1, N1] numpy, scores[b, h, c] head->child, root row 0.
    ``seq_len``: [B] word counts. Returns [B, N1] heads (position 0 pad).

    Host-side reference decoder (the accelerated path is
    ``DependencyCRF(scores, lengths).argmax_heads``), kept as an
    independent test oracle (ref: alg.py:9-69).
    """
    scores = np.asarray(scores, dtype=np.float64)
    B, N1, _ = scores.shape
    out = np.zeros((B, N1), dtype=np.int64)
    for b in range(B):
        n = int(seq_len[b])
        heads = _eisner_one(scores[b, : n + 1, : n + 1])
        out[b, 1 : n + 1] = heads[1:]
    return out


def _eisner_one(s):
    n1 = s.shape[0]
    I_ = np.full((n1, n1), NEG)
    C = np.full((n1, n1), NEG)
    pI = np.zeros((n1, n1), dtype=np.int64)
    pC = np.zeros((n1, n1), dtype=np.int64)
    np.fill_diagonal(C, 0.0)
    for w in range(1, n1):
        for i in range(n1 - w):
            j = i + w
            # incomplete
            cand = [C[i, r] + C[j, r + 1] for r in range(i, j)]
            r = int(np.argmax(cand))
            I_[j, i] = cand[r] + s[j, i]
            I_[i, j] = cand[r] + s[i, j]
            pI[j, i] = pI[i, j] = i + r
            # complete left: C[j, i] = max_r C[r, i] + I[j, r]
            cand = [C[r, i] + I_[j, r] for r in range(i, j)]
            r = int(np.argmax(cand))
            C[j, i] = cand[r]
            pC[j, i] = i + r
            # complete right: C[i, j] = max_r I[i, r] + C[r, j]
            cand = [I_[i, r] + C[r, j] for r in range(i + 1, j + 1)]
            r = int(np.argmax(cand))
            if i == 0 and j != n1 - 1:
                C[i, j] = NEG
            else:
                C[i, j] = cand[r]
            pC[i, j] = i + 1 + r

    heads = np.zeros(n1, dtype=np.int64)

    def backtrack(i, j, complete):
        if i == j:
            return
        if complete:
            r = pC[i, j]
            backtrack(i, r, False)
            backtrack(r, j, True)
        else:
            heads[j] = i
            r = pI[i, j]
            lo, hi = sorted((i, j))
            backtrack(lo, r, True)
            backtrack(hi, r + 1, True)

    backtrack(0, n1 - 1, True)
    return heads


def eisner2o(scores, seq_len):
    """Second-order (sibling) Eisner decoding (ref: alg.py:72-223).

    ``scores``: tuple (s_arc [B, N1, N1] (head->child... indexed
    s_arc[b, c, h]? -- we follow the reference convention: s_arc[b, d, h]
    scores head h for dependent d), s_sib [B, N1, N1, N1] with
    s_sib[b, d, h, s]). Returns [B, N1] heads.
    """
    s_arc, s_sib = scores
    s_arc = np.asarray(s_arc, dtype=np.float64)
    s_sib = np.asarray(s_sib, dtype=np.float64)
    B, N1, _ = s_arc.shape
    out = np.zeros((B, N1), dtype=np.int64)
    for b in range(B):
        n = int(seq_len[b])
        out[b, : n + 1] = _eisner2o_one(
            s_arc[b, : n + 1, : n + 1], s_sib[b, : n + 1, : n + 1, : n + 1]
        )
    return out


def _eisner2o_one(arc, sib):
    # arc[d, h]; sib[d, h, s]
    n1 = arc.shape[0]
    I_ = np.full((n1, n1), NEG)  # I[h, m]
    S = np.full((n1, n1), NEG)  # sibling span S[h, m]
    C = np.full((n1, n1), NEG)  # C[h, e]
    pI = np.zeros((n1, n1), dtype=np.int64)
    pS = np.zeros((n1, n1), dtype=np.int64)
    pC = np.zeros((n1, n1), dtype=np.int64)
    np.fill_diagonal(C, 0.0)
    for w in range(1, n1):
        for i in range(n1 - w):
            j = i + w
            # I(j -> i): either first child (C + C) or sibling chain
            best, br = NEG, -1
            cand0 = C[j, j] + C[i, j - 1]
            if cand0 > best:
                best, br = cand0, j  # marker: first-child
            for r in range(i + 1, j):
                v = I_[j, r] + S[r, i] + sib[i, j, r]
                if v > best:
                    best, br = v, r
            I_[j, i] = best + arc[i, j]
            pI[j, i] = br
            # I(i -> j)
            best, br = NEG, -1
            cand0 = C[i, i] + C[j, i + 1]
            if cand0 > best:
                best, br = cand0, i
            for r in range(i + 1, j):
                v = I_[i, r] + S[r, j] + sib[j, i, r]
                if v > best:
                    best, br = v, r
            I_[i, j] = best + arc[j, i]
            pI[i, j] = br
            # S(i, j) = S(j, i) = max_r C[i, r] + C[j, r+1]
            cand = [C[i, r] + C[j, r + 1] for r in range(i, j)]
            r = int(np.argmax(cand))
            S[i, j] = S[j, i] = cand[r]
            pS[i, j] = pS[j, i] = i + r
            # complete
            cand = [C[r, i] + I_[j, r] for r in range(i, j)]
            r = int(np.argmax(cand))
            C[j, i] = cand[r]
            pC[j, i] = i + r
            cand = [I_[i, r] + C[r, j] for r in range(i + 1, j + 1)]
            r = int(np.argmax(cand))
            C[i, j] = cand[r] if not (i == 0 and j != n1 - 1) else NEG
            pC[i, j] = i + 1 + r

    heads = np.zeros(n1, dtype=np.int64)

    def backtrack(i, j, flag):
        if i == j:
            return
        if flag == "c":
            r = pC[i, j]
            backtrack(i, r, "i")
            backtrack(r, j, "c")
        elif flag == "s":
            r = pS[i, j]
            lo, hi = sorted((i, j))
            backtrack(lo, r, "c")
            backtrack(hi, r + 1, "c")
        else:  # incomplete: args (h=i, d=j)
            heads[j] = i
            r = pI[i, j]
            if r == i:  # first-child case: C[h, h] + C[d, h -/+ 1]
                backtrack(j, i - 1 if j < i else i + 1, "c")
            else:  # sibling chain: I(h, r) + S(r, d)
                backtrack(i, r, "i")
                backtrack(r, j, "s")

    backtrack(0, n1 - 1, "c")
    return heads


def tarjan(heads):
    """Strongly connected components of a head graph (ref: alg.py:420-470)."""
    n = len(heads)
    index = [0]
    idx = [-1] * (n + 1)
    low = [0] * (n + 1)
    on = [False] * (n + 1)
    stack = []
    sccs = []
    graph = {}
    for d, h in enumerate(heads, 1):
        graph.setdefault(h, []).append(d)

    def strongconnect(v):
        idx[v] = low[v] = index[0]
        index[0] += 1
        stack.append(v)
        on[v] = True
        for w_ in graph.get(v, []):
            if idx[w_] == -1:
                strongconnect(w_)
                low[v] = min(low[v], low[w_])
            elif on[w_]:
                low[v] = min(low[v], idx[w_])
        if low[v] == idx[v]:
            comp = []
            while True:
                w_ = stack.pop()
                on[w_] = False
                comp.append(w_)
                if w_ == v:
                    break
            if len(comp) > 1:
                sccs.append(comp)

    for v in range(n + 1):
        if idx[v] == -1:
            strongconnect(v)
    return sccs


def chuliu_edmonds(s):
    """Maximum spanning arborescence (ref: alg.py:473-560).

    ``s``: [N1, N1] with s[h, c]; row/col 0 is the root. Returns heads
    (1-based) for positions 1..N1-1.
    """
    s = np.array(s, dtype=np.float64)
    n1 = s.shape[0]
    np.fill_diagonal(s, NEG)
    s[:, 0] = NEG
    return _cle_rec(s)[1:]


def _cle_rec(s):
    n1 = s.shape[0]
    heads = np.argmax(s, axis=0)
    heads[0] = 0
    cycles = _find_cycle(heads)
    if not cycles:
        return heads
    cycle = cycles[0]
    cyc = np.array(cycle)
    noncyc = np.array([i for i in range(n1) if i not in set(cycle)])
    cyc_scores = s[heads[cyc], cyc]
    cyc_total = cyc_scores.sum()
    # contracted graph
    m = len(noncyc)
    s2 = np.full((m + 1, m + 1), NEG)
    s2[:m, :m] = s[np.ix_(noncyc, noncyc)]
    # edges into the cycle: gain = s[h, c] - s[cycle_head[c], c]
    into = s[np.ix_(noncyc, cyc)] - cyc_scores[None, :]
    s2[:m, m] = into.max(1)
    best_into = into.argmax(1)
    # edges out of the cycle
    outof = s[np.ix_(cyc, noncyc)]
    s2[m, :m] = outof.max(0)
    best_out = outof.argmax(0)
    heads2 = _cle_rec(s2)
    heads_full = np.zeros(n1, dtype=np.int64)
    # map back
    for i2, i in enumerate(noncyc):
        h2 = heads2[i2]
        heads_full[i] = noncyc[h2] if h2 < m else cyc[best_out[i2]]
    # break the cycle at the entry point
    entry2 = heads2[m]
    entry = noncyc[entry2]
    entered = cyc[best_into[entry2]]
    for c in cycle:
        heads_full[c] = heads[c]
    heads_full[entered] = entry
    heads_full[0] = 0
    return heads_full


def _find_cycle(heads):
    n1 = len(heads)
    color = [0] * n1
    cycles = []
    for start in range(1, n1):
        if color[start]:
            continue
        path = []
        v = start
        while color[v] == 0:
            color[v] = 1
            path.append(v)
            v = int(heads[v])
            if v == 0:
                break
        if v != 0 and color[v] == 1 and v in path:
            cyc = path[path.index(v):]
            cycles.append(cyc)
        for u in path:
            color[u] = 2
    return cycles


def mst(scores, seq_len):
    """Batched non-projective MST decode (ref: alg.py:563-612)."""
    scores = np.asarray(scores, dtype=np.float64)
    B, N1, _ = scores.shape
    out = np.zeros((B, N1), dtype=np.int64)
    for b in range(B):
        n = int(seq_len[b])
        out[b, 1 : n + 1] = chuliu_edmonds(scores[b, : n + 1, : n + 1])
    return out


def eisner2o_grand(scores, lens):
    """Second-order grandparent-factored log-partition (ref: alg.py:226-284).

    ``scores``: (s_arc [B, N1, N1] with s_arc[b, d, h], s_grand
    [B, N1, N1, N1] with s_grand[b, g, p, c]). Each dependent ``v`` with
    parent ``p`` contributes grandparent factors for its outermost child
    in each direction (or itself when childless in that direction, via
    the width-0 ``c[h, h, h]`` sentinel). Returns logZ [B] over
    single-root projective trees.
    """
    s_arc, s_grand = scores
    s_arc = np.asarray(s_arc, dtype=np.float64)
    s_grand = np.asarray(s_grand, dtype=np.float64)
    B = s_arc.shape[0]
    out = np.zeros(B)
    for b in range(B):
        n1 = int(lens[b]) + 1
        out[b] = float(_grand_one(
            s_arc[b, :n1, :n1].T,  # -> s_a[h, d]
            s_grand[b, :n1, :n1, :n1],
        ))
    return out


def _lse(x, axis=None):
    m = np.max(x, axis=axis, keepdims=True)
    out = m + np.log(np.sum(np.exp(x - m), axis=axis, keepdims=True))
    return np.squeeze(out, axis=axis) if axis is not None else np.squeeze(out)


def _grand_one(s_a, s_g):
    n1 = s_a.shape[0]
    s_i = np.full((n1, n1), NEG)
    s_c = np.full((n1, n1, n1), NEG)  # [head, end, outermost-child]
    for i in range(n1):
        s_c[i, i, i] = 0.0
    for w in range(1, n1):
        for i in range(n1 - w):
            j = i + w
            # incomplete right: head i, dep j
            terms = [
                _lse(s_c[i, r]) + _lse(s_g[i, j] + s_c[j, r + 1])
                for r in range(i, j)
            ]
            s_i[i, j] = _lse(np.array(terms)) + s_a[i, j]
            # incomplete left: head j, dep i
            terms = [
                _lse(s_g[j, i] + s_c[i, r]) + _lse(s_c[j, r + 1])
                for r in range(i, j)
            ]
            s_i[j, i] = _lse(np.array(terms)) + s_a[j, i]
            # complete right: c(i, j, r) = i(i, r) + lse_k g(i,r,k)+c(r,j,k)
            for t in range(w):
                r = i + 1 + t
                s_c[i, j, r] = s_i[i, r] + _lse(s_g[i, r] + s_c[r, j])
            # complete left: c(j, i, r) = lse_k g(j,r,k)+c(r,i,k) + i(j, r)
            for t in range(w):
                r = i + t
                s_c[j, i, r] = _lse(s_g[j, r] + s_c[r, i]) + s_i[j, r]
            if i == 0 and w != n1 - 1:
                s_c[0, j, :] = NEG
    return _lse(s_c[0, n1 - 1])
