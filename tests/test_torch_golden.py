"""The port against the reference goldens of tests/golden/: ``dmv_ref.npz``
and ``deptree_ref.npz`` (the reference torch-struct fork's DMV and
Eisner CRF outputs on fixed potentials) and ``init_ref.npz`` (the
reference km_init/good_init tables), with the tolerances of
tests/test_golden_ref.py and tests/test_host_golden.py: merge exact;
totals 2e-5 relative; marginals and indicators 1e-4 relative + 1e-5
absolute; matrix-tree partition 1e-4 relative; init tables 1e-10
relative + 1e-12 absolute.

The DMV goldens go through the plain DP and through the dispatch
(``DMV1o``); the Eisner goldens through the plain fill and through
``DependencyCRF``'s route over the DMV DP. The file imports no JAX.
"""

import os

import numpy as np
import pytest
import torch

from vlgae_tpu_torch.models.dmv_init import good_init, km_init
from vlgae_tpu_torch.struct import (DependencyCRF, DMV1o, deptree_marginals,
                                    deptree_nonproj_marginals, deptree_nonproj_partition,
                                    deptree_partition, dmv_merge, dmv_total,
                                    dmv_value_and_grads_plain)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _load(name):
    with np.load(os.path.join(GOLDEN, name)) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def dmv_ref():
    d = _load("dmv_ref.npz")
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    t["lengths"] = t["lengths"].int()
    return d, t


@pytest.fixture(scope="module")
def deptree_ref():
    d = _load("deptree_ref.npz")
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    t["lengths"] = t["lengths"].int()
    return d, t


def test_dmv_merge_matches_reference(dmv_ref):
    d, t = dmv_ref
    mdec, mattach = dmv_merge(t["dec"], t["attach"], t["root"])
    np.testing.assert_array_equal(mdec.numpy(), d["merged_dec"])
    np.testing.assert_array_equal(mattach.numpy(), d["merged_attach"])


@pytest.mark.parametrize("kind", ["log", "max"])
def test_dmv_totals_and_tables_match_reference(dmv_ref, kind):
    d, t = dmv_ref
    total_key, table_key = ("partition", "marginals") if kind == "log" else ("max", "argmax")
    md, ma, lens = t["merged_dec"], t["merged_attach"], t["lengths"]
    np.testing.assert_allclose(dmv_total(md, ma, lens, kind).numpy(),
                               d[total_key].reshape(-1), rtol=2e-5)
    _, _, ga = dmv_value_and_grads_plain(md, ma, lens, kind)
    np.testing.assert_allclose(ga.numpy(), d[table_key], rtol=1e-4, atol=1e-5)
    dist = DMV1o((md, ma), lens)
    np.testing.assert_allclose((dist.partition if kind == "log" else dist.max).numpy(),
                               d[total_key].reshape(-1), rtol=2e-5)
    np.testing.assert_allclose((dist.marginals if kind == "log" else dist.argmax).numpy(),
                               d[table_key], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["log", "max"])
def test_deptree_matches_reference(deptree_ref, kind):
    d, t = deptree_ref
    total_key, table_key = ("partition", "marginals") if kind == "log" else ("max", "argmax")
    arc, lens = t["arc"], t["lengths"]
    np.testing.assert_allclose(deptree_partition(arc, lens, kind).numpy(),
                               d[total_key].reshape(-1), rtol=2e-5)
    np.testing.assert_allclose(deptree_marginals(arc, lens, kind).numpy(), d[table_key],
                               rtol=1e-4, atol=1e-5)
    crf = DependencyCRF(arc, lens)
    np.testing.assert_allclose((crf.partition if kind == "log" else crf.max).numpy(),
                               d[total_key].reshape(-1), rtol=2e-5)
    np.testing.assert_allclose((crf.marginals if kind == "log" else crf.argmax).numpy(),
                               d[table_key], rtol=1e-4, atol=1e-5)


def test_matrix_tree_matches_reference(deptree_ref):
    d, t = deptree_ref
    np.testing.assert_allclose(deptree_nonproj_partition(t["mtt_arc"]).numpy(),
                               d["mtt_partition"], rtol=1e-4)
    np.testing.assert_allclose(deptree_nonproj_marginals(t["mtt_arc"]).numpy(),
                               d["mtt_marginals"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("method", ["km", "good"])
def test_init_tables_match_reference(method):
    ref = _load("init_ref.npz")
    seq_len = ref["seq_len"]
    tokens = [ref["tokens"][i, :n].tolist() for i, n in enumerate(seq_len)]
    heads = [ref["heads"][i, :n].tolist() for i, n in enumerate(seq_len)]
    n_token, smooth = int(ref["n_token"]), float(ref["smooth"])
    if method == "km":
        tables = km_init(tokens, n_token, smooth)
    else:
        tables = good_init(tokens, heads, n_token, smooth)
    for got, name in zip(tables, ("dec", "trans", "root")):
        np.testing.assert_allclose(got, ref[f"{method}_{name}"], rtol=1e-10, atol=1e-12,
                                   err_msg=name)
