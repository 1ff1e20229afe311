"""The port's exact_top_k against vlgae_tpu.ops.topk: values and indices
equal, including the tie order on the decode's -1e20 / -1e10 / -100
plateaus."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlgae_tpu.ops.topk import exact_top_k as jax_top_k
from vlgae_tpu_torch.ops.topk import exact_top_k


def _check(x, k):
    vw, iw = jax_top_k(jnp.asarray(x), k)
    vg, ig = exact_top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(vg.numpy(), np.asarray(vw))
    np.testing.assert_array_equal(ig.numpy(), np.asarray(iw))
    assert ig.dtype == torch.int32


@pytest.mark.parametrize("shape,k", [((7, 11, 703), 5), ((64,), 1), ((3, 5), 5)])
def test_random_matches(shape, k):
    _check(np.random.default_rng(0).standard_normal(shape).astype(np.float32), k)


def test_decode_plateaus_match():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 9, 40)).astype(np.float32)
    levels = np.array([-1e20, -1e10, -100.0, 0.5], np.float32)
    pick = rng.integers(0, 5, x.shape)
    x = np.where(pick < 4, levels[np.minimum(pick, 3)], x).astype(np.float32)
    x[0, 0] = -1e20  # a fully masked row
    x[1, 1, :3] = -np.inf
    _check(x, 5)


def test_validation():
    with pytest.raises(ValueError):
        exact_top_k(torch.zeros(3), 0)
    with pytest.raises(ValueError):
        exact_top_k(torch.zeros(3), 4)
    with pytest.raises(TypeError):
        exact_top_k(torch.zeros(3, dtype=torch.int32), 1)
