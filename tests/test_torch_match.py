"""The port's matching maxes (vlgae_tpu_torch.ops.match) against the
Pallas kernel of vlgae_tpu in interpret mode, with bias operands, at the
small shapes of tests/test_match_pallas.py. Inputs are bf16-exact
quarter-integers, so the f32 sums are exact and values must be equal;
indices must name a first maximal element. The CUDA kernel is tested on
the card by tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlgae_tpu.ops.match_pallas import match_maxes_pallas
from vlgae_tpu_torch.ops.match import match_maxes, match_maxes_plain

SHAPES = [(3, 10, 4, 5, 7), (2, 37, 8, 21, 16), (4, 9, 16, 13, 130)]


def _inputs(A, V, B, Q, D, seed=0):
    rng = np.random.default_rng(seed)
    vis = (rng.integers(-8, 9, (A, V, D)) * 0.25).astype(np.float32)
    txt = (rng.integers(-8, 9, (B, Q, D)) * 0.25).astype(np.float32)
    vb = np.where(rng.random((A, V)) < 0.3, -1e9, 0.0).astype(np.float32)
    tb = np.where(rng.random((B, Q)) < 0.3, -1e9, 0.0).astype(np.float32)
    return vis, txt, vb, tb


def _torch_inputs(vis, txt, vb, tb):
    return (torch.from_numpy(vis).bfloat16(), torch.from_numpy(txt).bfloat16(),
            torch.from_numpy(vb), torch.from_numpy(tb))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape):
    vis, txt, vb, tb = _inputs(*shape)
    want_m, want_mv = match_maxes_pallas(
        jnp.asarray(vis, jnp.bfloat16), jnp.asarray(txt, jnp.bfloat16), True,
        jnp.asarray(vb), jnp.asarray(tb))
    m, im, mv, imv = match_maxes(*_torch_inputs(vis, txt, vb, tb))
    np.testing.assert_array_equal(m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(want_mv))
    # indices: the first position holding the maximum
    att = (np.einsum("bqd,avd->baqv", txt, vis) + vb[None, :, None, :]
           + tb[:, None, :, None])
    np.testing.assert_array_equal(im.numpy(), att.argmax(-1))
    np.testing.assert_array_equal(imv.numpy(), att.argmax(-2))
    assert im.dtype == imv.dtype == torch.int32


def test_ties_go_to_the_smallest_index():
    vis = np.zeros((2, 6, 4), np.float32)
    txt = np.zeros((3, 5, 4), np.float32)
    zeros = np.zeros((2, 6), np.float32), np.zeros((3, 5), np.float32)
    _, im, _, imv = match_maxes_plain(*_torch_inputs(vis, txt, *zeros))
    assert int(im.max()) == 0 and int(imv.max()) == 0
