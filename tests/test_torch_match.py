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


def _tie_heavy(A, V, B, Q, D, seed=3):
    """Operands in {-0.25, 0, 0.25} with a short contraction: most rows and
    columns have several equal maxima. Biases mask some cells, one whole
    image, one whole caption, one region of every image and one word of
    every caption, so whole rows and columns tie at exactly -1e9 or -2e9."""
    rng = np.random.default_rng(seed)
    vis = (rng.integers(-1, 2, (A, V, D)) * 0.25).astype(np.float32)
    txt = (rng.integers(-1, 2, (B, Q, D)) * 0.25).astype(np.float32)
    vb = np.where(rng.random((A, V)) < 0.3, -1e9, 0.0).astype(np.float32)
    tb = np.where(rng.random((B, Q)) < 0.3, -1e9, 0.0).astype(np.float32)
    vb[0, :] = -1e9
    vb[:, 1] = -1e9
    tb[1, :] = -1e9
    tb[:, 0] = -1e9
    return vis, txt, vb, tb


def _pallas_value_and_grads(vis, txt, vb, tb, wm, wmv):
    import jax

    def loss(v, t):
        m, mv = match_maxes_pallas(v, t, True, jnp.asarray(vb), jnp.asarray(tb))
        return jnp.sum(m * wm) + jnp.sum(mv * wmv), (m, mv)

    (_, (m, mv)), (dvis, dtxt) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(vis, jnp.bfloat16), jnp.asarray(txt, jnp.bfloat16))
    return (np.asarray(m), np.asarray(mv), np.asarray(dvis.astype(jnp.float32)),
            np.asarray(dtxt.astype(jnp.float32)))


@pytest.mark.parametrize("shape", [(3, 10, 4, 5, 2), (2, 37, 8, 21, 3), (4, 9, 16, 13, 1)])
def test_ties_and_whole_masked_rows_match_pallas_interpret(shape):
    """The first-winner contract the card's kernel is held to, pinned against
    vlgae_tpu: on inputs full of exact ties the plain version's values equal
    the Pallas kernel's, its indices name the first maximum (0 on a wholly
    masked row or column), and the gradient routed through those indices
    equals ``jax.grad`` of the Pallas kernel."""
    from vlgae_tpu_torch.ops.match import match_maxes_bwd_plain

    A, V, B, Q, D = shape
    vis, txt, vb, tb = _tie_heavy(*shape)
    rng = np.random.default_rng(5)
    wm = (rng.integers(-8, 9, (B, A, Q)) * 0.25).astype(np.float32)
    wmv = (rng.integers(-8, 9, (B, A, V)) * 0.25).astype(np.float32)
    want_m, want_mv, want_dvis, want_dtxt = _pallas_value_and_grads(vis, txt, vb, tb, wm, wmv)
    v, t, vbt, tbt = _torch_inputs(vis, txt, vb, tb)
    m, im, mv, imv = match_maxes_plain(v, t, vbt, tbt)
    np.testing.assert_array_equal(m.numpy(), want_m)
    np.testing.assert_array_equal(mv.numpy(), want_mv)
    att = (np.einsum("bqd,avd->baqv", txt, vis) + vb[None, :, None, :]
           + tb[:, None, :, None])
    # the inputs do tie: many cells share their row's maximum
    assert ((att == att.max(-1, keepdims=True)).sum(-1) > 1).mean() > 0.5
    np.testing.assert_array_equal(im.numpy(), att.argmax(-1))
    np.testing.assert_array_equal(imv.numpy(), att.argmax(-2))
    # wholly masked: image 0 and caption 1 tie everywhere, and give index 0
    assert int(im[:, 0].max()) == 0 and int(imv[1].max()) == 0
    assert float(m[:, 0].max()) <= -1e9 and float(mv[1].max()) <= -1e9
    dvis, dtxt = match_maxes_bwd_plain(v, t, im, imv, torch.from_numpy(wm),
                                       torch.from_numpy(wmv))
    np.testing.assert_array_equal(dvis.float().numpy(), want_dvis)
    np.testing.assert_array_equal(dtxt.float().numpy(), want_dtxt)
