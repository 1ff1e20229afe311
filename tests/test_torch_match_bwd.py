"""The port's matching backward (vlgae_tpu_torch.ops.match:
``match_maxes_bwd_plain`` and ``MatchMaxesFn`` on the CPU) against
``jax.value_and_grad`` of vlgae_tpu's Pallas kernel in interpret mode,
with bias operands, at the shapes of tests/test_match_pallas.py.

Operands and cotangents are bf16-exact quarter-integers, so every product
and every f32 sum is exact: values and gradients must be EQUAL. The CUDA
kernel K6 is held against the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlgae_tpu.ops.match_pallas import match_maxes_pallas
from vlgae_tpu_torch.ops import match
from vlgae_tpu_torch.ops.match import (MatchMaxesFn, match_maxes_bwd,
                                       match_maxes_bwd_plain, match_maxes_plain)

# (A, V, B, Q, D): tests/test_match_pallas.py's blocked-grid and bias shapes
SHAPES = [(2, 16, 4, 64, 7), (2, 37, 8, 101, 10), (3, 10, 12, 33, 7),
          (2, 9, 4, 130, 5), (3, 10, 4, 5, 7)]


def _inputs(A, V, B, Q, D, seed=0):
    rng = np.random.default_rng(seed + Q * 31 + B)
    vis = (rng.integers(-8, 9, (A, V, D)) * 0.25).astype(np.float32)
    txt = (rng.integers(-8, 9, (B, Q, D)) * 0.25).astype(np.float32)
    vb = np.where(rng.random((A, V)) < 0.3, -1e9, 0.0).astype(np.float32)
    tb = np.where(rng.random((B, Q)) < 0.3, -1e9, 0.0).astype(np.float32)
    wm = (rng.integers(-8, 9, (B, A, Q)) * 0.25).astype(np.float32)
    wmv = (rng.integers(-8, 9, (B, A, V)) * 0.25).astype(np.float32)
    return vis, txt, vb, tb, wm, wmv


def _jax_grads(vis, txt, vb, tb, wm, wmv):
    def loss(v, t):
        m, mv = match_maxes_pallas(v, t, True, jnp.asarray(vb), jnp.asarray(tb))
        return jnp.sum(m * wm) + jnp.sum(mv * wmv)

    _, (dvis, dtxt) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(vis, jnp.bfloat16), jnp.asarray(txt, jnp.bfloat16))
    return (np.asarray(dvis.astype(jnp.float32)),
            np.asarray(dtxt.astype(jnp.float32)))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_and_autograd_match_pallas_interpret(shape):
    vis, txt, vb, tb, wm, wmv = _inputs(*shape)
    want_dvis, want_dtxt = _jax_grads(vis, txt, vb, tb, wm, wmv)

    v = torch.from_numpy(vis).bfloat16()
    t = torch.from_numpy(txt).bfloat16()
    _, li, _, lvi = match_maxes_plain(v, t, torch.from_numpy(vb), torch.from_numpy(tb))
    dvis, dtxt = match_maxes_bwd_plain(v, t, li, lvi, torch.from_numpy(wm),
                                       torch.from_numpy(wmv))
    assert dvis.dtype == dtxt.dtype == torch.bfloat16
    np.testing.assert_array_equal(dvis.float().numpy(), want_dvis)
    np.testing.assert_array_equal(dtxt.float().numpy(), want_dtxt)

    # the autograd function, as the model calls it (f32 features cast to bf16)
    vf = torch.from_numpy(vis).requires_grad_(True)
    tf = torch.from_numpy(txt).requires_grad_(True)
    before = match.n_bwd_launches
    m, _, mv, _ = MatchMaxesFn.apply(vf.bfloat16(), tf.bfloat16(),
                                     torch.from_numpy(vb), torch.from_numpy(tb))
    (m * torch.from_numpy(wm)).sum().add((mv * torch.from_numpy(wmv)).sum()).backward()
    assert match.n_bwd_launches == before  # the CPU takes the plain version
    np.testing.assert_array_equal(vf.grad.numpy(), want_dvis)
    np.testing.assert_array_equal(tf.grad.numpy(), want_dtxt)


def test_weight_rounds_after_the_two_directions_add():
    """A cell that wins both directions gets bf16(dm + dmv), not
    bf16(dm) + bf16(dmv); these two f32 cotangents round differently."""
    vis = torch.ones(1, 1, 1, dtype=torch.bfloat16)
    txt = torch.ones(1, 1, 1, dtype=torch.bfloat16)
    idx = torch.zeros(1, 1, 1, dtype=torch.int32)
    dm = torch.full((1, 1, 1), float.fromhex("0x1.1de51cp+0"))
    dmv = torch.full((1, 1, 1), float.fromhex("-0x1.e92802p-9"))
    dvis, dtxt = match_maxes_bwd_plain(vis, txt, idx, idx, dm, dmv)
    assert float(dvis) == float(dtxt) == 1.109375  # bf16(1.11304...)
    separate = (dm.bfloat16().float() + dmv.bfloat16().float()).bfloat16()
    assert float(separate) == 1.1171875


def test_none_cotangent_is_zero_and_biases_get_no_gradient():
    vis, txt, vb, tb, wm, _ = _inputs(2, 9, 3, 6, 4)
    vf = torch.from_numpy(vis).requires_grad_(True)
    vbt = torch.from_numpy(vb).requires_grad_(True)
    m, li, mv, lvi = MatchMaxesFn.apply(vf.bfloat16(), torch.from_numpy(txt).bfloat16(),
                                        vbt, torch.from_numpy(tb))
    assert not li.requires_grad and not lvi.requires_grad
    (m * torch.from_numpy(wm)).sum().backward()  # logit_v unused: zero cotangent
    want, _ = match_maxes_bwd(torch.from_numpy(vis).bfloat16(),
                              torch.from_numpy(txt).bfloat16(), li, lvi,
                              torch.from_numpy(wm), torch.zeros(mv.shape))
    np.testing.assert_array_equal(vf.grad.numpy(), want.float().numpy())
    assert vbt.grad is None


def test_meta_tensors_are_refused():
    v = torch.zeros(1, 2, 3, dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        match_maxes_bwd(v, v, None, None, None, None)
