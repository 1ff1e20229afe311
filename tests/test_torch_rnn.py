"""The port's BiLSTM encoder against the flax module of vlgae_tpu.

Inputs and lengths come from a numpy seed; the flax parameters are carried
over through ``vlgae_tpu_torch.convert`` (the gate projections keep their
flax names, so the mapping is mechanical). Eval mode: ``x`` and ``hiddens``
within 1e-5 on ragged batches with a one-word sentence and a zero-length
padding row, for 1 and 2 layers and both init versions. Training mode: the
shapes of the keep masks the encoder asks for, and their scaling, by
formula.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vlgae_tpu.models import RNNEncoder as FlaxRNNEncoder
from vlgae_tpu_torch import convert
from vlgae_tpu_torch.models.text_encoder import RNNEncoder

TOL = 1e-5
B, L, D, H = 5, 7, 6, 4
LENGTHS = (7, 1, 0, 4, 3)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = np.arange(L)[None, :] < np.asarray(LENGTHS)[:, None]
    return emb, mask


def _pair(num_layers, init_version="zy", **kw):
    emb, mask = _inputs()
    fenc = FlaxRNNEncoder(hidden_size=H, num_layers=num_layers,
                          init_version=init_version, **kw)
    params = fenc.init(jax.random.key(1), jnp.asarray(emb), jnp.asarray(mask))
    flat = {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(params).items()}
    tenc = RNNEncoder(D, hidden_size=H, num_layers=num_layers,
                      init_version=init_version, **kw)
    tenc.load_state_dict(convert.flax_to_torch(flat, tenc), strict=True)
    return fenc, params, tenc.eval(), emb, mask


@pytest.mark.parametrize("init_version", ["zy", "biased"])
@pytest.mark.parametrize("num_layers", [1, 2])
def test_eval_forward_matches_flax(num_layers, init_version):
    fenc, params, tenc, emb, mask = _pair(num_layers, init_version)
    want = fenc.apply(params, jnp.asarray(emb), jnp.asarray(mask), deterministic=True)
    with torch.no_grad():
        got = tenc(torch.from_numpy(emb), torch.from_numpy(mask))
    assert tuple(got["x"].shape) == (B, L, 2 * H)
    assert tuple(got["hiddens"].shape) == (2, B, H)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got["hiddens"].numpy(), np.asarray(want["hiddens"]),
                               atol=TOL, rtol=TOL)
    # padded steps emit zeros; the zero-length row emits nothing at all
    assert float(got["x"][1, 1:].abs().max()) == 0.0
    assert float(got["x"][2].abs().max()) == 0.0
    assert float(got["hiddens"][:, 2].abs().max()) == 0.0


def test_gradient_matches_flax():
    fenc, params, tenc, emb, mask = _pair(2)
    w = np.random.default_rng(3).standard_normal((B, L, 2 * H)).astype(np.float32)

    def loss(p, e):
        out = fenc.apply(p, e, jnp.asarray(mask), deterministic=True)
        return jnp.sum(out["x"] * w) + jnp.sum(out["hiddens"])

    gp, ge = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(emb))
    e = torch.from_numpy(emb).requires_grad_(True)
    out = tenc(e, torch.from_numpy(mask))
    ((out["x"] * torch.from_numpy(w)).sum() + out["hiddens"].sum()).backward()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), atol=1e-5, rtol=1e-4)
    got = convert.torch_to_flax({n: p.grad for n, p in tenc.named_parameters()})
    want = {"/".join(k[1:]): np.asarray(v)
            for k, v in traverse_util.flatten_dict(gp).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4, err_msg=k)


def test_init_versions():
    g = torch.Generator().manual_seed(0)
    enc = RNNEncoder(D, hidden_size=H, num_layers=2, init_version="zy")
    enc.reset_parameters(g)
    for name, p in enc.named_parameters():
        if name.endswith("bias"):
            assert float(p.detach().abs().max()) == 0.0
        else:  # orthogonal: rows or columns are orthonormal
            w = p.detach()
            eye = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
            torch.testing.assert_close(eye, torch.eye(eye.shape[0]), atol=1e-5, rtol=0)
    enc = RNNEncoder(D, hidden_size=H, num_layers=1, init_version="biased")
    enc.reset_parameters(g)
    gates = enc.fwd_0.cell.OptimizedLSTMCell_0
    assert float(gates.hf.bias.detach().min()) == 1.0
    assert float(gates.hi.bias.detach().abs().max()) == 0.0
    bound = (6.0 / (D + H)) ** 0.5
    assert float(gates.ii.weight.detach().abs().max()) <= bound
    with pytest.raises(ValueError):
        RNNEncoder(D, init_version="other")
    with pytest.raises(NotImplementedError):  # as in vlgae_tpu
        RNNEncoder(D, proj_size=4)


def test_dropout_masks_shapes_and_scaling(monkeypatch):
    """Training mode with every keep mask all ones: the masks asked for have
    the shapes of the JAX package's draws, and each scales by 1 / (1 - p):
    the recurrent mask multiplies h on its way into the cell (the same as
    recurrent kernels divided by 1 - p), the output masks the output."""
    p_rec, p_post, p_shared = 0.25, 0.2, 0.5
    _, _, tenc, emb, mask = _pair(2, lstm_dropout=p_rec, post_dropout=p_post,
                                  post_shared_dropout=p_shared, pre_dropout=0.1,
                                  pre_shared_dropout=0.1)
    asked = []

    def ones(self, shape, p, like):
        asked.append((tuple(shape), p))
        return torch.ones(shape)

    for m in tenc.modules():
        if hasattr(m, "keep_mask"):
            monkeypatch.setattr(type(m), "keep_mask", ones)
    e, mk = torch.from_numpy(emb), torch.from_numpy(mask)
    with torch.no_grad():
        got = tenc.train()(e, mk)
    assert asked == [
        ((B, L, D), 0.1), ((B, 1, D), 0.1),           # input: element-wise, shared
        ((B, H), p_rec), ((B, H), p_rec),             # layer 0, both directions
        ((B, 1, 2 * H), p_rec),                       # between the layers
        ((B, H), p_rec), ((B, H), p_rec),             # layer 1
        ((B, L, 2 * H), p_post), ((B, 1, 2 * H), p_shared)]
    # the same function in eval mode, with the scalings written into it
    with torch.no_grad():
        for name, p in tenc.named_parameters():
            gate = name.split(".")[-2]
            if gate.startswith("h") and name.endswith("weight"):
                p.div_(1 - p_rec)
        x = e / (1 - 0.1) / (1 - 0.1)
        want = tenc.eval()
        l0 = torch.cat([want.fwd_0(x, mk), want.bwd_0(x, mk)], -1) / (1 - p_rec)
        l1 = torch.cat([want.fwd_1(l0, mk), want.bwd_1(l0, mk)], -1)
    torch.testing.assert_close(got["x"], l1 / (1 - p_post) / (1 - p_shared),
                               atol=1e-6, rtol=1e-5)


def test_training_without_a_generator_raises():
    _, _, tenc, emb, mask = _pair(1, lstm_dropout=0.3)
    with pytest.raises(RuntimeError, match="generator"):
        tenc.train()(torch.from_numpy(emb), torch.from_numpy(mask))
