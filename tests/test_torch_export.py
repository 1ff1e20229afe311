"""Serving export of the port (vlgae_tpu_torch/training/export.py) against
the eager forward and against vlgae_tpu's ``export_forward`` /
``load_forward``, and the kernels' custom ops.

The LDNDMV parser of ``tests/test_checkpoint.py``'s export test and a
small ``DependencyBoxRel`` (``exp=vlgae`` at the widths of
``tests/test_torch_train.py``), the JAX package's weights carried over by
``convert.py``: the loaded program's ``merged_dec`` / ``merged_attach`` equal
the port's eager forward within 1e-6 (bit-equal is expected: the program is
the same operations), and the JAX package's exported forward on the same
weights within 1e-5 (the JAX test's tolerance). Each custom op
(``vlgae::dmv_fused``, ``dmv_inside``, ``dmv_inside_save``, ``dmv_outside``,
``match_maxes``, ``match_maxes_bwd``) passes ``torch.library.opcheck`` on
CPU inputs: its fake implementation's shapes and dtypes are those of the
CPU implementation (the plain version), and it returns fresh tensors.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

import test_torch_train as tt
from test_models import N_TAG, N_TOKEN, N_WORD, build_ldndmv, make_inputs
from vlgae_tpu_torch import convert

KEYS = ("merged_dec", "merged_attach")


def _close(got, want, tol, what):
    for k in KEYS:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=tol,
                                   atol=tol, err_msg=f"{what}: {k}")


def _port_ldndmv(flat):
    from vlgae_tpu_torch.models.embedding import CompositeEmbedding, EmbeddingItemCfg
    from vlgae_tpu_torch.models.ldndmv import DiscriminativeNDMV, LDNDMVConfig
    from vlgae_tpu_torch.models.text_encoder import MLPEncoder

    emb = CompositeEmbedding((
        EmbeddingItemCfg("word_embedding", "word", "static", n_vocab=N_WORD, embedding_dim=16),
        EmbeddingItemCfg("tag_embedding", "tag", "static", n_vocab=N_TAG, embedding_dim=8)))
    cfg = LDNDMVConfig(context_mode="mean", hidden_size=24, attach_rank=4, dec_rank=4,
                       root_rank=4, root_emb_dim=6, dec_emb_dim=6)
    model = DiscriminativeNDMV(cfg, emb, MLPEncoder(emb.embed_size, 24), 24,
                               token2word=tuple(i % N_WORD for i in range(N_TOKEN)),
                               token2tag=tuple(i % N_TAG for i in range(N_TOKEN)))
    model.load_state_dict(convert.flax_to_torch(flat, model), strict=True)
    return model


def _roundtrip(model, inputs, path):
    """(bytes, loaded program's outputs, eager outputs) of the port."""
    from vlgae_tpu_torch.training.export import export_forward, load_forward

    size = export_forward(model, inputs, str(path))
    tin = {k: torch.as_tensor(np.asarray(v)) for k, v in inputs.items()}
    with torch.no_grad():
        got = load_forward(str(path))(tin)
        model.eval()
        want = model(tin)
    return size, got, want


def test_ldndmv_export_roundtrip_matches_eager_and_jax(tmp_path):
    from vlgae_tpu.training.export import export_forward, load_forward

    inputs = make_inputs(np.random.default_rng(0))
    jmodel = build_ldndmv()
    params = jax.jit(jmodel.init)(jax.random.key(0), inputs)
    jpath = str(tmp_path / "fwd.stablehlo")
    assert export_forward(jmodel, params, inputs, jpath, platforms=("cpu",)) > 1000
    jax_out = load_forward(jpath)(dict(inputs))
    flat = {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params["params"])).items()}
    size, got, want = _roundtrip(_port_ldndmv(flat), inputs, tmp_path / "fwd.pt2")
    assert size > 1000
    assert sorted(got) == sorted(KEYS)
    _close(got, want, 1e-6, "eager")
    _close(got, jax_out, 1e-5, "JAX export")


@pytest.fixture(scope="module")
def joint(tmp_path_factory):
    """The JAX pipeline of the small ``exp=vlgae`` model, its params and a
    dev batch padded as both packages pad it."""
    import synth_data

    root = tmp_path_factory.mktemp("export")
    synth_data.make_corpus(Path(root) / "vlparse", n_imgs=4, feat_dim=16, n_box=6,
                           len_range=(3, 9))
    jpipe, flat = tt._jax_pipeline(root, tt.overrides(root))
    x, _ = tt._batch(jpipe.dm, "dev", False)
    return root, jpipe, flat, x


def test_joint_export_roundtrip_matches_eager_and_jax(joint, tmp_path):
    """``DependencyBoxRel``: the forward reaches K1 (``lang_feat_max_tree``,
    log and max) through ``vlgae::dmv_fused``, which the program keeps."""
    from vlgae_tpu.training.export import export_forward, load_forward

    root, jpipe, flat, x = joint
    jpath = str(tmp_path / "joint.stablehlo")
    params = jax.device_get(jpipe.state.params)
    export_forward(jpipe.model, params, x, jpath, platforms=("cpu",))
    jax_out = load_forward(jpath)(dict(x))
    pipe = tt._port_pipeline(root, tt.overrides(root), flat)
    size, got, want = _roundtrip(pipe.model, x, tmp_path / "joint.pt2")
    assert size > 1000
    _close(got, want, 1e-6, "eager")
    _close(got, jax_out, 1e-5, "JAX export")
    program = torch.export.load(str(tmp_path / "joint.pt2"))
    ops = [str(n.target) for n in program.graph.nodes if "vlgae" in str(n.target)]
    assert ops.count("vlgae.dmv_fused.default") == 2, ops


def test_joint_export_under_bf16_keeps_the_matching_op(joint, tmp_path):
    """``precision=bf16``: the matching maxes of ``gather_logit_train`` go
    through ``vlgae::match_maxes`` (K5 on the card), and the program's
    scores equal the eager forward's."""
    root, _, flat, x = joint
    pipe = tt._port_pipeline(root, tt.overrides(root, precision="bf16"), flat)
    _, got, want = _roundtrip(pipe.model, x, tmp_path / "bf16.pt2")
    _close(got, want, 1e-6, "eager bf16")
    program = torch.export.load(str(tmp_path / "bf16.pt2"))
    ops = {str(n.target) for n in program.graph.nodes}
    assert {"vlgae.match_maxes.default", "vlgae.dmv_fused.default"} <= ops


def _dmv_args(kind):
    from vlgae_tpu_torch.struct import dmv_merge

    rng = np.random.default_rng(0)
    B, n = 3, 5
    draw = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)  # noqa: E731
    dec, attach = dmv_merge(draw(B, n, 2, 2, 2), draw(B, n, n, 2), draw(B, n))
    return dec, attach, torch.tensor([5, 3, 1], dtype=torch.int32), kind


def _match_args():
    rng = np.random.default_rng(1)
    A, V, B, Q, D = 3, 7, 2, 5, 8
    bf = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16)  # noqa: E731
    vb = torch.tensor(np.where(rng.random((A, V)) < 0.2, -1e9, 0.0), dtype=torch.float32)
    tb = torch.tensor(np.where(rng.random((B, Q)) < 0.2, -1e9, 0.0), dtype=torch.float32)
    return bf(A, V, D), bf(B, Q, D), vb, tb


def _cases():
    from vlgae_tpu_torch.ops import dmv_cuda, match

    cases = []
    for kind in ("log", "max"):
        args = _dmv_args(kind)
        cases += [(dmv_cuda.dmv_fused, args), (dmv_cuda.dmv_inside, args),
                  (dmv_cuda.dmv_inside_save, args)]
        total, charts = dmv_cuda.dmv_inside_save(*args)
        gout = torch.tensor([1.0, 0.5, -2.0])
        cases.append((dmv_cuda.dmv_outside, (*args[:3], gout, total, charts, kind)))
    vis, txt, vb, tb = _match_args()
    cases.append((match._match_maxes_op, (vis, txt, vb, tb)))
    _, li, _, lvi = match.match_maxes(vis, txt, vb, tb)
    dm = torch.randn(li.shape, generator=torch.Generator().manual_seed(2))
    dmv = torch.randn(lvi.shape, generator=torch.Generator().manual_seed(3))
    cases.append((match._match_maxes_bwd_op, (vis, txt, li, lvi, dm, dmv)))
    return cases


@pytest.mark.parametrize("index", range(10))
def test_custom_op_passes_opcheck_on_the_cpu(index):
    op, args = _cases()[index]
    names = {"dmv_fused", "dmv_inside", "dmv_inside_save", "dmv_outside", "match_maxes",
             "match_maxes_bwd"}
    assert op._qualname.split("::")[1] in names and op._qualname.startswith("vlgae::")
    torch.library.opcheck(op, args)
    # the fake implementation's outputs are the CPU implementation's shapes
    from torch._subclasses.fake_tensor import FakeTensorMode

    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if torch.is_tensor(a) else a for a in args))
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(t.shape, t.dtype) for t in fake] == [(t.shape, t.dtype) for t in real]
