"""The port's native det-feature packer (vlgae_tpu_torch/data/native_io.py
over vlgae_tpu_torch/csrc/vlgae_io.cpp) against vlgae_tpu.data.native_io.

Exact: the packer's arrays, the header shapes, the loaders' batches and a
VLParse training batch are equal bit for bit to the JAX package's on the
same files and seeds, f4 and f8 ``.npy`` files, ``sample`` below, at and
above the rows. The regression of the box sampling: at 36 boxes with
``sample=35`` (the datamodule's default) the port drew its boxes with
NumPy's ``choice`` where the JAX package's native packer draws them by
its ``mt19937_64`` shuffle, so the two trained on other boxes. A build
that fails raises (no NumPy fallback).
"""

from pathlib import Path

import numpy as np
import pytest

import synth_data
import test_torch_train as tt
from vlgae_tpu.data import native_io as jio
from vlgae_tpu_torch.data import native_io

N_FILES = 7


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``<id>.npy`` files of 36, 10 and 0 rows x 20 columns, f4 and f8."""
    root = tmp_path_factory.mktemp("feats")
    rng = np.random.default_rng(0)
    for i in range(N_FILES):
        rows = 0 if i == N_FILES - 1 else 36 if i % 3 else 10
        dtype = np.float64 if i % 2 else np.float32
        np.save(root / f"{i}.npy", rng.standard_normal((rows, 20)).astype(dtype))
    assert jio.native_available()
    return root


@pytest.mark.parametrize("sample", [0, 35, 36, 50])
@pytest.mark.parametrize("seed", [0, 12345, 2 ** 62 - 1])
def test_packer_matches_jax(files, sample, seed):
    paths = [files / f"{i}.npy" for i in range(N_FILES)]
    got = native_io.load_det_feats_batch(paths, 36, 16, sample, seed)
    want = jio.load_det_feats_batch(paths, 36, 16, sample, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # the drawn rows are distinct and sorted
    if 0 < sample < 36:
        for i in (1, 2, 4, 5):
            rows = [np.flatnonzero((np.load(paths[i]).astype(np.float32)[:, :16]
                                    == f).all(1))[0] for f in got[0][i, :sample]]
            assert rows == sorted(set(rows))


def test_npy_shape_matches_jax(files, tmp_path):
    for i in range(N_FILES):
        assert native_io.npy_shape(files / f"{i}.npy") == jio.npy_shape(files / f"{i}.npy")
    bad = tmp_path / "bad.npy"
    bad.write_bytes(b"not a numpy file")
    assert native_io.npy_shape(bad) is None and jio.npy_shape(bad) is None
    with pytest.raises(OSError, match="rc="):
        native_io.load_det_feats_batch([bad], 36, 16, 35, 0)


@pytest.mark.parametrize("sample", [35, 0])
def test_det_feature_loader_matches_jax_at_36_boxes(files, sample):
    """Three consecutive batches bit-equal, and the loaders' generators in
    the same state afterwards (one draw a batch)."""
    from vlgae_tpu.data.features import DetFeatureLoader as JLoader
    from vlgae_tpu_torch.data.features import DetFeatureLoader

    ids = [1, 2, 4, 5]
    port = DetFeatureLoader(files, sample=sample, pad_boxes=36, seed=0)
    ref = JLoader(files, sample=sample, pad_boxes=36, seed=0)
    for _ in range(3):
        got, want = port(ids), ref(ids)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert port.rng.integers(0, 2 ** 62) == ref.rng.integers(0, 2 ** 62)


def test_vlparse_train_batches_match_jax_at_36_boxes(tmp_path):
    """``exp=vlgae``'s datamodule at 36 boxes, ``sample_boxes=35``: the
    first two training batches of the port equal the JAX package's."""
    from vlgae_tpu.data import VLParseDataModule
    from vlgae_tpu.data.subword import HashSubwordTokenizer, attach_subwords
    from vlgae_tpu.utils.config import ConfigComposer, resolve
    from vlgae_tpu_torch.predict import build_datamodule, compose

    synth_data.make_corpus(Path(tmp_path) / "vlparse", n_imgs=4, feat_dim=16, n_box=36,
                           len_range=(3, 9))
    ovs = [o for o in tt.overrides(tmp_path) if not o.startswith(
        ("datamodule.pad_boxes", "datamodule.sample_boxes"))]
    ovs += ["datamodule.pad_boxes=36", "datamodule.sample_boxes=35"]
    cfg = resolve(ConfigComposer(str(tt.REPO / "configs")).compose("config_train", ovs))
    dm_cfg = dict(cfg["datamodule"])
    dm_cfg.pop("_target_")
    jdm = VLParseDataModule(**dm_cfg).setup()
    attach_subwords(jdm, HashSubwordTokenizer())
    dm = build_datamodule(compose(ovs))
    for (x, y), (jx, jy) in zip(list(dm.batches("train"))[:2], list(jdm.batches("train"))[:2]):
        assert x["vis_box_feat"].shape[1] == 36 and x["vis_box_mask"].sum(1).max() == 35
        for got, want in ((x, jx), (y, jy)):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_failed_build_raises(files, tmp_path, monkeypatch):
    """A compiler that cannot run, or that fails, raises with the command;
    the loader does not fall back to NumPy."""
    from vlgae_tpu_torch.data.features import DetFeatureLoader
    from vlgae_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CXX", str(tmp_path / "no" / "g++"))
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native_io, "_LIB", None)
    with pytest.raises(RuntimeError, match="no/g\\+\\+ -O3 -fPIC -shared -std=c\\+\\+17"):
        native_io.load_library()
    with pytest.raises(RuntimeError, match="cannot run"):
        DetFeatureLoader(files, sample=35, pad_boxes=36)([1, 2])
    monkeypatch.setattr(_build, "CXX", "false")
    with pytest.raises(RuntimeError, match="false -O3 .* failed \\(rc 1\\)"):
        native_io.load_library()
    assert native_io.load_library(build=False) is None
    assert not (tmp_path / "build" / "libvlgae_io.so").exists()
