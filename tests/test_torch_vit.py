"""The port's ``exp=vlgae_vit`` slice against vlgae_tpu.

The ViT backbone and :class:`VisViTPatchEncoder` against the flax modules
(``transformers``' ``FlaxViTModule``) on numpy-seeded pixels and weights,
at the narrow widths of ``tests/test_e2e.py::test_vlgae_vit_swap_e2e`` and
at the recipe's published 224/32/192/4/4/384 (f32, 1e-5 absolute on outputs
of order 1, different summation orders); ``patch_boxes``, ``PixelLoader``,
the ViT subtree of ``convert.py`` and ``load_vit_params`` equal to the
reference's (``.npz``, flax ``.msgpack`` through the port's own msgpack
reader, HF directories with ``pytorch_model.bin``, ``model.safetensors``
in f32, f16 and bf16, or ``flax_model.msgpack``); one warm-up and one joint step of the recipe at narrow widths
under ``tests/test_torch_train.py``'s tolerances (f32 and bf16); dev
predictions byte-identical at ``precision=32``; the frozen backbone out of
the optimizer and unchanged; the port's CLIs and patch-box helper feeding
``eval.py``.
"""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import synth_data
from test_torch_train import NO_DROPOUT, _check_step, _jax_pipeline
from vlgae_tpu_torch import convert
from vlgae_tpu_torch.models.vis_encoder import (ViTConfig, ViTModel, VisViTPatchEncoder,
                                                graft_vit_params, load_vit_params,
                                                patch_boxes)

REPO = Path(__file__).resolve().parent.parent
VIT_TOL = 1e-5
NARROW = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
              intermediate_size=32, image_size=32, patch_size=16)
RECIPE = dict(hidden_size=192, num_hidden_layers=4, num_attention_heads=4,
              intermediate_size=384, image_size=224, patch_size=32)


def _hf_config(dims):
    from transformers import ViTConfig as HFViTConfig

    return HFViTConfig(num_channels=3, **dims)


def _flax_vit(dims):
    from transformers.models.vit.modeling_flax_vit import FlaxViTModule

    return FlaxViTModule(_hf_config(dims), dtype=jnp.float32, add_pooling_layer=False)


def _random_tree(module, rng, *inputs):
    """Random params of a flax module: its init's kernels, and every other
    leaf (biases, LayerNorm scales, CLS, positions) drawn from ``rng`` so
    that none of them is 0 or 1."""
    params = module.init(jax.random.key(0), *inputs)["params"]
    flat = {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(params).items()}
    out = {}
    for k, v in flat.items():
        if not k.endswith("kernel"):
            v = (rng.standard_normal(v.shape) * 0.1 + k.endswith("scale")).astype(np.float32)
        out[k] = v
    return out


def _unflat(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


@pytest.mark.parametrize("dims", [NARROW, RECIPE], ids=["narrow", "recipe"])
def test_vit_backbone_matches_flax(dims):
    rng = np.random.default_rng(0)
    S = dims["image_size"]
    px = rng.standard_normal((2, S, S, 3)).astype(np.float32)
    module = _flax_vit(dims)
    flat = _random_tree(module, rng, jnp.asarray(px))
    want = np.asarray(module.apply({"params": _unflat(flat)}, pixel_values=jnp.asarray(px),
                                   deterministic=True).last_hidden_state)
    port = ViTModel(ViTConfig(**dims))
    port.load_state_dict(convert.flax_to_torch(flat, port), strict=True)
    with torch.no_grad():
        got = port(torch.tensor(px)).numpy()
    assert got.shape == (2, (S // dims["patch_size"]) ** 2 + 1, dims["hidden_size"])
    np.testing.assert_allclose(got, want, atol=VIT_TOL, rtol=0)


def test_patch_encoder_matches_flax_and_keeps_gradients_out_of_the_backbone():
    from vlgae_tpu.models.vis_encoder import VisViTPatchEncoder as FlaxEncoder

    rng = np.random.default_rng(1)
    px = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    flax_enc = FlaxEncoder(n_hidden=8, vit_config=_hf_config(NARROW))
    P = 4
    ti, tj = np.triu_indices(P)
    flat = _random_tree(flax_enc, rng, {"vis_pixels": jnp.asarray(px)})
    port = VisViTPatchEncoder(n_hidden=8, vit_config=ViTConfig(**NARROW))
    port.load_state_dict(convert.flax_to_torch(flat, port), strict=True)
    assert any(k.startswith("vit/embeddings/patch_embeddings") for k in flat)
    assert any(k.startswith("head/rel_fc") for k in flat)
    x = {"vis_pixels": torch.tensor(px, requires_grad=True)}
    for pairs in (None, (ti, tj)):
        want = flax_enc.apply({"params": _unflat(flat)}, {"vis_pixels": jnp.asarray(px)},
                              rel_pairs=pairs)
        tp = None if pairs is None else tuple(torch.as_tensor(p) for p in pairs)
        got = port(x, rel_pairs=tp)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                       atol=VIT_TOL, rtol=0, err_msg=k)
    sum(v.sum() for v in got.values()).backward()
    assert all(p.grad is None for p in port.vit.parameters())
    assert x["vis_pixels"].grad is None
    assert all(p.grad is not None for p in port.head.parameters())


@pytest.mark.parametrize("image_size,patch_size", [(224, 32), (32, 16), (224, 16), (100, 30)])
def test_patch_boxes_match_reference(image_size, patch_size):
    from vlgae_tpu.models.vis_encoder import patch_boxes as ref

    got, want = patch_boxes(image_size, patch_size), ref(image_size, patch_size)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("vit")
    synth_data.make_corpus(Path(root) / "vlparse", n_imgs=4, feat_dim=16, n_box=6,
                           len_range=(3, 9), image_size=32)
    return root


def test_pixel_loader_matches_reference(corpus):
    from vlgae_tpu.data.features import PixelLoader as RefLoader

    from vlgae_tpu_torch.data.features import PixelLoader

    imgs = Path(corpus) / "vlparse" / "imgs"
    ids = [100, 102, 200, 100]
    got = PixelLoader(imgs, 32, 16)(ids)
    want = RefLoader(imgs, 32, 16)(ids)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    with pytest.raises(ValueError, match="expected 16x16"):
        PixelLoader(imgs, 16, 8)(ids)


def test_convert_carries_the_patch_kernel_without_swapping_its_axes():
    """A flax Conv kernel is [kh, kw, in, out]; a plain ``.T`` would give
    [out, in, kw, kh], which a square patch does not show in the shapes."""
    rng = np.random.default_rng(2)
    module = _flax_vit(NARROW)
    flat = _random_tree(module, rng, jnp.zeros((1, 32, 32, 3), jnp.float32))
    key = "embeddings/patch_embeddings/projection/kernel"
    kernel = rng.standard_normal(flat[key].shape).astype(np.float32)
    assert not np.array_equal(kernel, kernel.transpose(1, 0, 2, 3))
    flat[key] = kernel
    port = ViTModel(ViTConfig(**NARROW))
    state = convert.flax_to_torch(flat, port)
    w = state["embeddings.patch_embeddings.projection.weight"].numpy()
    np.testing.assert_array_equal(w, kernel.transpose(3, 2, 0, 1))
    back = convert.torch_to_flax(state)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # the optimizer's regex paths name the kernel as flax does
    assert convert.torch_to_flax_key("vis_encoder.vit.embeddings.patch_embeddings."
                                     "projection.weight", 4).endswith("projection/kernel")


def _tree_flat(tree):
    return {"/".join(map(str, k)): np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree).items()}


def test_load_vit_params_matches_reference(tmp_path):
    from transformers import ViTModel as HFViTModel

    from vlgae_tpu.models.vis_encoder import load_vit_params as ref_load

    hf_cfg, cfg = _hf_config(NARROW), ViTConfig(**NARROW)
    flat = _random_tree(_flax_vit(NARROW), np.random.default_rng(3),
                        jnp.zeros((1, 32, 32, 3), jnp.float32))

    def same(path):
        got = convert.torch_to_flax(load_vit_params(str(path), cfg))
        want = _tree_flat(ref_load(str(path), hf_cfg))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)

    npz = tmp_path / "vit.npz"
    np.savez(npz, **flat)
    same(npz)
    wrapped = tmp_path / "vit_wrapped.npz"
    np.savez(wrapped, **{f"params/{k}": v for k, v in flat.items()})
    same(wrapped)
    # a HF checkpoint directory: config.json and a torch pytorch_model.bin
    torch.manual_seed(0)
    hf = HFViTModel(hf_cfg)
    ckdir = tmp_path / "hf"
    hf.save_pretrained(str(ckdir), safe_serialization=False)
    assert (ckdir / "pytorch_model.bin").exists()
    same(ckdir)
    loaded = load_vit_params(str(ckdir), cfg)
    torch.testing.assert_close(loaded["embeddings.patch_embeddings.projection.weight"],
                               hf.embeddings.patch_embeddings.projection.weight,
                               rtol=0, atol=0)
    # a ViTFor... head's checkpoint keeps the backbone under ``vit.``
    headed = tmp_path / "hf_headed"
    headed.mkdir()
    (headed / "config.json").write_bytes((ckdir / "config.json").read_bytes())
    torch.save({f"vit.{k}": v for k, v in hf.state_dict().items()},
               headed / "pytorch_model.bin")
    for k, v in load_vit_params(str(headed), cfg).items():
        torch.testing.assert_close(v, loaded[k], rtol=0, atol=0)

    # the reference's failures: dims, a misshapen and a missing tensor
    with pytest.raises(ValueError, match="hidden_size=16"):
        load_vit_params(str(ckdir), ViTConfig(**dict(NARROW, hidden_size=24)))
    bad = dict(flat, **{"embeddings/cls_token": np.zeros((1, 1, 24), np.float32)})
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match="cls_token has shape"):
        load_vit_params(str(tmp_path / "bad.npz"), cfg)
    partial = {k: v for k, v in flat.items() if k != "embeddings/cls_token"}
    np.savez(tmp_path / "partial.npz", **partial)
    with pytest.raises(ValueError, match="cls_token MISSING"):
        load_vit_params(str(tmp_path / "partial.npz"), cfg)
    # a flax .msgpack (bare and wrapped in params), read by the port's reader
    from flax import serialization

    for name, tree in (("vit.msgpack", _unflat(flat)),
                       ("vit_wrapped.msgpack", {"params": _unflat(flat)})):
        (tmp_path / name).write_bytes(serialization.msgpack_serialize(tree))
        same(tmp_path / name)
    # directories: model.safetensors only, flax_model.msgpack only
    st = tmp_path / "safetensors_only"
    hf.save_pretrained(str(st))
    assert sorted(p.name for p in st.iterdir()) == ["config.json", "model.safetensors"]
    same(st)
    for k, v in load_vit_params(str(st), cfg).items():
        torch.testing.assert_close(v, loaded[k], rtol=0, atol=0)
    fx = tmp_path / "flax_dir"
    from transformers import FlaxViTModel

    flax_vit = FlaxViTModel(hf_cfg, seed=1)
    flax_vit.save_pretrained(str(fx))
    assert (fx / "flax_model.msgpack").exists()
    same(fx)
    fx_st = tmp_path / "flax_safetensors"  # flax paths joined with "."
    flax_vit.save_pretrained(str(fx_st), safe_serialization=True)
    assert (fx_st / "model.safetensors").exists() and not (fx_st / "flax_model.msgpack").exists()
    same(fx_st)
    # safetensors.numpy files: f32 and f16 under the torch names, a bf16
    # file through safetensors.torch
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch

    for dtype in (np.float32, np.float16, "bf16"):
        d = tmp_path / f"st_{dtype if isinstance(dtype, str) else np.dtype(dtype).name}"
        d.mkdir()
        (d / "config.json").write_bytes((ckdir / "config.json").read_bytes())
        if dtype == "bf16":
            save_torch({k: v.to(torch.bfloat16).contiguous() for k, v in hf.state_dict().items()},
                       str(d / "model.safetensors"), metadata={"format": "pt"})
        else:
            save_file({k: v.numpy().astype(dtype) for k, v in hf.state_dict().items()},
                      str(d / "model.safetensors"), metadata={"format": "pt"})
        same(d)
    bare = tmp_path / "config_only"
    bare.mkdir()
    (bare / "config.json").write_bytes((ckdir / "config.json").read_bytes())
    with pytest.raises(ValueError, match="flax_model.msgpack, model.safetensors or "
                                         "pytorch_model.bin"):
        load_vit_params(str(bare), cfg)


def test_msgpack_reader_matches_flax(monkeypatch):
    """``utils/serialization.msgpack_restore`` against flax's on what
    ``msgpack_serialize`` writes: every msgpack width of maps, arrays,
    strings and integers, floats, booleans, nil, bytes, array leaves of
    several dtypes (bfloat16 widened to float32), numpy scalars, a complex
    number, and an array cut into chunks."""
    from flax import serialization

    from vlgae_tpu_torch.utils.serialization import msgpack_restore

    rng = np.random.default_rng(4)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 40, -1, -32, -33,
                 -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 40],
        "floats": [0.5, -1e300, float("inf")], "flags": [True, False, None],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
        "bytes": [b"", b"x" * 300, b"y" * 70000],
        "big_map": {f"k{i}": i for i in range(20)},
        "long_list": list(range(20)),
        "nested": {"a": {"b": {"c": np.arange(6, dtype=np.int64).reshape(2, 3)}}},
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f16": rng.standard_normal(5).astype(np.float16),
        "i8": np.arange(-3, 3, dtype=np.int8), "bool": np.array([True, False]),
        "empty": np.zeros((0, 2), np.float32), "scalar_array": np.array(2.5, np.float32),
        "bf16": jnp.asarray(rng.standard_normal((2, 3)), jnp.bfloat16),
        "np_scalar": np.float32(1.25), "complex": 1 + 2j,
    }
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree["chunked"] = rng.standard_normal((7, 9)).astype(np.float32)
    data = serialization.msgpack_serialize(tree)
    want, got = serialization.msgpack_restore(data), msgpack_restore(data)

    def same(g, w, path):
        if isinstance(w, dict):
            assert isinstance(g, dict) and sorted(g) == sorted(w), path
            for k in w:
                same(g[k], w[k], f"{path}/{k}")
        elif isinstance(w, (list, tuple)):
            assert len(g) == len(w), path
            for i, (a, b) in enumerate(zip(g, w)):
                same(a, b, f"{path}/{i}")
        elif isinstance(w, (np.ndarray, np.generic)) or hasattr(w, "dtype"):
            w = np.asarray(w)
            if w.dtype == jnp.bfloat16:
                w = w.astype(np.float32)
            assert np.asarray(g).dtype == w.dtype and np.shape(g) == w.shape, path
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            assert type(g) is type(w) and g == w, path

    same(got, want, "")
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data[:-3])


def test_graft_vit_params_needs_a_backbone():
    from vlgae_tpu_torch.models.vis_encoder import VisBoxRelSimpleEncoder

    enc = VisViTPatchEncoder(n_hidden=8, vit_config=ViTConfig(**NARROW))
    state = {k: torch.full_like(v, 0.5) for k, v in enc.vit.state_dict().items()}
    graft_vit_params(torch.nn.ModuleDict({"vis_encoder": enc}), state)
    assert all(bool((v == 0.5).all()) for v in enc.vit.state_dict().values())
    boxes = torch.nn.ModuleDict({"vis_encoder": VisBoxRelSimpleEncoder(4, 8)})
    with pytest.raises(ValueError, match="no parameters under vis_encoder/vit"):
        graft_vit_params(boxes, state)


def overrides(root, precision="32"):
    return [
        "exp=vlgae_vit", f"root={root}",
        f"datamodule.train_path={root}/vlparse/train",
        f"datamodule.train_init_path={root}/vlparse/init",
        f"datamodule.dev_path={root}/vlparse/val",
        f"datamodule.test_path={root}/vlparse/test",
        f"datamodule.sg_path={root}/vlparse/vlparse.json",
        "datamodule.vit_image_size=32", "datamodule.vit_patch_size=16",
        "datamodule.train_dataloader.batch_size=8",
        "datamodule.train_dataloader.num_bucket=1",
        "_hidden_size=32", "_match_hidden_size=16", "_rank=4",
        "vis_encoder.vit_hidden_size=16", "vis_encoder.vit_num_layers=1",
        "vis_encoder.vit_num_heads=2", "vis_encoder.vit_intermediate_size=32",
        f"trainer.precision={precision}", "model.init_epoch=1",
    ] + NO_DROPOUT


@pytest.fixture(scope="module")
def pair(corpus):
    return _jax_pipeline(corpus, overrides(corpus))


@pytest.mark.parametrize("init_phase", [True, False], ids=["warm-up", "joint"])
def test_one_step_matches_jax(pair, corpus, init_phase):
    jpipe, flat = pair
    assert any(k.startswith("params/vis_encoder/vit/") for k in flat)
    grads = _check_step(jpipe, flat, corpus, overrides(corpus), init_phase, 1e-5,
                        (1e-5, 1e-4), 2e-6)
    if not init_phase:  # the grounding loss reached the head, not the backbone
        assert np.abs(grads["vis_encoder/head/rel_fc/kernel"]).max() > 0
        assert all(not np.any(g) for k, g in grads.items()
                   if k.startswith("vis_encoder/vit/"))


def test_one_joint_step_matches_jax_bf16(corpus):
    """precision=bf16: the head's projections in bf16, the ViT in f32, the
    matching on K5/K6's plain versions against the Pallas kernel in
    interpret mode."""
    ovs = overrides(corpus, precision="bf16")
    jpipe, flat = _jax_pipeline(corpus, ovs, match_kernel="pallas")
    _check_step(jpipe, flat, corpus, ovs, False, 1e-3, (1e-3, 2e-2), 1e-4)


def test_prediction_files_identical(pair, corpus, tmp_path, monkeypatch):
    jpipe, flat = pair
    from vlgae_tpu_torch.predict import main

    weights = tmp_path / "weights.npz"
    np.savez(weights, **flat)
    jres, jout = jpipe.evaluate("dev")
    jpipe.write_predictions(str(tmp_path / "jax_dev.conll"), "dev", jout)
    monkeypatch.chdir(tmp_path)
    _, results = main(overrides(corpus) + [f"weights={weights}", "device=cpu",
                                           "name=port"])
    want = (tmp_path / "jax_dev.conll").read_bytes()
    assert want.count(b"\n\n") == len(jpipe.dm.datasets["dev"])
    assert (tmp_path / "port_dev.conll").read_bytes() == want
    for k, v in jres.items():
        np.testing.assert_allclose(results["dev"][k], v, rtol=1e-4, atol=1e-4, err_msg=k)


def test_frozen_vit_is_out_of_the_optimizer_and_unchanged(pair, corpus):
    from vlgae_tpu_torch.predict import build_datamodule, compose
    from vlgae_tpu_torch.training.factory import build_model
    from vlgae_tpu_torch.training.pipeline import Pipeline, init_params

    cfg = compose(overrides(corpus))
    dm = build_datamodule(cfg)
    model = build_model(cfg, dm)
    init_params(model, 0)
    pipe = Pipeline(model, dm, cfg, device="cpu")
    opt = pipe.setup_optimizer()
    vit = {id(p) for p in model.vis_encoder.vit.parameters()}
    assert vit and not vit & {id(p) for p in opt.params}
    assert {id(p) for p in model.vis_encoder.head.parameters()} <= {id(p) for p in opt.params}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pipe.train_epoch(0)
    pipe.train_epoch(1)
    after = model.state_dict()
    for k, v in before.items():
        if ".vit." in f".{k}":
            assert torch.equal(after[k], v), k
    assert not torch.equal(after["vis_encoder.head.rel_fc.weight"],
                           before["vis_encoder.head.rel_fc.weight"])


def test_cli_weights_and_patch_box_helper_feed_eval(corpus, tmp_path, monkeypatch):
    """``vis_encoder.vit_weights`` through the port's train CLI reaches the
    model and stays frozen; ``predict`` and the port's patch-box helper
    feed ``eval.py``, as in ``test_e2e.py::test_vlgae_vit_swap_e2e``."""
    import re

    from vlgae_tpu_torch import patch_roi_boxes, predict, train

    flat = _random_tree(_flax_vit(NARROW), np.random.default_rng(4),
                        jnp.zeros((1, 32, 32, 3), jnp.float32))
    npz = tmp_path / "vit.npz"
    np.savez(npz, **flat)
    monkeypatch.chdir(tmp_path)
    run = tmp_path / "run"
    pipe, test = train.main(overrides(corpus) + [
        "trainer.max_epochs=2", f"vis_encoder.vit_weights={npz}", f"workdir={run}",
        "init_seed=0", "device=cpu"])
    assert "uas" in test and "box/acc" in test
    ckpt = torch.load(run / "checkpoint" / "last.pt", map_location="cpu", weights_only=True)
    got = convert.torch_to_flax({k[len("vis_encoder.vit."):]: v
                                 for k, v in ckpt["model"].items()
                                 if k.startswith("vis_encoder.vit.")})
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    dev_pred = run / "dev.predict.txt"
    for line in dev_pred.read_text().split("\n\n")[0].splitlines():
        for align in line.split("\t")[4:]:
            assert all(0 <= int(m) < 4 for m in re.findall(r"\d+", align)), line

    vlparse = Path(corpus) / "vlparse"
    roi = tmp_path / "patch_roi_boxes.json"
    patch_roi_boxes.main(["--dataroot", str(vlparse), "--split", "val",
                          "--image-size", "32", "--patch-size", "16", "--out", str(roi)])
    sys.path.insert(0, str(REPO / "scripts"))
    import make_patch_roi_boxes

    ref_roi = tmp_path / "ref_roi_boxes.json"
    make_patch_roi_boxes.main(["--dataroot", str(vlparse), "--split", "val",
                               "--image-size", "32", "--patch-size", "16",
                               "--out", str(ref_roi)])
    assert roi.read_bytes() == ref_roi.read_bytes()
    assert len(json.loads(roi.read_text())["200"]) == 4

    _, results = predict.main([f"checkpoint={run / 'checkpoint' / 'last.pt'}",
                               "device=cpu", "name=port"])
    assert (tmp_path / "port_dev.conll").exists()
    sys.path.insert(0, str(REPO))
    import eval as eval_cli

    root = tmp_path / "scored"
    root.mkdir()
    for name in ("val.conll", "id_list", "vlparse.json"):
        src = vlparse / name
        if src.exists():
            os.symlink(src, root / name)
    (root / "dev_roi_boxes.json").write_bytes(roi.read_bytes())
    for f in (dev_pred, tmp_path / "port_dev.conll"):
        counts = eval_cli.main(["--file", str(f), "--dataroot", str(root)])
        assert counts["obj"][1] > 0
