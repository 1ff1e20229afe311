"""The port's spans and counters (``vlgae_tpu_torch.utils.trace``) on the
CPU: ``span`` is a no-op without a profiler; under ``torch.profiler`` one
batch of the data module and one ``Pipeline.train_step`` of ``exp=vlgae``
at narrow widths emit every ``vlgae.*`` span, nested by layer; the packer
and upload counters read the arrays' bytes; the kernels' launch counts are
views of the one registry."""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import synth_data
from vlgae_tpu_torch.utils import trace

# every span of the train step and of one batch, with the span it lies in
PARENT = {
    "vlgae.train_step": None,
    "vlgae.upload": "vlgae.train_step",
    "vlgae.forward": "vlgae.train_step",
    "vlgae.forward.visual": "vlgae.forward",
    "vlgae.forward.text": "vlgae.forward",
    "vlgae.forward.dmv": "vlgae.forward",
    "vlgae.forward.grounding": "vlgae.forward",
    "vlgae.loss": "vlgae.train_step",
    "vlgae.loss.dmv": "vlgae.loss",
    "vlgae.loss.grounding": "vlgae.loss",
    "vlgae.backward": "vlgae.train_step",
    "vlgae.optimizer": "vlgae.train_step",
    "vlgae.data.collate": None,
    "vlgae.data.pack": "vlgae.data.collate",
    "vlgae.data.pad": None,
}
LOADER_KEYS = ("vis_box_feat", "vis_box_mask", "vis_rel_mask", "vis_available",
               "vis_box_index")


def _overrides(root):
    return [
        "exp=vlgae", f"root={root}",
        f"datamodule.train_path={root}/vlparse/train",
        f"datamodule.train_init_path={root}/vlparse/init",
        f"datamodule.dev_path={root}/vlparse/val",
        f"datamodule.test_path={root}/vlparse/test",
        f"datamodule.sg_path={root}/vlparse/vlparse.json",
        "datamodule.pad_boxes=6", "datamodule.sample_boxes=5",
        "datamodule.train_dataloader.batch_size=6",
        "datamodule.train_dataloader.num_bucket=1",
        "_hidden_size=32", "_match_hidden_size=16", "_rank=4",
        "vis_encoder.n_in=16", "vis_encoder.n_hidden=32",
        "trainer.precision=32", "model.init_epoch=1",
    ]


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    from vlgae_tpu_torch.predict import build_datamodule, compose
    from vlgae_tpu_torch.training.factory import build_model
    from vlgae_tpu_torch.training.pipeline import Pipeline

    root = tmp_path_factory.mktemp("trace")
    synth_data.make_corpus(Path(root) / "vlparse", n_imgs=4, feat_dim=16, n_box=6,
                           len_range=(3, 9))
    cfg = compose(_overrides(root))
    dm = build_datamodule(cfg)
    pipe = Pipeline(build_model(cfg, dm), dm, cfg, device="cpu", workdir=str(root), seed=0)
    pipe.setup_optimizer()
    return pipe


def _padded_batch(pipe):
    from vlgae_tpu_torch.parallel.mesh import pad_batch_to_devices

    x, y = next(pipe.dm.batches("train"))
    return pad_batch_to_devices(x, 1, pow2=True)[0], pad_batch_to_devices(y, 1, pow2=True)[0]


def test_span_enters_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with trace.span("vlgae.train_step"), trace.span("vlgae.forward"):
        pass
    assert trace.span("vlgae.a") is trace.span("vlgae.b")


def test_train_step_and_one_batch_emit_every_span_nested_by_layer(pipe):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x, y = _padded_batch(pipe)
        loss, _ = pipe.train_step(x, y, False, 0.5)
    assert torch.isfinite(loss)
    spans = [e for e in prof.events() if e.name.startswith("vlgae.")]
    assert {e.name for e in spans} == set(PARENT)
    for e in spans:
        up = e.cpu_parent
        while up is not None and not up.name.startswith("vlgae."):
            up = up.cpu_parent
        assert (up.name if up is not None else None) == PARENT[e.name], e.name
    # the profiler's spans are gone once it stops
    assert trace.span("vlgae.x") is trace.span("vlgae.y")


def test_pack_counters_read_the_loaders_arrays(pipe):
    trace.reset("data.")
    # one collate (through batches() a producer thread may collate more ahead)
    x, y = next(pipe.dm._collated("train", pipe.dm.sampler("train")))
    c = trace.counters()
    B = len(x["seq_len"])
    want = sum(x[k].nbytes for k in LOADER_KEYS) + y["vis_box"].nbytes
    assert c["data.pack_images"] == B
    assert c["data.pack_bytes"] == want
    assert c["data.pack_us"] > 0
    again = pipe.dm._feat_loaders["train"](list(x["img_id"]))
    assert sum(v.nbytes for v in again.values()) == want


def test_upload_counts_the_batch_and_on_the_cpu_all_of_it_as_pageable(pipe):
    from vlgae_tpu_torch.parallel.mesh import shard_batch

    x, _ = _padded_batch(pipe)
    trace.reset("upload.")
    out = shard_batch(x, pipe.dp)
    c = trace.counters()
    want = sum(np.asarray(v).nbytes for v in x.values())
    assert c["upload.bytes"] == want == sum(t.nbytes for t in out.values())
    assert c["upload.pageable_bytes"] == want


def test_launch_count_views_read_the_registry():
    from vlgae_tpu_torch.ops import dmv_cuda, match

    dmv_cuda.reset_launch_counts()
    match.reset_launch_counts()
    assert dmv_cuda.launch_counts() == {
        "fused": 0, "fused_global": 0, "fused_split": 0,
        "inside": dict.fromkeys(dmv_cuda.MAPPINGS, 0),
        "inside_save": dict.fromkeys(dmv_cuda.MAPPINGS, 0),
        "outside": 0, "outside_global": 0}
    assert match.launch_counts() == {"fwd": 0, "fwd_by_q_chunks": {}, "bwd": 0,
                                     "sharded": 0}
    for name, n in (("dmv.fused", 2), ("dmv.fused_split", 1), ("dmv.inside.warp", 3),
                    ("dmv.inside_save.global", 1), ("dmv.outside", 4),
                    ("match.fwd", 5), ("match.fwd_q_chunks.25", 2),
                    ("match.fwd_q_chunks.1", 3), ("match.bwd", 1), ("upload.bytes", 7)):
        trace.count(name, n)
    c = dmv_cuda.launch_counts()
    assert (c["fused"], c["fused_split"], c["inside"]["warp"], c["inside_save"]["global"],
            c["outside"]) == (2, 1, 3, 1, 4)
    assert match.launch_counts() == {"fwd": 5, "fwd_by_q_chunks": {25: 2, 1: 3}, "bwd": 1,
                                     "sharded": 0}
    dmv_cuda.reset_launch_counts()
    assert dmv_cuda.launch_counts()["fused"] == 0
    assert match.launch_counts()["fwd"] == 5  # each view resets its own counters
    assert trace.counters()["upload.bytes"] >= 7
    match.reset_launch_counts()
    assert not [k for k in trace.counters() if k.startswith(("dmv.", "match."))]
