"""The data module's batch producer (``DataModule.batches`` with a feature
loader): a thread collates the batches after the first while the caller
works. Against the same module collating each batch when asked for
(``_collated``): the same batches bit for bit, the same sampler epochs and
box draws, also after a close at batch k and across a resume; a producer's
error at the consumer; no thread left behind; the counters of the batches
taken. ``DepDataModule`` and ``load_vis=False`` start no thread. The
``cuda`` test checks the page-locked batches and their upload on the card.
"""

import gc
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import synth_data
from vlgae_tpu_torch.data import DepDataModule, VLParseDataModule
from vlgae_tpu_torch.data.datamodule import PREFETCH
from vlgae_tpu_torch.utils import trace


def _kwargs(root, **kw):
    v = Path(root)
    return dict(dict(sg_path=str(v / "vlparse.json"), train_path=str(v / "train"),
                     train_init_path=str(v / "init"), dev_path=str(v / "val"),
                     test_path=str(v / "test"), num_lex=10,
                     train_dataloader={"batch_size": 6}, dev_dataloader={"batch_size": 4},
                     test_dataloader={"batch_size": 4}, pad_boxes=12, sample_boxes=5), **kw)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("prefetch")
    synth_data.make_corpus(root, n_imgs=8, feat_dim=16, n_box=10)
    return root


def _pair(root, **kw):
    """Two data modules of the same files: one driven through the producer,
    its twin through the collate alone."""
    return (VLParseDataModule(**_kwargs(root, **kw)).setup(),
            VLParseDataModule(**_kwargs(root, **kw)).setup())


def _inline(dm, name, shuffle=None):
    return dm._collated(name, dm.sampler(name, shuffle))


def _producers():
    return {t for t in threading.enumerate() if t.name.startswith("vlgae-prefetch")}


@pytest.fixture
def no_producer_left():
    """A check that every producer thread started since the test began has
    ended within a second."""
    before = _producers()

    def check(seconds=1.0):
        end = time.monotonic() + seconds
        while _producers() - before and time.monotonic() < end:
            time.sleep(0.01)
        return not _producers() - before
    return check


def _assert_same(got, want):
    assert len(got) == len(want)
    for (x, y), (wx, wy) in zip(got, want):
        for a, b in ((x, wx), (y, wy)):
            assert a.keys() == b.keys()
            for k in b:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_same_state(a, b):
    assert a["sampler_epoch"] == b["sampler_epoch"]
    assert a["loader_rng"] == b["loader_rng"]


@pytest.mark.parametrize("sample_boxes", [5, 0])
def test_prefetched_batches_equal_the_inline_path(corpus, sample_boxes, no_producer_left):
    dm, twin = _pair(corpus, sample_boxes=sample_boxes)
    for _ in range(2):  # two shuffled epochs: the sampler's epoch and the box draws advance
        got = list(dm.batches("train"))
        assert len(got) == len(dm.sampler("train")) > 3
        _assert_same(got, list(_inline(twin, "train")))
        _assert_same_state(dm.train_state(), twin.train_state())
    _assert_same(list(dm.batches("dev", shuffle=False)), list(_inline(twin, "dev", False)))
    assert no_producer_left()


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("how", ["close", "drop"])
def test_a_close_at_batch_k_puts_the_draws_back_to_the_batches_taken(corpus, k, how,
                                                                      no_producer_left):
    dm, twin = _pair(corpus)
    gen, ref = dm.batches("train"), _inline(twin, "train")
    got = [next(gen) for _ in range(k)]
    _assert_same(got, [next(ref) for _ in range(k)])
    time.sleep(0.05)  # the producer runs ahead and blocks on the full queue
    live = dm.train_state()  # while the producer is ahead: the state of the batches taken
    _assert_same_state(live, twin.train_state())
    if how == "close":
        gen.close()
    else:
        del gen
    ref.close()
    assert no_producer_left(0)  # stopped and joined by the close
    _assert_same_state(dm.train_state(), twin.train_state())
    # the next epoch draws what the inline path draws, and so does a resume
    resumed = VLParseDataModule(**_kwargs(corpus)).setup()
    resumed.load_train_state(live)
    want = list(_inline(twin, "train"))
    _assert_same(list(dm.batches("train")), want)
    _assert_same(list(resumed.batches("train")), want)


def test_a_generator_in_a_cycle_stops_its_producer_when_collected(corpus, no_producer_left):
    dm = VLParseDataModule(**_kwargs(corpus)).setup()
    holder = {"gen": dm.batches("train")}
    holder["self"] = holder
    next(holder["gen"])
    assert not no_producer_left(0)
    del holder
    gc.collect()
    assert no_producer_left()


def test_a_close_on_the_producer_thread_puts_the_draws_back_as_it_stops(corpus,
                                                                        no_producer_left):
    """A generator in a cycle can be collected by a collection that runs on
    its producer's thread, in the middle of a collate. Here its close runs
    there: the producer draws the boxes of the batch it collates after the
    close, and must still leave the draws of the batches taken."""
    dm, twin = _pair(corpus)
    collate, go, closed, held = dm.collate, threading.Event(), threading.Event(), []
    on_producer = []

    def collate_then_close(name, insts, pad_len):
        if threading.current_thread().name.startswith("vlgae-prefetch"):
            on_producer.append(1)
            if len(on_producer) == 2:  # batch 3, while the caller holds batch 2
                assert go.wait(10)
                held.pop().close()  # the consumer's finally, on this thread
                closed.set()
        return collate(name, insts, pad_len)

    dm.collate = collate_then_close
    gen = dm.batches("train")
    ref = _inline(twin, "train")
    held.append(gen)
    _assert_same([next(gen) for _ in range(2)], [next(ref) for _ in range(2)])
    ref.close()
    go.set()
    assert closed.wait(10)
    assert no_producer_left()
    del dm.collate
    _assert_same_state(dm.train_state(), twin.train_state())
    _assert_same(list(dm.batches("train")), list(_inline(twin, "train")))


def test_live_producers_at_exit_end_quietly(corpus):
    """A process that exits with a producer still ahead (one held, one in a
    cycle) ends at once, with nothing on stderr."""
    repo = Path(__file__).resolve().parent.parent
    script = f"""
import sys
sys.path.insert(0, {str(repo)!r})
from vlgae_tpu_torch.data import VLParseDataModule
dm = VLParseDataModule(**{_kwargs(corpus)!r}).setup()
held = dm.batches("train")
next(held)
cycle = {{"gen": dm.batches("dev", shuffle=False)}}
cycle["self"] = cycle
next(cycle["gen"])
"""
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, cwd=repo)
    assert done.returncode == 0 and done.stderr == "", done.stderr


def test_a_missing_feature_file_raises_oserror_at_the_consumer(tmp_path, no_producer_left):
    root = tmp_path / "vlparse"
    synth_data.make_corpus(root, n_imgs=8, feat_dim=16, n_box=10)
    dm = VLParseDataModule(**_kwargs(root)).setup()
    order = [x["img_id"] for x, _ in _inline(dm, "dev", False)]
    # the first batch after the first that holds an image no earlier batch holds
    j, gone = next((j, int(i)) for j in range(1, len(order)) for i in order[j]
                   if i not in np.concatenate(order[:j]))
    (root / "det_feats" / f"{gone}.npy").unlink()
    gen = dm.batches("dev", shuffle=False)
    for want in order[:j]:
        np.testing.assert_array_equal(next(gen)[0]["img_id"], want)
    with pytest.raises(OSError):
        next(gen)
    assert no_producer_left()


def test_the_counters_count_the_batches_taken_and_collated(corpus):
    dm = VLParseDataModule(**_kwargs(corpus)).setup()
    trace.reset("data.")
    got = list(dm.batches("train"))
    c = trace.counters()
    assert c.get("data.prefetch_ready", 0) + c["data.prefetch_waited"] == len(got)
    assert c["data.prefetch_waited"] >= 1  # the first batch of an epoch
    # the pack's counters count the batches collated, on either thread
    assert c["data.pack_images"] == sum(len(x["seq_len"]) for x, _ in got)
    assert c["data.pack_us"] > 0
    # a close: taken counted as taken, and up to PREFETCH + 1 more collated
    trace.reset("data.")
    gen = dm.batches("train")
    taken = [next(gen) for _ in range(2)]
    time.sleep(0.05)
    gen.close()
    c = trace.counters()
    assert c.get("data.prefetch_ready", 0) + c["data.prefetch_waited"] == 2
    n_taken = sum(len(x["seq_len"]) for x, _ in taken)
    batch = dm.train_dataloader_cfg["batch_size"]
    assert n_taken <= c["data.pack_images"] <= n_taken + (PREFETCH + 1) * batch


@pytest.mark.parametrize("kind", ["dep", "lang_only"])
def test_without_a_feature_loader_no_thread_starts(corpus, kind, no_producer_left):
    if kind == "dep":
        v = Path(corpus)
        loader = {"batch_size": 6}
        dm = DepDataModule(train_path=str(v / "train.conll"), dev_path=str(v / "val.conll"),
                           train_dataloader=loader, dev_dataloader=loader).setup()
    else:
        dm = VLParseDataModule(load_vis=False, **_kwargs(corpus)).setup()
    trace.reset("data.")
    n = 0
    for _ in dm.batches("train"):
        assert no_producer_left(0)
        n += 1
    assert n > 1
    c = trace.counters()
    assert c.get("data.prefetch_ready", 0) == c.get("data.prefetch_waited", 0) == 0


def test_count_is_exact_under_threads():
    trace.reset("test.")
    n_threads, n = 8, 5000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [trace.count("test.n") for _ in range(n)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert trace.counters()["test.n"] == n_threads * n
    trace.reset("test.")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_producer_batches_are_pinned_and_upload_as_a_synchronous_copy(corpus, cuda):
    from vlgae_tpu_torch.parallel.mesh import DataGroup, pad_batch_to_devices, shard_batch
    from vlgae_tpu_torch.utils.pinned import is_pinned

    dm = VLParseDataModule(**_kwargs(corpus)).setup()
    dp = DataGroup(0, 1, None, cuda)
    gen = dm.batches("train")
    next(gen)
    x, _ = next(gen)  # collated on the producer's thread
    assert is_pinned(x["vis_box_feat"])
    xp, _ = pad_batch_to_devices(x, 1, pow2=True)
    assert is_pinned(xp["vis_box_feat"])
    trace.reset("upload.")
    got = shard_batch(xp, dp)
    torch.cuda.synchronize()
    assert trace.counters()["upload.pageable_bytes"] == sum(
        v.nbytes for v in xp.values() if not is_pinned(v))
    for k, v in xp.items():
        want = torch.as_tensor(np.array(v)).to(cuda)
        assert torch.equal(got[k], want), k
    gen.close()
