"""The joint phase's train step as CUDA graphs of its kernel-free stretches
(``vlgae_tpu_torch/training/graphs.py``).

On the CPU: the stretches' chain (a segment's backward by
``autograd.grad`` from its outputs' cotangents, the kernels between) gives
the eager step's loss, terms and gradients bit for bit, and the same
parameters after two Adam updates; Adam on device learning rates follows
the float path over 20 updates of the recipe's schedule; the graph keys
separate batches that differ in any keyed field; the configurations the
graphs do not cover keep the eager step. On the card (marked ``cuda``):
12 graphed steps over two batch shapes against the same steps run eagerly,
bit for bit, with every kernel argument kept (``chip_smoke.graphs_against_eager``).
"""

import sys
import types
from pathlib import Path

import pytest
import torch

import synth_data

REPO = Path(__file__).resolve().parent.parent


def _overrides(root, *extra):
    return [
        "exp=vlgae", f"root={root}",
        f"datamodule.train_path={root}/vlparse/train",
        f"datamodule.train_init_path={root}/vlparse/init",
        f"datamodule.dev_path={root}/vlparse/val",
        f"datamodule.test_path={root}/vlparse/test",
        f"datamodule.sg_path={root}/vlparse/vlparse.json",
        "datamodule.pad_boxes=6", "datamodule.sample_boxes=5",
        "datamodule.train_dataloader.batch_size=6",
        "datamodule.train_dataloader.num_bucket=2",
        "_hidden_size=32", "_match_hidden_size=16", "_rank=4",
        "vis_encoder.n_in=16", "vis_encoder.n_hidden=32",
        "trainer.precision=bf16", "model.init_epoch=0", *extra,
    ]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("graphs")
    synth_data.make_corpus(Path(root) / "vlparse", n_imgs=6, feat_dim=16, n_box=6,
                           len_range=(3, 12))
    return root


def _pipeline(root, *extra, device="cpu"):
    """A pipeline of the recipe at narrow widths (dropout on), its weights
    and dropout generator from fixed seeds."""
    from vlgae_tpu_torch.predict import build_datamodule, compose
    from vlgae_tpu_torch.training.factory import build_model
    from vlgae_tpu_torch.training.pipeline import Pipeline, init_params

    cfg = compose(_overrides(root, *extra))
    dm = build_datamodule(cfg)
    model = build_model(cfg, dm)
    init_params(model, 3)
    pipe = Pipeline(model, dm, cfg, device=device, workdir=str(root), seed=11)
    pipe.setup_optimizer()
    return pipe


def _batches(pipe):
    """The training epoch's batches, padded as ``train_epoch`` pads them."""
    from vlgae_tpu_torch.training.pipeline import pad_batch_pow2

    return [(pad_batch_pow2(x)[0], pad_batch_pow2(y)[0])
            for x, y in pipe.dm.batches("train", shuffle=False)]


def test_segmented_step_is_bit_equal_to_the_eager_step(corpus):
    """Three joint steps over two batch shapes, every dropout on: the
    chain of stretches (``StepGraphs`` without capture on the CPU) against
    ``Pipeline``'s eager step (one ``loss.backward()``): loss, terms and
    every gradient bit for bit, and, each side updated by the same float
    Adam, the same parameters after each update."""
    from vlgae_tpu_torch.parallel.mesh import shard_batch
    from vlgae_tpu_torch.training.graphs import StepGraphs

    eager, chain = _pipeline(corpus), _pipeline(corpus)
    graphs = StepGraphs(chain)
    batches = _batches(eager)
    first = batches[0][0]["token"].shape
    other = next(b for b in batches if b[0]["token"].shape != first)
    again = next(b for b in batches[1:] if b[0]["token"].shape == first)
    held = {id(p) for p in eager.optimizer.params}
    for step, (x, y) in enumerate([batches[0], other, again]):
        loss, terms = eager.grad_step(x, y, False, 0.5)
        chain.model.train()
        got, got_terms = graphs.grad_step(shard_batch(x, chain.dp), 0.5)
        assert torch.equal(got, loss)
        assert got_terms.keys() == terms.keys() and terms
        assert all(torch.equal(got_terms[k], terms[k]) for k in terms)
        for (name, p), q in zip(eager.model.named_parameters(), chain.model.parameters()):
            if id(p) in held:
                assert p.grad is not None and torch.equal(p.grad, q.grad), (step, name)
        eager.apply_step()
        chain.optimizer.sum_grads()
        chain.optimizer.update(chain.step)
        torch._foreach_zero_(graphs.grads)
        chain.step += 1
        if step >= 1:
            for (name, p), q in zip(eager.model.named_parameters(), chain.model.parameters()):
                assert torch.equal(p, q), (step, name)


def test_device_learning_rate_gives_the_float_paths_updates(corpus):
    """20 updates of the recipe's schedule (``optimize: linear``) and clip
    on the same gradients: ``update_on_device`` (Adam on a learning-rate
    tensor, bias corrections on the device) against ``update`` (a host
    float): parameters within f32 rounding (the same quantities rounded in
    another order) while they move by far more; the update counts equal."""
    a, b = _pipeline(corpus), _pipeline(corpus)
    assert "exponential" in a.cfg["scheduler"]["args"]["_target_"]
    b.optimizer.on_device()
    params_a, params_b = a.optimizer.params, b.optimizer.params
    start = [p.detach().clone() for p in params_a]
    gen = torch.Generator().manual_seed(0)
    for step in range(20):
        for p, q in zip(params_a, params_b):
            g = torch.randn(p.shape, generator=gen)
            p.grad, q.grad = g.clone(), g.clone()
        a.optimizer.update(step)
        b.optimizer.set_lr_on_device(step)
        b.optimizer.update_on_device()
        assert all(not q.grad.any() for q in params_b)  # zeroed in place
        a.optimizer.zero_grad()
    moved = max(float((p.detach() - s).abs().max()) for p, s in zip(params_a, start))
    gap = max(float((p - q).detach().abs().max()) for p, q in zip(params_a, params_b))
    assert moved > 1e-2 and gap < 1e-6, (moved, gap)
    for p, q in zip(params_a, params_b):
        sa, sb = a.optimizer.opt.state[p], b.optimizer.opt.state[q]
        assert float(sa["step"]) == float(sb["step"]) == 20
        torch.testing.assert_close(sb["exp_avg"], sa["exp_avg"], rtol=1e-6, atol=1e-7)


def _key_inputs(B=8, L=16, P=6):
    return {"token": torch.zeros(B, L, dtype=torch.long),
            "seq_len": torch.zeros(B, dtype=torch.long),
            "vis_box_mask": torch.zeros(B, P, dtype=torch.bool),
            "vis_box_feat": torch.zeros(B, P, 16),
            "subword": torch.zeros(B, 3 * L, dtype=torch.long)}


def test_graph_keys_separate_batches_that_differ_in_a_keyed_field():
    from vlgae_tpu_torch.training.graphs import graph_key

    def key(B=8, L=16, P=6, init_phase=False, alpha=0.5, S=None):
        inputs = _key_inputs(B, L, P)
        if S is not None:
            inputs["subword"] = torch.ones(B, S, dtype=torch.long)
        return graph_key(inputs, {"transformer": torch.zeros(B, L, 8)}, init_phase, alpha)

    base = key()
    # other values and another subword length (read by the eager frozen
    # encoder alone) share the key
    assert key(S=40) == base
    variants = [key(B=16), key(L=24), key(P=7), key(init_phase=True), key(alpha=0.25)]
    assert len({base, *variants}) == 6


def _as_config(pipe, **changes):
    """``pipe``'s attributes that ``graphs_apply`` reads, on the card."""
    ns = types.SimpleNamespace(**vars(pipe))
    ns.device = torch.device("cuda")
    for k, v in changes.items():
        setattr(ns, k, v)
    return ns


@pytest.mark.parametrize("case", ["cpu", "lang_only", "word", "word+alldep", "f32 matching",
                                  "data parallel", "fsdp", "init phase", "accumulation"])
def test_these_configurations_keep_the_eager_step(corpus, case):
    """Each path without a cell keeps the eager step; the recipe on the
    card takes the graphs."""
    from vlgae_tpu_torch.training.graphs import graphs_apply

    extra = {"word": ["model.language_factor_mode=word"],
             "word+alldep": ["model.language_factor_mode=word+alldep"],
             "f32 matching": ["trainer.precision=32"],
             "fsdp": ["trainer.fsdp=true"],
             "accumulation": ["trainer.accumulate_grad_batches=2"]}.get(case, [])
    pipe = _pipeline(corpus, *extra)
    assert graphs_apply(_as_config(_pipeline(corpus)))
    if case == "cpu":
        assert not graphs_apply(pipe) and pipe._step_graphs(False) is None
    elif case == "lang_only":  # the parser alone has no ``dependency``
        assert not graphs_apply(_as_config(pipe, is_joint=False))
    elif case in ("data parallel", "fsdp"):  # both run under a process group
        world = types.SimpleNamespace(**vars(pipe.world))
        world.group, world.world = object(), 2
        assert not graphs_apply(_as_config(pipe, world=world))
    elif case == "init phase":
        ns = _as_config(pipe, graphs=None, _graphable=True)
        assert type(pipe)._step_graphs(ns, True) is None
    else:
        assert not graphs_apply(_as_config(pipe))


@pytest.mark.cuda
def test_graphed_steps_equal_the_eager_stretches_on_the_card(corpus):
    """12 steps over two batch shapes (each key's eager step, its capture,
    then replays) against the same steps through the same stretches run
    eagerly: bit for bit, every K1/K5/K6 argument still holding its step's
    value after the later replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(REPO))
    import chip_smoke

    batches = []
    for x, y in _batches(_pipeline(corpus)):
        if all(x["token"].shape != b[0]["token"].shape for b in batches):
            batches.append((x, y))
    out = chip_smoke.graphs_against_eager(lambda: _pipeline(corpus, device="cuda"),
                                          batches[:2])
    assert out["counters"] == {"graph.capture": 2, "graph.replay": 10, "graph.eager": 2}
