"""The granite-4.0-h caption encoder (``models/granite_hybrid.py``), K7's
plain version (``ops/moe.py``) and the benchmark's plain reference of the
encoder (``perfbench/reference/granite_hybrid.py``), on the CPU at tiny
widths (hidden 64, one attention layer between two Mamba2 layers, 8 experts
of 32, top-3, a shared expert of 48).

- the port against the reference on seeded weights: in f32 (1e-5) and with
  bf16 weights at the bf16 rounding points (the same choices, 2e-3 of the
  largest entry: the two sum in other orders, which moves a bf16 rounding
  now and then); the chunked SSD form (chunks of 4) against the reference's
  recurrence;
- the reference against transformers' ``GraniteMoeHybridModel`` (its torch
  path, eager attention) with the same weights, all experts held (1e-5), and
  the port's states against its ``hidden_states``;
- the expert shares: four layers that hold two experts each, summed with the
  shared expert counted once, give the uncut layer;
- K7's plain version against a loop over positions and slots, padding
  skipped;
- the tie rule of the benchmark's family on constructed near-ties;
- ``model_type`` selecting the encoder, and a train step and a predict
  through the CLIs with a granite directory.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import synth_data
from perfbench.core import compare
from perfbench.families import vlgae_granite
from perfbench.reference import granite_hybrid as ref
from vlgae_tpu_torch.models.embedding import BertConfig, encoder_config_from_dir
from vlgae_tpu_torch.models.granite_hybrid import GraniteConfig, GraniteHybrid
from vlgae_tpu_torch.ops import moe

TINY = dict(model_type="granitemoehybrid", vocab_size=50, hidden_size=64,
            num_hidden_layers=3, layer_types=["mamba", "attention", "mamba"],
            num_attention_heads=4, num_key_value_heads=2, attention_multiplier=0.125,
            mamba_n_heads=4, mamba_d_head=32, mamba_d_state=16, mamba_n_groups=1,
            mamba_d_conv=4, mamba_expand=2, mamba_chunk_size=256, mamba_conv_bias=True,
            mamba_proj_bias=False, num_local_experts=8, num_experts_per_tok=3,
            intermediate_size=32, shared_intermediate_size=48, embedding_multiplier=12.0,
            residual_multiplier=0.22, rms_norm_eps=1e-5, position_embedding_type="nope",
            hidden_act="silu", normalization_function="rmsnorm", max_position_embeddings=512,
            attention_bias=False, tie_word_embeddings=True)


def weights(c, seed=0):
    """Seeded f32 weights by the reference's names: matrices N(0, 0.1), the
    router N(0, 0.5), norms 1 + N(0, 0.1), dt_bias -2 + N(0, 0.5), A_log
    N(0, 0.5), D 1 + N(0, 0.1), the conv's bias N(0, 0.1)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in sorted(ref.param_shapes(c).items()):
        x = torch.randn(shape, generator=g)
        leaf = name.rsplit(".", 2)
        if name.endswith("norm.weight") or name.endswith(".D"):
            x = 1 + 0.1 * x
        elif name.endswith("dt_bias"):
            x = -2 + 0.5 * x
        elif name.endswith("A_log") or "router" in leaf[-2]:
            x = 0.5 * x
        else:
            x = 0.1 * x
        out[name] = x
    return out


def port(c, W, dtype=torch.float32):
    m = GraniteHybrid(GraniteConfig.from_dict(c), dtype=dtype)
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(W[n])
    return m.eval()


def inputs(B=3, S=12, seed=1, vocab=50):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, vocab, (B, S), generator=g)
    lens = torch.tensor([S, S - 5, 3])[:B]
    mask = torch.arange(S)[None] < lens[:, None]
    return ids * mask, mask


def test_config_from_dir_and_model_type_selection(tmp_path):
    d = tmp_path / "g"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(TINY, experts_held=2, first_expert=4)))
    c = encoder_config_from_dir(str(d))
    assert isinstance(c, GraniteConfig) and c.held == (4, 6) and c.num_hidden_layers == 3
    assert c.layer_types == ("mamba", "attention", "mamba")
    # 10 layers of the published 40-entry layer_types: the first 10 are taken
    long = dict(TINY, num_hidden_layers=2, layer_types=["mamba", "attention", "mamba", "mamba"])
    assert GraniteConfig.from_dict(long).layer_types == ("mamba", "attention")
    (d / "config.json").write_text(json.dumps({"model_type": "bert", "hidden_size": 64,
                                               "num_attention_heads": 4}))
    assert isinstance(encoder_config_from_dir(str(d)), BertConfig)
    for key, bad in (("position_embedding_type", "rope"), ("hidden_act", "gelu"),
                     ("layer_types", ["mamba"]), ("experts_held", 9),
                     ("num_key_value_heads", 3), ("attention_bias", True)):
        with pytest.raises(ValueError):
            GraniteConfig.from_dict(dict(TINY, **{key: bad}))
    (d / "config.json").write_text(json.dumps(TINY))
    with pytest.raises(ValueError, match="model_type"):
        BertConfig.from_dir(str(d))


@pytest.mark.parametrize("chunk", [256, 4])
def test_port_matches_reference_in_f32(chunk):
    c = dict(TINY, mamba_chunk_size=chunk)
    W = weights(c)
    ids, mask = inputs()
    with torch.no_grad():
        got = port(c, W)(ids, mask)[-1]
        want, _ = ref.encoder(W, "", c, ids, mask, ref.Prec(bf16=False))
    assert torch.allclose(got[mask], want[mask], atol=1e-5, rtol=1e-5)


def test_port_matches_reference_at_the_bf16_rounding_points():
    W = weights(TINY, seed=3)
    ids, mask = inputs(seed=4)
    routes = []
    with torch.no_grad():
        got = port(TINY, W, torch.bfloat16)(ids, mask, routes)[-1]
        want, ref_routes = ref.encoder(W, "", TINY, ids, mask, ref.Prec(bf16=True))
        f32, _ = ref.encoder(W, "", TINY, ids, mask, ref.Prec(bf16=False))
    live = mask.reshape(-1)
    for (sel, _), (_, rsel) in zip(routes, ref_routes):
        assert torch.equal(sel[live].sort(-1).values, rsel[live].sort(-1).values)
    scale = want[mask].abs().max()
    assert (got[mask] - want[mask]).abs().max() <= 2e-3 * scale
    # the rounding points are there: the f32 encoder differs by far more
    assert (f32[mask] - want[mask]).abs().max() > 10 * (got[mask] - want[mask]).abs().max()


def test_reference_and_port_match_transformers():
    transformers = pytest.importorskip("transformers")
    from transformers import GraniteMoeHybridConfig, GraniteMoeHybridModel

    W = weights(TINY, seed=5)
    ids, mask = inputs(seed=6)
    cfg = GraniteMoeHybridConfig(**{k: v for k, v in TINY.items() if k != "model_type"})
    cfg._attn_implementation = "eager"
    hf = GraniteMoeHybridModel(cfg).eval()
    hf.load_state_dict(W, strict=True)
    with torch.no_grad():
        out = hf(input_ids=ids, attention_mask=mask.long(), output_hidden_states=True)
        want, _ = ref.encoder(W, "", TINY, ids, mask, ref.Prec(bf16=False))
        states = port(TINY, W)(ids, mask)
    assert transformers.__version__
    assert torch.allclose(out.last_hidden_state[mask], want[mask], atol=1e-5, rtol=1e-5)
    assert len(states) == len(out.hidden_states) == TINY["num_hidden_layers"] + 1
    for a, b in zip(states, out.hidden_states):
        assert torch.allclose(a[mask], b[mask], atol=1e-5, rtol=1e-5)


def test_expert_shares_sum_to_the_uncut_layer():
    """Four chips' shares of a layer (two experts each) plus the shared
    expert once equal the uncut layer, in the port and in the reference."""
    W = weights(TINY, seed=7)
    pre = "layers.0."
    x = torch.randn(20, 64, generator=torch.Generator().manual_seed(8))
    live = torch.ones(20, dtype=torch.bool)
    live[17:] = False
    full = port(TINY, W).layers[0]
    with torch.no_grad():
        shared = full.shared_mlp(x)
        uncut = full.block_sparse_moe(x, live) + shared
        parts = shared.clone()
        ref_parts = ref.swiglu(W, pre + "shared_mlp.input_linear.weight",
                               pre + "shared_mlp.output_linear.weight", x, ref.Prec(False))
        for e0 in range(0, 8, 2):
            c = dict(TINY, experts_held=2, first_expert=e0)
            Wc = {n: (w[e0:e0 + 2] if "_linear.weight" in n and "experts" not in n
                      and "block_sparse_moe" in n else w) for n, w in W.items()}
            parts += port(c, Wc).layers[0].block_sparse_moe(x, live)
            ref_parts += ref.moe(Wc, pre + "block_sparse_moe.", c, x, live, ref.Prec(False))[0]
        ref_uncut = ref.moe(W, pre + "block_sparse_moe.", TINY, x, live, ref.Prec(False))[0]
    assert torch.allclose(parts, uncut, atol=1e-6, rtol=1e-5)
    assert torch.allclose(ref_parts, ref_uncut + ref.swiglu(
        W, pre + "shared_mlp.input_linear.weight", pre + "shared_mlp.output_linear.weight", x,
        ref.Prec(False)), atol=1e-6, rtol=1e-5)
    assert torch.allclose(uncut, ref_uncut + shared, atol=1e-5, rtol=1e-5)
    assert uncut[17:].abs().max() > 0 and (uncut - shared)[17:].abs().max() == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k7_plain_version_against_a_loop_over_positions(dtype):
    g = torch.Generator().manual_seed(9)
    T, H, inter, E, k, e0, e1 = 30, 64, 32, 8, 3, 2, 6
    x = torch.randn(T, H, generator=g).to(dtype)
    sel = torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(T)])
    gates = torch.softmax(torch.randn(T, k, generator=g), -1)
    mask = torch.rand(T, generator=g) > 0.2
    w_in = (0.1 * torch.randn(e1 - e0, 2 * inter, H, generator=g)).to(dtype)
    w_out = (0.1 * torch.randn(e1 - e0, H, inter, generator=g)).to(dtype)
    got = moe.moe_experts(x, sel, gates, e0, e1, mask, w_in, w_out)
    want = torch.zeros(T, H)
    for t in range(T):
        if not mask[t]:
            continue
        for j in range(k):
            e = int(sel[t, j])
            if not e0 <= e < e1:
                continue
            h = w_in[e - e0].float() @ x[t].float()
            act = (torch.nn.functional.silu(h[:inter]) * h[inter:]).to(dtype).float()
            want[t] += gates[t, j] * (w_out[e - e0].float() @ act)
    assert got.dtype == torch.float32
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    assert got[~mask].abs().max() == 0
    held = ((sel >= e0) & (sel < e1)).any(1) & mask
    assert (got[~held] == 0).all() and (got[held].abs().amax(1) > 0).all()


def test_tie_rule_takes_the_program_choice_only_within_tau():
    tau = 0.01
    logits = torch.tensor([[5.0, 4.0, 3.0, 2.995, 1.0],     # 3rd / 4th within tau
                           [5.0, 4.0, 3.0, 2.9, 1.0],       # 3rd / 4th 0.1 apart
                           [5.0, 4.0, 3.0, 2.0, 1.0]])      # the same set
    own = logits.topk(3, -1).indices
    program = torch.tensor([[0, 1, 3], [0, 1, 3], [2, 1, 0]])
    sel, ties = vlgae_granite.follow_ties(logits, own, program, tau)
    assert sel[0].sort().values.tolist() == [0, 1, 3]   # a tie: the program's set
    assert sel[1].sort().values.tolist() == [0, 1, 2]   # beyond tau: the reference's own
    assert sel[2].sort().values.tolist() == [0, 1, 2]
    assert ties == 1
    assert vlgae_granite.near_ties(logits, 3, tau) == 1
    # route_sel reads one misroute as at least 1/71 (ids up to 71), agreement as 0
    ref_sel = np.array([[[0, 1, 71], [2, 5, 9]]])
    prog_sel = ref_sel.copy()
    assert compare.extra_readings({"route_sel": prog_sel}, {"route_sel": ref_sel}) == {
        "route_sel": 0.0}
    prog_sel[0, 1, 2] = 10
    assert compare.extra_readings({"route_sel": prog_sel},
                                  {"route_sel": ref_sel})["route_sel"] >= 1 / 71


def _granite_dir(path, words):
    from test_torch_cli import write_bert_dir

    write_bert_dir(path, words)
    (path / "config.json").write_text(json.dumps(dict(TINY, vocab_size=120, experts_held=4,
                                                      first_expert=2)))
    return path


def test_granite_directory_trains_and_predicts(tmp_path, monkeypatch):
    """``embedding.transformer.args.model`` naming a granite directory: the
    factory builds the granite encoder (bf16 weights, frozen, out of Adam),
    one train epoch and a predict run on the CPU through the CLIs."""
    from test_torch_slice import overrides as vlgae_overrides
    from vlgae_tpu_torch import predict, train

    root = tmp_path / "c"
    synth_data.make_corpus(Path(root) / "vlparse", n_imgs=2, feat_dim=16, n_box=6,
                           len_range=(3, 6))
    words = [line.split("\t")[1] for split in ("train", "val", "test")
             for line in (root / "vlparse" / f"{split}.conll").read_text().splitlines()
             if line]
    gdir = _granite_dir(tmp_path / "granite", words)
    monkeypatch.chdir(tmp_path)
    ovs = vlgae_overrides(root) + [f"embedding.transformer.args.model={gdir}", "device=cpu",
                                   "init_seed=0", "trainer.max_epochs=1", "workdir=run",
                                   "model.init_epoch=0"]
    pipe, _ = train.main(ovs)
    enc = pipe.model.dependency.embedding.transformer.bert
    assert isinstance(enc, GraniteHybrid)
    assert enc.layers[0].block_sparse_moe.input_linear.weight.shape == (4, 64, 64)
    assert enc.embed_tokens.weight.dtype == torch.bfloat16
    held = {id(p) for p in pipe.optimizer.params}
    assert not any(id(p) in held for p in enc.parameters())
    assert all(torch.isfinite(p).all() for p in pipe.model.parameters())
    pipe2, results = predict.main([f"checkpoint={tmp_path / 'run' / 'checkpoint' / 'last.pt'}",
                                   "device=cpu", "name=port"])
    assert isinstance(pipe2.model.dependency.embedding.transformer.bert, GraniteHybrid)
    assert (tmp_path / "port_dev.conll").read_text().strip()
