"""Where the time of the port's eval step or train step goes, on one
CUDA device.

    python scripts/profile_torch_eval.py \
        [eval|train|lang_only_eval|lang_only_train|vit_eval|vit_train] [viterbi|mbr]

Builds the pipeline of ``exp=vlgae`` (random weights from seed 0) on the
synthetic corpus of ``chip_smoke.py``'s slice phase (lengths 3-50, 36
boxes of 2048-d features, batches of 64). ``eval`` (the default) runs dev
eval steps; ``train`` runs joint train steps (bf16, dropout on: upload,
forward, backward, clip, Adam). The ``lang_only_*`` modes do the same for
``exp=lang_only`` at its recipe's widths on the corpus of ``chip_smoke.py``'s
``lang_only`` phase (training captions up to 10 words, so full batches pad
to L = 8 or 16; dev captions of 3-49 words). The ``vit_*`` modes do the
same for ``exp=vlgae_vit`` at its recipe's widths on the corpus of
``chip_smoke.py``'s ``vit`` phase (224 px images, captions of 3-63 words;
the ViT's weights from seed 0). ``mbr`` decodes the eval steps' trees by
MBR (``mbr_decoding: true``) in place of the Viterbi trees. Prints JSON
lines:

  - the wall time of a step (host clock, synchronised),
  - the same under ``torch.profiler``: device-busy ms per step, the device's
    idle share and the kernel launches per step,
  - the 20 kernels with the most device time per step,
  - device and host ms of each stage of the step (CUDA events, a
    synchronise between stages),

and, last, the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from synth_data import make_corpus  # noqa: E402
from vlgae_tpu_torch.predict import (build_datamodule, build_pipeline,  # noqa: E402
                                     compose)
from vlgae_tpu_torch.training.factory import build_model  # noqa: E402
from vlgae_tpu_torch.training.pipeline import (Pipeline, _to_device,  # noqa: E402
                                               init_params, pad_batch_pow2)

N_STEPS = 4


def emit(obj):
    print(json.dumps(obj), flush=True)


def run_steps(step, batches):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        step(b)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _timer(stages):
    def timed(name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        result = fn()
        end.record()
        end.synchronize()
        stages[name] = {"device_ms": start.elapsed_time(end),
                        "host_ms": (time.perf_counter() - t0) * 1e3}
        return result
    return timed


def train_stage_times(pipe, batch):
    """Device and host ms of the stages of one joint train step."""
    stages = {}
    timed = _timer(stages)
    x, y = batch
    pipe.model.train()
    inputs = timed("upload", lambda: _to_device(x, pipe.device))
    gold = _to_device(y, pipe.device)
    loss, _ = timed("forward + loss", lambda: pipe.compute_loss(inputs, gold, False, 0.5))
    timed("backward (K6, the DP tables, autograd)", loss.backward)
    timed("clip + Adam", lambda: pipe.optimizer.step(pipe.step))
    pipe.optimizer.zero_grad()
    return stages


def stage_times(model, inputs, mbr=False):
    """Device and host ms of each stage of one eval forward + loss + decode
    (the order of ``DependencyBoxRel.forward``)."""
    from vlgae_tpu_torch.models.ldndmv import decode

    stages = {}
    timed = _timer(stages)

    token = inputs["token"]
    mask = (torch.arange(token.shape[1], device=token.device)[None]
            < inputs["seq_len"][:, None])
    dep = model.dependency
    vis_enc = timed("vis_encoder", lambda: model.vis_encoder(inputs))
    emb, aux = timed("embedding (BERT + tag)", lambda: dep.embedding(inputs))
    enc = timed("encoder", lambda: dep.encoder(emb, mask))
    enc = timed("fuse_with_matching",
                lambda: model.fuse_with_matching(inputs, vis_enc, enc, mask))
    out = timed("DiscriminativeNDMV scores", lambda: dict(dep(inputs, enc, (emb, aux))))
    vis = timed("vis_feat", lambda: model.vis_feat(inputs, vis_enc))
    *txt, reuse = timed("lang_feat_max_tree (2x K1)",
                        lambda: model.lang_feat_max_tree(inputs, enc, out, mask))
    out.update({"vis_packed": vis, "txt_packed": tuple(txt), "dep_reuse": reuse})
    out["match_reduced"] = timed("gather_logit_train (K5)",
                                 lambda: model.gather_logit_train(vis, tuple(txt)))
    out["match_logit"] = out["match_reduced"][0]
    zero = torch.zeros((), device=token.device)
    timed("val/loss (factor CE)", lambda: model.loss(out, inputs, zero, alpha=0.5))
    timed("decode_grounding (top-5)", lambda: model.decode_grounding_device(out, inputs))
    timed("decode (reused tables; MBR: K1 max on the Eisner potentials)",
          lambda: decode(out, inputs["seq_len"], mbr))
    return stages


def lang_train_stage_times(pipe, batch):
    """Device and host ms of the stages of one ``exp=lang_only`` NLL step."""
    stages = {}
    timed = _timer(stages)
    x, y = batch
    pipe.model.train()
    inputs = timed("upload", lambda: _to_device(x, pipe.device))
    gold = _to_device(y, pipe.device)
    loss, _ = timed("forward + loss (BiLSTM, scores, saving inside)",
                    lambda: pipe.compute_loss(inputs, gold, False, 0.5))
    timed("backward (outside kernel, autograd)", loss.backward)
    timed("clip + Adam", lambda: pipe.optimizer.step(pipe.step))
    pipe.optimizer.zero_grad()
    return stages


def lang_stage_times(model, inputs, mbr=False):
    """Device and host ms of each stage of one ``exp=lang_only`` eval step."""
    from vlgae_tpu_torch.models.ldndmv import decode, loss_nll

    stages = {}
    timed = _timer(stages)
    token = inputs["token"]
    mask = (torch.arange(token.shape[1], device=token.device)[None]
            < inputs["seq_len"][:, None])
    emb, aux = timed("embedding (word + tag)", lambda: model.embedding(inputs))
    enc = timed("encoder (BiLSTM)", lambda: model.encoder(emb, mask))
    out = timed("DiscriminativeNDMV scores", lambda: model(inputs, enc, (emb, aux)))
    timed("loss (value-only inside)",
          lambda: loss_nll(out, inputs["seq_len"], model.cfg.viterbi_training))
    timed("decode (K1 max; MBR: K1 log, then K1 max on the Eisner potentials)",
          lambda: decode(out, inputs["seq_len"], mbr))
    return stages


def _lang_setup(tmp, mode):
    """The ``exp=lang_only`` pipeline, batches of 64 and the step to time."""
    cfg = compose(chip_smoke._lang_overrides(tmp, False))
    dm = build_datamodule(cfg)
    model = build_model(cfg, dm)
    init_params(model, 0)
    pipe = Pipeline(model, dm, cfg, device="cuda", workdir=tmp)
    pipe.setup_optimizer()
    if mode == "lang_only_eval":
        # the sampler cuts a length bucket into equal batches of 33-64 rows
        batches = [pad_batch_pow2(x)[0] for x, _ in pipe.dm.batches("dev", shuffle=False)
                   if len(x["seq_len"]) > 32]
        return pipe, batches[:: max(1, len(batches) // N_STEPS)][:N_STEPS], pipe.eval_step
    # batches of exactly 64 training captions at each padded length
    ds = dm.datasets["train"]
    batches = []
    for L, keep in ((8, lambda n: n <= 8), (16, lambda n: n > 8)):
        insts = [i for i in ds if keep(i["seq_len"])]
        batches += [dm.collate("train", insts[k:k + 64], L) for k in (0, 64)]

    def step(b):
        loss, _ = pipe.train_step(*b, False, 0.5)
        float(loss)
    return pipe, batches, step


def _train_setup(tmp, overrides):
    """A training pipeline and N_STEPS joint batches of 64 captions."""
    cfg = compose(overrides + ["datamodule.train_dataloader.num_bucket=1"])
    dm = build_datamodule(cfg)
    model = build_model(cfg, dm)
    init_params(model, 0)
    pipe = Pipeline(model, dm, cfg, device="cuda", workdir=tmp)
    pipe.setup_optimizer()
    batches = [(pad_batch_pow2(x)[0], pad_batch_pow2(y)[0])
               for x, y in dm.batches("train") if len(x["seq_len"]) == 64][:N_STEPS]

    def step(b):
        loss, _ = pipe.train_step(*b, False, 0.5)
        float(loss)
    return pipe, batches, step


def main(mode="eval", decode="viterbi"):
    if not torch.cuda.is_available():
        print("profile_torch_eval: no CUDA device", file=sys.stderr)
        return 2
    if mode not in ("eval", "train", "lang_only_eval", "lang_only_train", "vit_eval",
                    "vit_train") or decode not in ("viterbi", "mbr"):
        print(f"profile_torch_eval: unknown mode {mode!r} {decode!r}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lang = mode.startswith("lang_only")
    with tempfile.TemporaryDirectory() as tmp:
        if lang:
            make_corpus(os.path.join(tmp, "vlparse"), n_imgs=chip_smoke.LANG_N_IMGS,
                        feat_dim=4, n_box=3, len_range=(3, 50), seed=0)
            pipe, batches, step = _lang_setup(tmp, mode)
        else:
            vit = mode.startswith("vit")
            make_corpus(os.path.join(tmp, "vlparse"), n_imgs=104, feat_dim=2048,
                        n_box=36, len_range=(3, 64) if vit else (3, 50), seed=0,
                        image_size=chip_smoke.VIT_RECIPE["image_size"] if vit else 0)
            overrides = chip_smoke._corpus_overrides(tmp)
            if vit:
                npz = os.path.join(tmp, "vit.npz")
                chip_smoke.write_vit_npz(npz, chip_smoke.VIT_RECIPE, seed=0)
                overrides = chip_smoke._vit_overrides(tmp) + [f"vis_encoder.vit_weights={npz}"]
            if mode in ("train", "vit_train"):
                pipe, batches, step = _train_setup(tmp, overrides)
            else:
                pipe = build_pipeline(overrides + [
                    "datamodule.dev_dataloader.num_bucket=1"], device="cuda", init_seed=0)
                batches = [pad_batch_pow2(x)[0]
                           for x, _ in pipe.dm.batches("dev", shuffle=False)][:N_STEPS]
                step = pipe.eval_step
        pipe.dep_cfg = dataclasses.replace(pipe.dep_cfg, mbr_decoding=decode == "mbr")
        emit({"mode": mode, "decode": decode, "batches": len(batches), "B": 64,
              "padded_len": [int((b[0] if isinstance(b, tuple) else b)["word"].shape[1])
                             for b in batches]})
        run_steps(step, batches)  # warm-up
        emit({"wall_ms_per_step": run_steps(step, batches) * 1e3 / len(batches)})
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = run_steps(step, batches)
        # device work only: not the annotation ranges (Optimizer.step#...)
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        emit({"profiled_wall_ms_per_step": wall * 1e3 / len(batches),
              "device_busy_ms_per_step": busy_us / 1e3 / len(batches),
              "idle_share": 1 - busy_us / 1e6 / wall,
              "kernels_per_step": len(kernels) / len(batches)})
        by_name = defaultdict(lambda: [0.0, 0])
        for e in kernels:
            by_name[e.name[:80]][0] += e.time_range.elapsed_us()
            by_name[e.name[:80]][1] += 1
        for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
            emit({"kernel": name, "device_ms_per_step": us / 1e3 / len(batches),
                  "launches_per_step": n / len(batches)})
        if mode == "lang_only_train":
            for b in {b[0]["word"].shape[1]: b for b in batches}.values():
                lang_train_stage_times(pipe, b)  # warm-up
                emit({"padded_len": int(b[0]["word"].shape[1]),
                      "stages_B64": lang_train_stage_times(pipe, b)})
        elif mode == "lang_only_eval":
            with torch.no_grad():
                for b in batches:
                    inputs = _to_device(b, pipe.device)
                    lang_stage_times(pipe.model.eval(), inputs, decode == "mbr")  # warm-up
                    emit({"padded_len": int(b["word"].shape[1]),
                          "stages_B64": lang_stage_times(pipe.model, inputs,
                                                         decode == "mbr")})
        elif mode in ("train", "vit_train"):
            train_stage_times(pipe, batches[0])  # warm-up
            emit({"stages_B64": train_stage_times(pipe, batches[0])})
        else:
            with torch.no_grad():
                inputs = _to_device(batches[0], pipe.device)
                stage_times(pipe.model, inputs, decode == "mbr")  # warm-up
                emit({"stages_B64": stage_times(pipe.model, inputs, decode == "mbr")})
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
