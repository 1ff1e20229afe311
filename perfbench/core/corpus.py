"""The traffic generator: a VLParse-format corpus written from a seed.

Frozen copy of ``tests/synth_data.py::make_corpus`` (commit 71fea60) with a
length law and split sizes taken from a traffic file, and of
``chip_smoke.py::write_bert_dir`` and ``corpus_words`` (same commit). It is
kept here so that a change to the program or its tests cannot move the
benchmark's inputs. The layout is the one the VLParse data module reads:

  {split}.conll              id word tag head (tab-separated)
  id_list/{split}.txt        one img_id per line (5 captions each)
  det_feats/{img_id}.npy     [n_box, feat_dim + 4] (region recipes)
  imgs/{img_id}.npy          [S, S, 3] pixels (the ViT recipe)
  vlparse.json               scene graphs + txt2sg alignments
  dev_roi_boxes.json         proposal boxes per image

Every seed gets the same multiset of caption lengths (the law's quantiles),
dealt to the captions in an order drawn from the seed, so that two seeds
give the same work in another order.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from statistics import NormalDist

import numpy as np

TAGS = ["NN", "VBZ", "DT", "JJ", "IN", "NNS"]
WORDS = {
    "NN": ["dog", "cat", "man", "ball", "tree"],
    "NNS": ["dogs", "cats"],
    "VBZ": ["runs", "sees", "holds"],
    "DT": ["the", "a"],
    "JJ": ["big", "red", "small"],
    "IN": ["on", "under"],
}
SPLITS = ("train", "init", "val", "test")
CAPTIONS_PER_IMAGE = 5


def length_multiset(law: dict, n: int, max_len: int) -> np.ndarray:
    """``n`` caption lengths that follow ``law``: its quantiles at
    ``(i + 0.5) / n``, rounded and clipped to ``[min, max]`` (``max`` may be
    the config's ``max_len``). Laws: ``lognormal`` (``median``, ``sigma`` in
    log space) and ``uniform`` (every whole length of ``[min, max]`` alike)."""
    lo = int(law["min"])
    hi = max_len if law["max"] == "max_len" else int(law["max"])
    u = (np.arange(n) + 0.5) / n
    if law["law"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in u])
        lens = np.rint(float(law["median"]) * np.exp(float(law["sigma"]) * z))
    elif law["law"] == "uniform":
        lens = lo + np.floor(u * (hi - lo + 1))
    else:
        raise ValueError(f"unknown length law {law['law']!r}")
    return np.clip(lens, lo, hi).astype(np.int64)


def random_projective_tree(rng, n):
    """Random single-root projective tree via recursive splitting."""
    heads = [0] * (n + 1)

    def build(lo, hi, head):
        if lo > hi:
            return
        r = rng.integers(lo, hi + 1)
        heads[r] = head
        build(lo, r - 1, r)
        build(r + 1, hi, r)

    root = int(rng.integers(1, n + 1))
    heads[root] = 0
    build(1, root - 1, root)
    build(root + 1, n, root)
    return heads[1:]


def image_ids(images: dict) -> dict:
    """The image ids of each split (``init`` shares the training images)."""
    ids = {"train": list(range(100_000, 100_000 + int(images["train"]))),
           "val": list(range(200_000, 200_000 + int(images["dev"]))),
           "test": list(range(300_000, 300_000 + int(images["test"])))}
    ids["init"] = ids["train"]
    return ids


def make_corpus(root, seed: int, images: dict, law: dict, max_len: int,
                vision: dict) -> Path:
    """Write the corpus of one run under ``root``. ``images``: images per
    split (``train``, ``dev``, ``test``); ``law``: the caption-length law;
    ``vision``: ``{"kind": "regions", "n_box", "feat_dim"}`` (region
    features) or ``{"kind": "pixels", "image_size", "pixel_dtype"}`` (the
    pixel files' float type; the loader reads them into f32)."""
    root = Path(root)
    (root / "id_list").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    ids = image_ids(images)
    all_imgs = sorted(set(sum(ids.values(), [])))
    if vision["kind"] == "regions":
        n_box, feat_dim = int(vision["n_box"]), int(vision["feat_dim"])
        (root / "det_feats").mkdir(exist_ok=True)
    else:
        n_box, feat_dim = 3, 0
        (root / "imgs").mkdir(exist_ok=True)
    sg_entries, roi_boxes = [], {}
    for img_id in all_imgs:
        boxes = np.abs(rng.standard_normal((n_box, 4))) * 50
        boxes[:, 2:] = boxes[:, :2] + 20 + boxes[:, 2:]
        if vision["kind"] == "regions":
            feats = rng.standard_normal((n_box, feat_dim)).astype(np.float32)
            np.save(root / "det_feats" / f"{img_id}.npy",
                    np.concatenate([feats, boxes], 1).astype(np.float32))
        else:
            s = int(vision["image_size"])
            np.save(root / "imgs" / f"{img_id}.npy",
                    rng.standard_normal((s, s, 3)).astype(vision.get("pixel_dtype", "float32")))
        roi_boxes[str(img_id)] = boxes.tolist()
        objs = [{"id": k, "x": float(b[0]), "y": float(b[1]),
                 "width": float(b[2] - b[0]), "height": float(b[3] - b[1])}
                for k, b in enumerate(boxes[:3])]
        rels = [{"id": 3, "subj": 0, "obj": 1, "x": 0.0, "y": 0.0,
                 "width": 1.0, "height": 1.0}]
        txt2sg = [{"1": {"type": "OBJ", "preferred": 0, "candidates": [[0, 1.0]]},
                   "2": {"type": "REL", "preferred": 3, "candidates": [[3, 1.0]]}}
                  for _ in range(CAPTIONS_PER_IMAGE)]
        sg_entries.append({"coco_id": img_id, "obj": objs, "rel": rels,
                           "txt2sg": txt2sg})
    with open(root / "vlparse.json", "w") as f:
        json.dump(sg_entries, f)
    for name in ("dev_roi_boxes.json", "dev_gold_boxes.json"):
        with open(root / name, "w") as f:
            json.dump(roi_boxes, f)
    for split in SPLITS:
        n = len(ids[split]) * CAPTIONS_PER_IMAGE
        lens = rng.permutation(length_multiset(law, n, max_len))
        sents = []
        for n_words in lens:
            n_words = int(n_words)
            tags = [TAGS[rng.integers(len(TAGS))] for _ in range(n_words)]
            words = [WORDS[t][rng.integers(len(WORDS[t]))] for t in tags]
            sents.append((words, tags, random_projective_tree(rng, n_words)))
        with open(root / "id_list" / f"{split}.txt", "w") as f:
            f.write("\n".join(map(str, ids[split])) + "\n")
        with open(root / f"{split}.conll", "w") as f:
            for words, tags, heads in sents:
                for i, (w, t, h) in enumerate(zip(words, tags, heads), 1):
                    f.write(f"{i}\t{w}\t{t}\t{h}\n")
                f.write("\n")
    return root


def read_conll(path) -> list:
    """``[(words, tags)]`` of a CoNLL file."""
    sents, words, tags = [], [], []
    with open(path) as f:
        for line in f:
            if not line.strip():
                if words:
                    sents.append((words, tags))
                words, tags = [], []
                continue
            cols = line.rstrip("\n").split("\t")
            words.append(cols[1])
            tags.append(cols[2])
    if words:
        sents.append((words, tags))
    return sents


def corpus_words(root) -> list:
    """Every word of the corpus's CoNLL files."""
    return [w for split in SPLITS
            for words, _ in read_conll(os.path.join(root, f"{split}.conll"))
            for w in words]


def write_bert_dir(path, words, config) -> str:
    """A BERT directory without weights and without
    ``tokenizer_config.json`` (so ``do_lower_case`` takes its default,
    true): ``config.json`` and a WordPiece ``vocab.txt`` of the special
    tokens, then of ``words``: every other one whole, the rest as their first
    two letters and one ``##`` piece a letter, every fifth one left out (it
    tokenizes to ``[UNK]``)."""
    os.makedirs(path, exist_ok=True)
    pieces = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    for i, w in enumerate(sorted({w.lower() for w in words})):
        if i % 5 == 4:
            continue
        pieces += [w] if i % 2 == 0 or len(w) < 3 else [w[:2]] + [f"##{c}" for c in w[2:]]
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(dict.fromkeys(pieces)) + "\n")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return str(path)

