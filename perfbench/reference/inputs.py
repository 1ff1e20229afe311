"""The reference's own batch inputs, read anew from the corpus files that
the generator wrote.

A row's caption is its line block in the split's CoNLL file (the program's
batch says which block: ``id``); its image is the caption's line of
``id_list`` (five captions an image); its tag ids come from a vocabulary
counted on the training split (``<pad>``, ``<unk>``, then by count, ties in
the order first seen); its subwords from WordPiece on the benchmark's own
``vocab.txt``; its region features from ``np.load`` of the image's file.
The packer draws ``sample_boxes`` of the file's rows at random and keeps
them in file order: the program's batch says which rows were drawn, each
found by its value in the file. Rows past the real ones repeat the first
with no words, as ``train_epoch`` pads a batch. ``diff`` counts the
entries in which the program's batch differs from these inputs.
"""

from __future__ import annotations

import os
import re
from collections import Counter

import numpy as np

from ..core.corpus import read_conll

KEYS = ("seq_len", "token", "tag", "subword", "subword_mask", "subword_first",
        "subword_last", "vis_box_feat", "vis_box_mask", "vis_available")


class WordPiece:
    """Greedy longest-match-first WordPiece over a ``vocab.txt``, lower
    case (the directory has no ``tokenizer_config.json``)."""

    def __init__(self, path: str):
        with open(os.path.join(path, "vocab.txt")) as f:
            self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        self.unk, self.cls, self.sep = (self.vocab[t] for t in ("[UNK]", "[CLS]", "[SEP]"))

    def word(self, w: str) -> list:
        w = w.lower()
        ids, start = [], 0
        while start < len(w):
            for end in range(len(w), start, -1):
                sub = w[start:end] if start == 0 else "##" + w[start:end]
                if sub in self.vocab:
                    ids.append(self.vocab[sub])
                    start = end
                    break
            else:
                return [self.unk]
        return ids or [self.unk]


class Corpus:
    def __init__(self, root: str, bert_dir: str, split: str, vision: dict):
        self.root = root
        self.sents = read_conll(os.path.join(root, f"{split}.conll"))
        with open(os.path.join(root, "id_list", f"{split}.txt")) as f:
            self.images = [int(line) for line in f if line.strip()]
        count = Counter(t for _, tags in read_conll(os.path.join(root, "train.conll"))
                        for t in tags)
        self.tag_names = ["<pad>", "<unk>"] + [t for t, _ in count.most_common()]
        self.tag_id = {t: i for i, t in enumerate(self.tag_names)}
        self.wp = WordPiece(bert_dir)
        self.sample = int(vision["sample_boxes"])
        self.feat_dim = int(vision["feat_dim"])

    def features(self, img: int) -> np.ndarray:
        f = np.load(os.path.join(self.root, "det_feats", f"{img}.npy"))
        return f[:, :self.feat_dim]

    def batch(self, prog: dict, real: int) -> tuple:
        """``(inputs, diff)``: this batch's inputs, at the program's padded
        shape, and the count of entries where ``prog`` says otherwise."""
        B, L = prog["token"].shape
        P = prog["vis_box_feat"].shape[1]
        x = {"seq_len": np.zeros(B, np.int32), "token": np.zeros((B, L), np.int32),
             "tag": np.zeros((B, L), np.int32),
             "subword_first": np.zeros((B, L), np.int32),
             "subword_last": np.zeros((B, L), np.int32),
             "vis_box_feat": np.zeros((B, P, self.feat_dim), np.float32),
             "vis_box_mask": np.zeros((B, P), bool)}
        flats = []
        for b in range(real):
            idx = int(prog["id"][b])
            words, tags = self.sents[idx]
            n = len(words)
            x["seq_len"][b] = n
            x["tag"][b, :n] = x["token"][b, :n] = [self.tag_id.get(t, 1) for t in tags]
            flat = [self.wp.cls]
            for i, w in enumerate(words):
                x["subword_first"][b, i] = len(flat)
                flat += self.wp.word(re.sub(r"\d", "0", w))
                x["subword_last"][b, i] = len(flat) - 1
            flats.append(flat + [self.wp.sep])
            feats = self.features(self.images[idx // 5])
            n_draw = min(self.sample, len(feats)) if self.sample > 0 else min(P, len(feats))
            drawn = []
            for j in range(n_draw):
                hit = [k for k in np.flatnonzero((feats == prog["vis_box_feat"][b, j]).all(1))
                       if not drawn or k > drawn[-1]]
                drawn.append(hit[0] if hit else min(set(range(len(feats))) - set(drawn)))
            x["vis_box_feat"][b, :n_draw] = feats[drawn]
            x["vis_box_mask"][b, :n_draw] = True
        S = max(8, (max(map(len, flats)) + 7) // 8 * 8)
        x["subword"] = np.zeros((B, S), np.int32)
        x["subword_mask"] = np.zeros((B, S), bool)
        for b, flat in enumerate(flats):
            x["subword"][b, :len(flat)] = flat
            x["subword_mask"][b, :len(flat)] = True
        for k, v in x.items():
            if k != "seq_len":
                v[real:] = v[:1]
        x["vis_available"] = x["vis_box_mask"][:, 0].copy()
        diff = sum(int(np.size(x[k])) if np.shape(prog[k]) != np.shape(x[k])
                   else int((np.asarray(prog[k]) != x[k]).sum()) for k in KEYS)
        return x, diff
