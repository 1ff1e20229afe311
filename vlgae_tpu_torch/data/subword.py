"""Subword tokenization for the transformer embedding path.

A copy of ``vlgae_tpu/data/subword.py`` without the HuggingFace
tokenizer: ``attach_subwords`` precomputes per-instance subword ids and
first/last-subword indices, and the collate pads them (to a multiple of
8). ``HashSubwordTokenizer`` is the deterministic, vocab-free tokenizer
that ``exp=vlgae`` uses when no local BERT directory exists: it hashes
words into a fixed id space, splitting long words into two pieces.
"""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np


class HashSubwordTokenizer:
    cls_id = 1
    sep_id = 2

    def __init__(self, vocab_size: int = 8192, max_pieces: int = 2):
        self.vocab_size = vocab_size
        self.max_pieces = max_pieces

    def __call__(self, words: List[str]) -> List[List[int]]:
        out = []
        for w in words:
            n_pieces = 1 if len(w) < 8 else self.max_pieces
            pieces = []
            for i in range(n_pieces):
                h = hashlib.md5(f"{w}:{i}".encode()).digest()
                pieces.append(3 + int.from_bytes(h[:4], "little")
                              % (self.vocab_size - 3))
            out.append(pieces)
        return out


def attach_subwords(dm, tokenizer):
    """Precompute subword fields on every dataset instance (the full
    sequence: inputs longer than the encoder's position limit go through
    the stride windows of ``TransformerItem``)."""
    for ds in dm.datasets.values():
        for inst in ds:
            pieces = tokenizer(inst["word"])
            flat = [tokenizer.cls_id]
            first, last = [], []
            for p in pieces:
                first.append(len(flat))
                flat.extend(p)
                last.append(len(flat) - 1)
            flat.append(tokenizer.sep_id)
            inst["subword_ids"] = flat
            inst["subword_first"] = first
            inst["subword_last"] = last

    orig_collate = dm.collate

    def collate(name, insts, pad_len):
        x, y = orig_collate(name, insts, pad_len)
        B = len(insts)
        S = max(len(i["subword_ids"]) for i in insts)
        S = max(8, (S + 7) // 8 * 8)
        sub = np.zeros((B, S), np.int32)
        sub_mask = np.zeros((B, S), bool)
        sub_first = np.zeros((B, pad_len), np.int32)
        sub_last = np.zeros((B, pad_len), np.int32)
        for b, inst in enumerate(insts):
            ids = inst["subword_ids"]
            sub[b, : len(ids)] = ids
            sub_mask[b, : len(ids)] = True
            ff = inst["subword_first"][:pad_len]
            sub_first[b, : len(ff)] = ff
            ll = inst["subword_last"][:pad_len]
            sub_last[b, : len(ll)] = ll
        x["subword"] = sub
        x["subword_mask"] = sub_mask
        x["subword_first"] = sub_first
        x["subword_last"] = sub_last
        return x, y

    dm.collate = collate
    return dm
