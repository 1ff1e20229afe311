"""Subword tokenization for the transformer embedding path.

A copy of ``vlgae_tpu/data/subword.py``: ``attach_subwords`` precomputes
per-instance subword ids and first/last-subword indices, and the collate
pads them (to a multiple of 8). ``HashSubwordTokenizer`` is the
deterministic, vocab-free tokenizer that ``exp=vlgae`` uses when no local
BERT directory exists: it hashes words into a fixed id space, splitting long
words into two pieces. With a local BERT directory the JAX package wraps
``transformers.AutoTokenizer``; the port imports no ``transformers``, so
:class:`WordPieceTokenizer` is the BERT tokenizer written here: it gives the
ids ``AutoTokenizer.from_pretrained(dir)`` gives for a BERT directory.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import unicodedata
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


# the CJK Unified Ideographs blocks BERT spaces out
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_whitespace(c: str) -> bool:
    return c in " \t\n\r" or unicodedata.category(c) == "Zs"


def _is_control(c: str) -> bool:
    return c not in "\t\n\r" and unicodedata.category(c).startswith("C")


def _is_punctuation(c: str) -> bool:
    cp = ord(c)
    return (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126
            or unicodedata.category(c).startswith("P"))


def _token_name(value, default: str) -> str:
    """A special token of ``tokenizer_config.json``: a string, or a
    serialized ``AddedToken`` (its ``content``)."""
    if isinstance(value, dict):
        return value.get("content", default)
    return default if value is None else str(value)


class WordPieceTokenizer:
    """BERT's tokenizer over a directory's ``vocab.txt`` (one piece a line,
    the line number its id) and, if present, ``tokenizer_config.json``
    (``do_lower_case``, default true, ``strip_accents``, default
    ``do_lower_case``, ``tokenize_chinese_chars``, default true, and the
    special tokens' names).

    A word is cleaned (control characters dropped, whitespace made a space),
    CJK ideographs are spaced out, accents stripped (NFD, marks ``Mn``
    dropped) and the text lower-cased as configured, then split on
    whitespace and punctuation, and each piece is matched greedily, longest
    first, against the vocabulary with ``##`` before every non-initial
    match; a piece of more than 100 characters or one without a match is
    ``[UNK]``. A special token of the vocabulary written in the text is its
    id. As the JAX package's ``HFTokenizer`` calls the HF tokenizer:
    one call a word without special tokens, ``[UNK]`` for a word that
    tokenizes to nothing, and ``cls_id`` / ``sep_id`` are the ids of
    ``[CLS]`` / ``[SEP]`` unless that id is 0 (or the token is absent),
    then 1 / 2."""

    max_chars = 100

    def __init__(self, path: str):
        cfg = {}
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
        self.vocab = {}
        with open(os.path.join(path, "vocab.txt"), encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i  # a repeated piece: its last line
        self.lower = bool(cfg.get("do_lower_case", True))
        strip = cfg.get("strip_accents")
        self.strip_accents = self.lower if strip is None else bool(strip)
        self.chinese = bool(cfg.get("tokenize_chinese_chars", True))
        unk = _token_name(cfg.get("unk_token"), "[UNK]")
        if unk not in self.vocab:
            raise ValueError(f"{path}/vocab.txt has no unknown token {unk!r}")
        self.unk_id = self.vocab[unk]
        self.cls_id = self.vocab.get(_token_name(cfg.get("cls_token"), "[CLS]")) or 1
        self.sep_id = self.vocab.get(_token_name(cfg.get("sep_token"), "[SEP]")) or 2
        # special tokens in the text are taken whole, before any normalization
        specials = {_token_name(cfg.get(f"{k}_token"), f"[{k.upper()}]")
                    for k in ("unk", "sep", "pad", "cls", "mask")}
        specials = sorted((t for t in specials if t in self.vocab), key=len, reverse=True)
        self._specials = re.compile("(" + "|".join(map(re.escape, specials)) + ")") \
            if specials else None

    def _normalize(self, text: str) -> str:
        out = []
        for c in text:
            if c in ("\0", "\ufffd") or _is_control(c):
                continue
            if _is_whitespace(c):
                out.append(" ")
            elif self.chinese and any(lo <= ord(c) <= hi for lo, hi in _CJK):
                out.append(f" {c} ")
            else:
                out.append(c)
        text = "".join(out)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        return text.lower() if self.lower else text

    def _pieces(self, text: str) -> List[str]:
        """Split on whitespace, then around every punctuation character."""
        pieces = []
        for chunk in text.split():
            cur = ""
            for c in chunk:
                if _is_punctuation(c):
                    if cur:
                        pieces.append(cur)
                    pieces.append(c)
                    cur = ""
                else:
                    cur += c
            if cur:
                pieces.append(cur)
        return pieces

    def _wordpiece(self, piece: str) -> List[int]:
        if len(piece) > self.max_chars:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(piece):
            end = len(piece)
            while end > start:
                sub = piece[start:end] if start == 0 else "##" + piece[start:end]
                if sub in self.vocab:
                    ids.append(self.vocab[sub])
                    break
                end -= 1
            else:
                return [self.unk_id]
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        """The ids of ``text`` without special tokens added."""
        parts = self._specials.split(text) if self._specials else [text]
        ids = []
        for k, part in enumerate(parts):
            if k % 2:  # a special token
                ids.append(self.vocab[part])
            else:
                ids += [i for p in self._pieces(self._normalize(part))
                        for i in self._wordpiece(p)]
        return ids

    def __call__(self, words: List[str]) -> List[List[int]]:
        return [self.encode(w) or [self.unk_id] for w in words]


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
