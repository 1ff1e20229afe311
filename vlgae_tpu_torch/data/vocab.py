"""Vocabularies, including the lexicalized ``word:tag`` token vocab
(a copy of vlgae_tpu/data/vocab.py)."""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Optional

PAD = "<pad>"
UNK = "<unk>"


class Vocabulary:
    def __init__(self, padding: Optional[str] = PAD,
                 unknown: Optional[str] = UNK):
        self.padding = padding
        self.unknown = unknown
        self.word2idx: Dict[str, int] = {}
        self.idx2word: List[str] = []
        self.word_count: Counter = Counter()
        self._no_create: set = set()
        for special in (padding, unknown):
            if special is not None:
                self._add_symbol(special)

    def _add_symbol(self, w):
        if w not in self.word2idx:
            self.word2idx[w] = len(self.idx2word)
            self.idx2word.append(w)

    # -- building ----------------------------------------------------------
    def update(self, words: Iterable[str], no_create_entry: bool = False):
        """Count ``words``. A word first seen with ``no_create_entry`` (it
        occurs in dev/test only) is remembered as such until a training
        split counts it too."""
        for w in words:
            self.word_count[w] += 1
            if no_create_entry:
                if w not in self.word2idx:
                    self._no_create.add(w)
            else:
                self._no_create.discard(w)
        return self

    def build(self):
        """Assign indices by count (desc), then insertion order."""
        for w, _ in self.word_count.most_common():
            self._add_symbol(w)
        return self

    def from_datasets(self, datasets, field, no_create_entry_datasets=()):
        """Count ``field`` over the datasets, then build. The words of
        ``no_create_entry_datasets`` (dev/test) are counted too, so they
        get indices, as in the reference."""
        for ds in datasets:
            for inst in ds:
                self.update(inst[field])
        for ds in no_create_entry_datasets:
            for inst in ds:
                self.update(inst[field], no_create_entry=True)
        return self.build()

    # -- lookup -------------------------------------------------------------
    def __getitem__(self, w: str) -> int:
        if w in self.word2idx:
            return self.word2idx[w]
        if self.unknown is not None:
            return self.word2idx[self.unknown]
        raise KeyError(w)

    def __contains__(self, w) -> bool:
        return w in self.word2idx

    def __len__(self) -> int:
        return len(self.idx2word)

    @property
    def pad_index(self) -> int:
        return self.word2idx[self.padding] if self.padding else -1

    @property
    def unk_index(self) -> int:
        return self.word2idx[self.unknown] if self.unknown else -1

    def is_no_create(self, w: str) -> bool:
        return w in self._no_create

    def save(self, path):
        with open(path, "w", encoding="utf-8") as f:
            for w in self.idx2word:
                f.write(w + "\n")


class TokenVocabulary(Vocabulary):
    """``word:tag`` vocab with ``<unk>:tag`` backoff (ref: vocabulary.py:5-18)."""

    def __getitem__(self, w: str) -> int:
        if w in self.word2idx:
            return self.word2idx[w]
        if ":" in w:
            backoff = f"{UNK}:{w.rsplit(':', 1)[1]}"
            if backoff in self.word2idx:
                return self.word2idx[backoff]
        return self.word2idx[self.unknown]
