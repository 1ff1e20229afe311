"""CoNLL file reading/writing.

Replaces the reference's fastNLP ``ConllLoader`` usage
(ref: src/datamodule/task/dep.py:34-36): tab-separated blocks, columns
1/2/3 = word/tag/head by default.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence


def read_conll(path, headers: Sequence[str] = ("raw_word", "tag", "arc"),
               indexes: Sequence[int] = (1, 2, 3)) -> List[Dict[str, list]]:
    """Parse a CoNLL file into a list of {header: column list} sentences."""
    sentences = []
    current: List[List[str]] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                if current:
                    sentences.append(_pack(current, headers, indexes))
                    current = []
                continue
            if line.startswith("#"):
                continue
            current.append(line.split("\t"))
    if current:
        sentences.append(_pack(current, headers, indexes))
    return sentences


def _pack(rows, headers, indexes):
    inst = {}
    for header, idx in zip(headers, indexes):
        col = [row[idx] for row in rows]
        inst[header] = col
    if "arc" in inst:
        inst["arc"] = [int(a) for a in inst["arc"]]
    return inst


def write_conll_rows(f, rows: Iterable[Sequence]) -> None:
    """Write one sentence (iterable of row tuples) + blank line."""
    for row in rows:
        f.write("\t".join(str(x) for x in row))
        f.write("\n")
    f.write("\n")
