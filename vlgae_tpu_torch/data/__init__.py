"""Data pipeline (NumPy host code copied from vlgae_tpu.data)."""

from .conll import read_conll, write_conll_rows
from .datamodule import DepDataModule, VLParseDataModule, normalize_word
from .subword import HashSubwordTokenizer, WordPieceTokenizer, attach_subwords

__all__ = [
    "read_conll",
    "write_conll_rows",
    "DepDataModule",
    "VLParseDataModule",
    "normalize_word",
    "HashSubwordTokenizer",
    "WordPieceTokenizer",
    "attach_subwords",
]
