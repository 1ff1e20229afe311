"""Readers of two checkpoint formats, in NumPy alone (the port imports
neither ``msgpack``, ``flax`` nor ``safetensors``: none is a package its
card is sure to have).

* :func:`msgpack_restore`: the bytes ``flax.serialization.msgpack_serialize``
  writes. A msgpack document of maps, strings, binaries, integers, floats,
  booleans, nil and arrays; an array leaf is flax's extension type 1 (a
  numpy scalar type 3, a complex number type 2) whose payload is itself
  msgpack: ``(shape, dtype name, C-order bytes)``. Arrays larger than 1 GiB
  are chunked by flax into a map marked ``__msgpack_chunked_array__``, and
  joined again here. bfloat16 arrays are widened to float32.
* :func:`read_safetensors`: an 8-byte little-endian header length, a JSON
  header (per tensor its ``dtype``, ``shape`` and ``data_offsets`` into the
  bytes that follow; ``__metadata__`` aside), then the raw little-endian
  tensors. F32, F16, BF16 (widened to float32) and F64.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Tuple

import numpy as np

_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) as float32: the high half of the word."""
    return (raw.astype(np.uint32) << 16).view(np.float32)


class _Reader:
    """A msgpack decoder over one buffer; ``ext`` turns an extension's
    ``(code, payload)`` into a value."""

    def __init__(self, data: bytes, raw: bool, ext=None):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw
        self.ext = ext

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = bytes(self.data[self.pos: self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def str(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext_value(self, n: int):
        code = self.unpack("b")
        payload = self.take(n)
        if self.ext is None:
            raise ValueError(f"msgpack: extension type {code} without a decoder")
        return self.ext(code, payload)

    def value(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
                 0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
                 0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
                 0xDC: ("H", "array"), 0xDD: ("I", "array"),
                 0xDE: ("H", "map"), 0xDF: ("I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "ext":
                return self.ext_value(n)
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            return self.map(n)
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext_value(fixext[b])
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buffer = _Reader(payload, raw=True).value()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        return _bf16_to_f32(np.frombuffer(buffer, np.uint16)).reshape(shape)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape)


def _flax_ext(code: int, payload: bytes):
    if code == _NDARRAY:
        return _ndarray(payload)
    if code == _NPSCALAR:
        return _ndarray(payload)[()]
    if code == _COMPLEX:
        re, im = _Reader(payload, raw=False).value()
        return complex(re, im)
    raise ValueError(f"msgpack: unknown extension type {code}")


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """The tree ``flax.serialization.msgpack_serialize`` wrote (its
    ``msgpack_restore``): dicts, lists and scalars with numpy array leaves."""
    reader = _Reader(data, raw=False, ext=_flax_ext)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the document")
    return _unchunk(tree)


_SAFETENSORS_DTYPES = {"F32": np.float32, "F16": np.float16, "F64": np.float64,
                       "BF16": np.uint16}


def read_safetensors(path) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """``(tensors, metadata)`` of a ``.safetensors`` file; BF16 tensors come
    back as float32."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8: 8 + n])
    body = memoryview(data)[8 + n:]
    meta = header.pop("__metadata__", None) or {}
    out = {}
    for name, info in header.items():
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}; "
                             f"read: {sorted(_SAFETENSORS_DTYPES)}")
        begin, end = info["data_offsets"]
        arr = np.frombuffer(body[begin:end], np.dtype(dtype).newbyteorder("<"))
        if info["dtype"] == "BF16":
            arr = _bf16_to_f32(arr)
        out[name] = arr.reshape(info["shape"])
    return out, meta
