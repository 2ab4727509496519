# ported from vidsum_tpu/train/checkpoint.py (the reader of its files: the
# JAX package reads them with flax.serialization.msgpack_restore)
"""A plain-Python reader of the JAX package's checkpoints.

``vidsum_tpu/train/checkpoint.py`` writes ``flax.serialization.to_bytes``
output: msgpack of the tree's state dict (maps with string keys; lists and
tuples become maps keyed ``"0"``, ``"1"``, ...), array leaves as msgpack
extension type 1 and numpy scalars as type 3, each carrying a msgpack
``(shape, dtype name, C-order bytes)`` triple. :func:`restore` decodes that
subset into the tree ``flax.serialization.msgpack_restore`` gives: dicts,
lists, str, bytes, int, float, None, bool, numpy arrays and scalars
(read-only views of ``data``). ``bfloat16`` arrays come back as
``torch.bfloat16`` tensors (read as uint16 and viewed), since numpy has no
such dtype. What this subset leaves out raises ``ValueError`` naming it:
extension type 2 (a Python complex), other extension types, and flax's
``__msgpack_chunked_array__`` maps (arrays over 1 GiB).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width scalars: first byte -> (struct format, size)
_SCALARS = {
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
# length-prefixed objects: first byte -> (kind, width of the length)
_SIZED = {
    0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
    0xc7: ("ext", 1), 0xc8: ("ext", 2), 0xc9: ("ext", 4),
    0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
    0xdc: ("array", 2), 0xdd: ("array", 4),
    0xde: ("map", 2), 0xdf: ("map", 4),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data) -> None:
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, size: int):
        return struct.unpack(fmt, self.take(size))[0]

    def value(self) -> Any:
        b = self.unpack(">B", 1)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b <= 0x8f:
            return self.map(b & 0x0f)
        if b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self.unpack(*_SCALARS[b])
        if b in _FIXEXT:
            return self.ext(self.unpack(">b", 1), _FIXEXT[b])
        if b not in _SIZED:
            raise ValueError(f"msgpack byte 0x{b:02x} is not valid")
        kind, width = _SIZED[b]
        n = self.unpack(_UINT[width], width)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        return self.ext(self.unpack(">b", 1), n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError(
                "a flax __msgpack_chunked_array__ (an array leaf over 1 GiB) "
                "is not supported by this reader")
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            raise ValueError("msgpack extension type 2 (a Python complex) is "
                             "not supported by this reader")
        raise ValueError(f"msgpack extension type {code} is not supported "
                         f"by this reader")


def _ndarray(payload: memoryview):
    """flax's ``_ndarray_from_bytes``: a msgpack (shape, dtype, bytes)."""
    r = _Reader(payload)
    shape, dtype, data = r.value()
    if r.pos != len(payload):
        raise ValueError("trailing bytes in an ndarray payload")
    if dtype == "bfloat16":
        arr = np.frombuffer(data, np.uint16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return np.frombuffer(data, np.dtype(dtype)).reshape(shape)


def restore(data) -> Any:
    """Decode ``flax.serialization.to_bytes`` output (bytes or any buffer)
    into its state-dict tree."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after the "
                         f"msgpack object")
    return tree


def is_msgpack_map(head: bytes) -> bool:
    """True if ``head`` starts a msgpack map (fixmap, map16, map32): the
    first byte of every checkpoint the JAX package writes."""
    return bool(head) and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf))


def lists_from_dicts(tree: Any) -> Any:
    """Turn the maps flax made of lists and tuples (keys ``"0"`` ..
    ``"n-1"``, n >= 1) back into lists, recursively."""
    if isinstance(tree, dict):
        out = {k: lists_from_dicts(v) for k, v in tree.items()}
        if out and set(out) == {str(i) for i in range(len(out))}:
            return [out[str(i)] for i in range(len(out))]
        return out
    return tree
