"""A msgpack decoder in pure Python, for the flax checkpoints of the JAX
package (``flax.serialization.to_bytes``), with no ``msgpack`` package.

It reads the subset flax writes: maps, arrays, str, bin, ints of every
width, float32/64, nil and bool, and flax's ext types 1 (ndarray), 2
(native complex) and 3 (numpy scalar). An ndarray's ext payload is itself
msgpack of ``(shape, dtype name, raw C-order bytes)``; its array is an
``np.frombuffer`` view of the input's memory (read-only, as flax's), so a
checkpoint of hundreds of MB decodes with no Python loop over its bytes.
Flax's chunked arrays (``{"__msgpack_chunked_array__": True, "shape",
"chunks"}``, written above ``MAX_CHUNK_SIZE``) are joined back into one.

numpy has no ``bfloat16``: such a leaf decodes to a ``torch.bfloat16``
tensor (its bits read as uint16, then viewed).
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

_U8, _U16, _U32, _U64 = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")

# fixed-width scalars by type byte: (struct, width)
_SCALARS = {0xCA: _F32, 0xCB: _F64, 0xCC: _U8, 0xCD: _U16, 0xCE: _U32,
            0xCF: _U64, 0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64}
# (length struct) of str, bin, array, map and ext by type byte
_LEN = {0xD9: _U8, 0xDA: _U16, 0xDB: _U32, 0xC4: _U8, 0xC5: _U16,
        0xC6: _U32, 0xDC: _U16, 0xDD: _U32, 0xDE: _U16, 0xDF: _U32,
        0xC7: _U8, 0xC8: _U16, 0xC9: _U32}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, buf, views: bool = False):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0
        self.views = views  # bin as a view of the input, else bytes

    def _take(self, n: int) -> memoryview:
        start = self.pos
        end = start + n
        if end > len(self.mv):
            raise ValueError(f"msgpack: truncated input at byte {start} "
                             f"(wants {n}, has {len(self.mv) - start})")
        self.pos = end
        return self.mv[start:end]

    def _unpack(self, st: struct.Struct):
        v = st.unpack_from(self.mv, self.pos)[0]
        self.pos += st.size
        return v

    def value(self) -> Any:
        t = self._unpack(_U8)
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self._str(t & 0x1F)
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        if t in _SCALARS:
            return self._unpack(_SCALARS[t])
        if t in _LEN:
            n = self._unpack(_LEN[t])
            if t in (0xD9, 0xDA, 0xDB):
                return self._str(n)
            if t in (0xC4, 0xC5, 0xC6):
                b = self._take(n)
                return b if self.views else bytes(b)
            if t in (0xDC, 0xDD):
                return self._array(n)
            if t in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(n)
        if t in _FIXEXT:
            return self._ext(_FIXEXT[t])
        raise ValueError(f"msgpack: unknown type byte 0x{t:02x} at byte "
                         f"{self.pos - 1}")

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, n: int) -> Any:
        code = self._unpack(_I8)
        payload = self._take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            arr = _ndarray(payload)
            return arr[()] if isinstance(arr, np.ndarray) else arr
        if code == _EXT_COMPLEX:
            re_, im = _Reader(payload).value()
            return complex(re_, im)
        raise ValueError(f"msgpack: unknown ext type {code}")


def _ndarray(payload: memoryview):
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, bytes)."""
    shape, name, raw = _Reader(payload, views=True).value()
    shape = tuple(shape)
    if name == "bfloat16":
        import torch

        bits = np.frombuffer(raw, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _unchunk(d: dict):
    shape: Tuple[int, ...] = tuple(d["shape"][str(i)]
                                   for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if not isinstance(chunks[0], np.ndarray):  # bfloat16 chunks
        import torch

        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(x):
    if isinstance(x, dict):
        if x.get(_CHUNKED) is True:
            return _unchunk(x)
        return {k: _unchunk_tree(v) for k, v in x.items()}
    return x


def unpackb(buf) -> Any:
    """Decode one msgpack object from ``buf`` (bytes-like), with flax's ext
    types and chunked arrays, as ``flax.serialization.msgpack_restore``."""
    r = _Reader(buf)
    out = r.value()
    if r.pos != len(r.mv):
        raise ValueError(f"msgpack: {len(r.mv) - r.pos} bytes after the "
                         "object")
    return _unchunk_tree(out)
