"""The part of the msgpack format that Flax checkpoints use, in pure Python.

The JAX package writes PRVNet checkpoints with
``flax.serialization.msgpack_serialize`` and reads them with
``msgpack_restore``.  This module reads and writes the same bytes without
``msgpack`` or ``flax``:

- maps, arrays, str, bin, ints, float64, bool and nil;
- ext type 1 (``ndarray``): a nested msgpack array ``(shape, dtype name,
  C-order bytes)``;
- ext type 3 (``npscalar``): a numpy scalar, packed as a 0-d ndarray;
- Flax's chunked leaves: an array larger than :data:`MAX_CHUNK_SIZE` bytes
  in a dict is written as ``{"__msgpack_chunked_array__": True, "shape":
  {"0": d0, ...}, "chunks": {"0": flat0, ...}}`` and joined back on read.

:func:`serialize` emits the bytes ``msgpack_serialize`` emits for the same
tree (the shortest encoding of every value, as ``msgpack.packb`` chooses
it), and :func:`restore` returns what ``msgpack_restore`` returns.
Anything else (float32 values, ext type 2 ``native_complex``, other ext
types, bfloat16 arrays, tuples outside an ndarray's header) raises and
names the type.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np

# flax.serialization.MAX_CHUNK_SIZE: leaves over this many bytes are chunked
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# --- writing ---------------------------------------------------------------

def _head(out: List[bytes], n: int, fix: int, fix_max: int, codes: tuple) -> None:
    """A length header: the fix form below ``fix_max``, else the 8 / 16 /
    32-bit form (``codes`` holds their type bytes; None where the form does
    not exist)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
    elif codes[0] is not None and n < 2**8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 2**16:
        out.append(struct.pack(">BH", codes[1], n))
    elif n < 2**32:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack: length {n} is over 2**32 - 1")


def _int(out: List[bytes], v: int) -> None:
    if 0 <= v < 128:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">BB", 2**8), (0xCD, ">BH", 2**16), (0xCE, ">BI", 2**32), (0xCF, ">BQ", 2**64)):
            if v < top:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(f"msgpack: int {v} is too large")
    else:
        for code, fmt, low in ((0xD0, ">Bb", -(2**7)), (0xD1, ">Bh", -(2**15)), (0xD2, ">Bi", -(2**31)),
                               (0xD3, ">Bq", -(2**63))):
            if v >= low:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(f"msgpack: int {v} is too small")


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """Flax's ``_ndarray_to_bytes``: ``(shape, dtype name, C-order bytes)``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct or arr.dtype.names is not None:
        raise ValueError(f"msgpack: arrays of dtype {arr.dtype} are not supported")
    out: List[bytes] = []
    _head(out, 3, 0x90, 16, (None, 0xDC, 0xDD))
    _head(out, arr.ndim, 0x90, 16, (None, 0xDC, 0xDD))
    for d in arr.shape:
        _int(out, int(d))
    _pack(out, arr.dtype.name)
    _pack(out, arr.tobytes("C"))
    return b"".join(out)


def _ext(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    elif n < 2**8:
        out.append(struct.pack(">BBB", 0xC7, n, code))
    elif n < 2**16:
        out.append(struct.pack(">BHB", 0xC8, n, code))
    elif n < 2**32:
        out.append(struct.pack(">BIB", 0xC9, n, code))
    else:
        raise ValueError(f"msgpack: an ext payload of {n} bytes is over 2**32 - 1")
    out.append(data)


def _pack(out: List[bytes], x: Any) -> None:
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _int(out, x)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif t is str:
        b = x.encode("utf-8")
        _head(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(b)
    elif t is bytes:
        _head(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(x)
    elif t is dict:
        _head(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif t is list:
        _head(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, np.ndarray):
        _ext(out, _EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    else:
        raise TypeError(f"msgpack: cannot serialize a {t.__name__} ({t.__module__}.{t.__qualname__})")


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {
        _CHUNKED: True,
        "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
        "chunks": {str(i): flat[s:s + size] for i, s in enumerate(range(0, flat.size, size))},
    }


def _prepare(tree, chunkable: bool = True):
    """The copy ``msgpack_serialize`` packs: every dict's keys sorted (its
    ``jax.tree_util.tree_map`` copy sorts them), and, as Flax's
    ``_chunk_array_leaves_in_place``, dict values (and a bare top-level
    array) over MAX_CHUNK_SIZE bytes turned into chunk dicts."""
    if isinstance(tree, np.ndarray):
        return _chunk(tree) if chunkable and tree.nbytes > MAX_CHUNK_SIZE else tree
    if isinstance(tree, dict):
        return {k: _prepare(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_prepare(v, False) for v in tree]
    return tree


def serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(tree)`` writes for a
    tree of dicts and lists with ndarray, numpy-scalar and Python leaves."""
    out: List[bytes] = []
    _pack(out, _prepare(tree))
    return b"".join(out)


# --- reading ---------------------------------------------------------------

_EXT_NAMES = {_EXT_NDARRAY: "ndarray", _EXT_COMPLEX: "native_complex", _EXT_NPSCALAR: "npscalar"}


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str values as bytes (flax reads an ndarray's header so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated data at byte {self.pos}")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from(data)[()]
        raise ValueError(f"msgpack: ext type {code} ({_EXT_NAMES.get(code, 'unknown')}) is not supported")

    def value(self):
        c = self.unpack(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map_(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.str_(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in ints:
            return self.unpack(ints[c])
        if c == 0xCB:
            return self.unpack(">d")
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if c in lengths:
            n = self.unpack(lengths[c])
            if c <= 0xC6:
                return bytes(self.take(n))
            if c <= 0xC9:
                return self.ext(n)
            if c <= 0xDB:
                return self.str_(n)
            if c <= 0xDD:
                return [self.value() for _ in range(n)]
            return self.map_(n)
        if 0xD4 <= c <= 0xD8:
            return self.ext(1 << (c - 0xD4))
        names = {0xC1: "the never-used code 0xc1", 0xCA: "float32"}
        raise ValueError(f"msgpack: {names.get(c, f'code {c:#x}')} is not supported")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ndarray_from(data: bytes) -> np.ndarray:
    """Flax's ``_ndarray_from_bytes``."""
    r = _Reader(data, raw=True)
    shape, name, buf = r.value()
    if name == b"bfloat16":
        raise ValueError("msgpack: bfloat16 arrays are not supported")
    return np.frombuffer(buf, dtype=np.dtype(name.decode("ascii"))).reshape(shape, order="C")


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def restore(data: bytes):
    """What ``flax.serialization.msgpack_restore(data)`` returns: the tree,
    chunked leaves joined."""
    r = _Reader(data, raw=False)
    tree = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the first value")
    return _unchunk_leaves(tree)
