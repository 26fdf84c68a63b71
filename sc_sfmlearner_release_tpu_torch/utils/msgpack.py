"""MessagePack with flax's extension types, in Python and numpy.

The port's own reader and writer of the JAX package's ``.msgpack`` files
(``flax.serialization.to_bytes`` / ``msgpack_restore``), for machines with
neither flax nor the ``msgpack`` package. It covers what flax writes: nil,
bool, integers of every width, float32/64, str, bin 8/16/32, array and map
of every width, and ext. Ext type 1 is an ndarray (its payload is
``packb((shape, dtype.name, raw bytes))``), 3 a numpy scalar in the same
form, 2 a complex number, which this reader refuses. Arrays over
:data:`MAX_CHUNK_SIZE` bytes are written as flax's chunked maps
(``__msgpack_chunked_array__``) and read back whole.

:func:`packb` gives flax's bytes for the same tree in the same key order.
:func:`unpackb` returns numpy arrays that are zero-copy views into the
buffer it is given (writable when the buffer is, as a ``bytearray``), so
they keep the whole buffer alive; ``bfloat16`` arrays, which numpy lacks,
come back as torch ``bfloat16`` tensors. Anything else raises with the
byte offset.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
# flax.serialization.MAX_CHUNK_SIZE: msgpack caps an object at 2**31 - 1 bytes.
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
NUMERIC_KINDS = "biufc"

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")


# ---------------------------------------------------------------- writing


def _int(v: int) -> bytes:
    if v >= 0:
        if v < 0x80:
            return _B.pack(v)
        if v <= 0xFF:
            return b"\xcc" + _B.pack(v)
        if v <= 0xFFFF:
            return b"\xcd" + _H.pack(v)
        if v <= 0xFFFFFFFF:
            return b"\xce" + _I.pack(v)
        if v <= 0xFFFFFFFFFFFFFFFF:
            return b"\xcf" + _Q.pack(v)
    else:
        if v >= -32:
            return _b.pack(v)
        if v >= -0x80:
            return b"\xd0" + _b.pack(v)
        if v >= -0x8000:
            return b"\xd1" + _h.pack(v)
        if v >= -0x80000000:
            return b"\xd2" + _i.pack(v)
        if v >= -0x8000000000000000:
            return b"\xd3" + _q.pack(v)
    raise OverflowError(f"integer {v} does not fit 64 bits")


def _sized(n: int, fix: int, fix_max: int, codes: bytes) -> bytes:
    """The header of a str, array or map of ``n`` items (``fix`` | n up to
    ``fix_max``, else 8-bit (str only), 16-bit or 32-bit lengths)."""
    if n <= fix_max:
        return _B.pack(fix | n)
    for code, fmt, top in zip(codes, (_B, _H, _I), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= top:
            return bytes([code]) + fmt.pack(n)
    raise ValueError(f"{n} items exceed msgpack's 32-bit length")


def _str(s: str) -> List[bytes]:
    raw = s.encode("utf-8")
    return [_sized(len(raw), 0xA0, 31, b"\xd9\xda\xdb"), raw]


def _bin(n: int) -> bytes:
    for code, fmt, top in ((0xC4, _B, 0xFF), (0xC5, _H, 0xFFFF), (0xC6, _I, 0xFFFFFFFF)):
        if n <= top:
            return bytes([code]) + fmt.pack(n)
    raise ValueError(f"bin of {n} bytes exceeds msgpack's 32-bit length")


def _ext(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    for head, fmt, top in ((0xC7, _B, 0xFF), (0xC8, _H, 0xFFFF), (0xC9, _I, 0xFFFFFFFF)):
        if n <= top:
            return bytes([head]) + fmt.pack(n) + bytes([code])
    raise ValueError(f"ext of {n} bytes exceeds msgpack's 32-bit length")


def _raw_array(x):
    """(shape, dtype name, contiguous bytes view) of an array."""
    x = np.asarray(x, order="C")  # ascontiguousarray would make a 0-d array 1-d
    if x.dtype.kind not in NUMERIC_KINDS and x.dtype.name != "bfloat16":  # ml_dtypes'
        raise TypeError(f"cannot pack an array of dtype {x.dtype}")
    return x.shape, x.dtype.name, memoryview(x.reshape(-1).view(np.uint8))


def _pack_array(code: int, x, out: List) -> None:
    shape, name, raw = _raw_array(x)
    head = [b"\x93", _sized(len(shape), 0x90, 15, b"\x00\xdc\xdd")]
    head += [_int(int(d)) for d in shape]
    head += _str(name)
    head.append(_bin(len(raw)))
    inner = b"".join(head)
    out.append(_ext(code, len(inner) + len(raw)))
    out.append(inner)
    out.append(raw)


def _pack(x, out: List) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(b"\xcb" + _d.pack(x))
    elif type(x) is str:
        out.extend(_str(x))
    elif type(x) in (bytes, bytearray, memoryview):
        raw = memoryview(x).cast("B")
        out.append(_bin(len(raw)))
        out.append(raw)
    elif type(x) in (list, tuple):
        out.append(_sized(len(x), 0x90, 15, b"\x00\xdc\xdd"))
        for v in x:
            _pack(v, out)
    elif type(x) is dict:
        out.append(_sized(len(x), 0x80, 15, b"\x00\xde\xdf"))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        _pack_array(EXT_NDARRAY, x, out)
    elif isinstance(x, np.generic):
        _pack_array(EXT_NPSCALAR, np.asarray(x), out)
    else:
        raise TypeError(f"cannot pack {type(x).__name__}")


def _chunk(x: np.ndarray) -> dict:
    """flax's ``_chunk``: a flat array cut into pieces of MAX_CHUNK_SIZE bytes."""
    flat = x.reshape(-1)
    size = max(1, MAX_CHUNK_SIZE // x.dtype.itemsize)
    pieces = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(pieces)}}


def _chunked(tree):
    """flax's ``_chunk_array_leaves_in_place`` without the in place: arrays
    over MAX_CHUNK_SIZE bytes, at the top or in dicts, become chunked maps."""
    if isinstance(tree, dict):
        return {k: _chunked(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def pack_parts(tree) -> List:
    """The encoding of ``tree`` as a list of byte strings and views, in
    order (the array payloads are views of the arrays, not copies), for a
    caller that writes them out one by one."""
    out: List = []
    _pack(_chunked(tree), out)
    return out


def packb(tree) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``: dicts (str keys),
    lists, tuples, None, bool, int, float, str, bytes, numpy arrays and
    scalars."""
    return b"".join(pack_parts(tree))


# ---------------------------------------------------------------- reading


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def fail(self, msg: str, at: int) -> ValueError:
        return ValueError(f"msgpack: {msg} at byte {at}")

    def take(self, n: int) -> memoryview:
        start, end = self.pos, self.pos + n
        if end > len(self.buf):
            raise self.fail(f"{n} bytes asked, {len(self.buf) - start} left", start)
        self.pos = end
        return self.buf[start:end]

    def num(self, fmt: struct.Struct):
        start = self.pos
        if start + fmt.size > len(self.buf):
            raise self.fail("truncated header", start)
        self.pos += fmt.size
        return fmt.unpack_from(self.buf, start)[0]

    def obj(self) -> Any:
        at = self.pos
        c = self.num(_B)
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.str(c & 0x1F, at)
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.num((_B, _H, _I)[c - 0xC4])))
        if c in (0xC7, 0xC8, 0xC9):
            return self.ext(self.num((_B, _H, _I)[c - 0xC7]), at)
        if c == 0xCA:
            return self.num(_f)
        if c == 0xCB:
            return self.num(_d)
        if 0xCC <= c <= 0xD3:
            return self.num((_B, _H, _I, _Q, _b, _h, _i, _q)[c - 0xCC])
        if 0xD4 <= c <= 0xD8:
            return self.ext(1 << (c - 0xD4), at)
        if c in (0xD9, 0xDA, 0xDB):
            return self.str(self.num((_B, _H, _I)[c - 0xD9]), at)
        if c in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.num((_H, _I)[c - 0xDC]))]
        if c in (0xDE, 0xDF):
            return self.map(self.num((_H, _I)[c - 0xDE]))
        raise self.fail(f"unknown type byte 0x{c:02x}", at)  # 0xc1: never used

    def str(self, n: int, at: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as exc:
            raise self.fail(f"invalid UTF-8 string ({exc.reason})", at) from None

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            at = self.pos
            key = self.obj()
            if isinstance(key, (dict, list)):
                raise self.fail("unhashable map key", at)
            out[key] = self.obj()
        return out

    def ext(self, n: int, at: int):
        code = self.num(_B)
        end = self.pos + n
        if code == EXT_COMPLEX:
            raise self.fail("complex number (ext 2) met; the port reads arrays only", at)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise self.fail(f"unknown ext type {code}", at)
        arr = self.array(at)
        if self.pos != end:
            raise self.fail(f"ext payload of {n} bytes holds {self.pos - end + n}", at)
        return arr[()] if code == EXT_NPSCALAR else arr

    def array(self, at: int):
        """flax's ``_ndarray_from_bytes``: ``[shape, dtype name, bytes]``."""
        c = self.num(_B)
        if c != 0x93:
            raise self.fail("ndarray payload is not a 3-item array", at)
        shape = self.obj()
        name = self.obj()
        raw_at = self.pos
        c = self.num(_B)
        if not (isinstance(shape, list) and all(type(d) is int and d >= 0 for d in shape)
                and isinstance(name, str) and c in (0xC4, 0xC5, 0xC6)):
            raise self.fail(f"malformed ndarray header (shape {shape!r}, dtype {name!r})", at)
        raw = self.take(self.num((_B, _H, _I)[c - 0xC4]))
        count = int(np.prod(shape, dtype=np.int64))
        if name == "bfloat16":
            if len(raw) != 2 * count:
                raise self.fail(f"bfloat16{shape}: {len(raw)} bytes", raw_at)
            bits = np.frombuffer(raw, np.int16).copy()
            return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
        dtype = _dtype(name)
        if dtype is None:
            raise self.fail(f"unsupported ndarray dtype {name!r}", at)
        if len(raw) != count * dtype.itemsize:
            raise self.fail(f"{name}{shape}: {len(raw)} bytes", raw_at)
        return np.frombuffer(raw, dtype).reshape(shape)


def _dtype(name: str):
    """The little-endian numpy dtype that ``dtype.name`` names exactly, or
    None (flax writes native, little-endian, bytes)."""
    try:
        dtype = np.dtype(name)
    except TypeError:
        return None
    if dtype.name != name or dtype.kind not in NUMERIC_KINDS:
        return None
    return dtype.newbyteorder("<")


def _unchunk(node):
    """flax's ``_unchunk_array_leaves_in_place``: chunked maps (at the top
    or in dicts) become the arrays they cut up."""
    if not isinstance(node, dict):
        return node
    if CHUNKED in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        if any(isinstance(c, torch.Tensor) for c in chunks):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def unpackb(buf) -> Any:
    """``flax.serialization.msgpack_restore(buf)``: the tree, with ndarrays
    as zero-copy numpy views into ``buf`` (bfloat16 as torch tensors) and
    chunked arrays joined. Raises ``ValueError`` naming the byte offset on
    anything it cannot read, trailing bytes included."""
    reader = _Reader(buf)
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise reader.fail(f"{len(reader.buf) - reader.pos} trailing bytes", reader.pos)
    return _unchunk(tree)
