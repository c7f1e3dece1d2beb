"""Checkpoints in the JAX package's flax msgpack format, without flax.

Port of `bez_isaacgym_tpu/utils/checkpoint.py`.  The JAX package writes a
training state with `flax.serialization.to_bytes`: msgpack of a nested state
dict whose array leaves are msgpack extension objects.  `read_msgpack`
decodes that format here and `save` writes it, so serving, resuming and
writing a checkpoint need neither flax nor the msgpack package, and the
JAX package's `flax.serialization.from_bytes` loads what the port writes:

- ext type 1: an ndarray, payload msgpack of (shape, dtype name, C-order
  bytes);
- ext type 3: a numpy scalar, the same payload with shape ();
- ext type 2: a Python complex, payload msgpack of (real, imag);
- any other ext type comes back as `ExtType(code, data)`.

Tuples come back as dicts keyed "0", "1", ... as flax writes them.  Arrays
that flax split into chunks (leaves over 2**30 bytes) are refused, and not
written.  `packb` encodes as msgpack-python does (the smallest form of each
integer, floats as float64, str and bin types), so a file read and written
again keeps its bytes.
"""

from __future__ import annotations

import os
import re
import struct
from typing import NamedTuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    """An extension object of a type flax does not write, kept as is (as
    flax's reader keeps it, in msgpack's ExtType)."""

    code: int
    data: bytes


class _Reader:
    """Decoder for the msgpack subset flax writes (spec: msgpack.org)."""

    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw        # str8/16/32 as bytes (flax's ndarray payload)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            return _ndarray_from_bytes(payload)
        if code == _EXT_COMPLEX:
            re_, im = _Reader(payload, raw=False).value()
            return complex(re_, im)
        return ExtType(code, payload)

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        if b in (0xC4, 0xC5, 0xC6):                        # bin 8/16/32
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xC4])))
        if b in (0xD9, 0xDA, 0xDB):                        # str 8/16/32
            return self.text(self.unpack(">" + "BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):                              # array 16/32
            return self.array(self.unpack(">" + "HI"[b - 0xDC]))
        if b in (0xDE, 0xDF):                              # map 16/32
            return self.map(self.unpack(">" + "HI"[b - 0xDE]))
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):            # fixext 1..16
            code = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xC7, 0xC8, 0xC9):                        # ext 8/16/32
            n = self.unpack(">" + "BHI"[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        raise ValueError(f"msgpack: unsupported format byte 0x{b:02x}")


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = _Reader(payload, raw=True).value()
    dtype = np.dtype(dtype_name.decode("ascii"))
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def _refuse_chunked(tree, path="") -> None:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            raise ValueError(
                f"checkpoint leaf {path or '/'} is a chunked array (a leaf "
                "over 2**30 bytes); chunked arrays are not supported")
        for k, v in tree.items():
            _refuse_chunked(v, f"{path}/{k}")


def unpackb(data: bytes):
    """Decode one msgpack object (flax's state dict) from bytes."""
    reader = _Reader(data, raw=False)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the first object")
    _refuse_chunked(out)
    return out


def read_msgpack(path: str):
    """A flax msgpack checkpoint as a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def _head(fmts: tuple, n: int, fix: int | None = None,
          fix_max: int = -1) -> bytes:
    """A msgpack length header: the fix form below fix_max, else the first
    of fmts (code, struct format, largest n) that holds n."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in fmts:
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARRAY = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF))


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    for code, fmt, lo, hi in ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF),
                              (0xCE, ">I", 0, 0xFFFFFFFF),
                              (0xCF, ">Q", 0, 0xFFFFFFFFFFFFFFFF),
                              (0xD0, ">b", -0x80, 0x7F),
                              (0xD1, ">h", -0x8000, 0x7FFF),
                              (0xD2, ">i", -0x80000000, 0x7FFFFFFF),
                              (0xD3, ">q", -2**63, 2**63 - 1)):
        if lo <= v <= hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: integer {v} out of range")


def _ndarray_to_bytes(a: np.ndarray) -> bytes:
    """flax's ndarray payload: msgpack of (shape, dtype name, C bytes)."""
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError(f"msgpack: cannot write an array of {a.dtype}")
    if a.nbytes > 2**30:
        raise ValueError("msgpack: a leaf over 2**30 bytes would be chunked;"
                         " chunked arrays are not supported")
    return packb((tuple(int(d) for d in a.shape), a.dtype.name,
                  a.tobytes("C")))


def packb(obj) -> bytes:
    """Encode a nested dict / list / tuple of str, bytes, bool, int, float,
    None, numpy arrays (ext 1) and numpy scalars (ext 3) as msgpack."""
    out = bytearray()

    def put(x):
        if x is None:
            out.append(0xC0)
        elif x is True or x is False:
            out.append(0xC3 if x else 0xC2)
        elif type(x) is int:
            out.extend(_int(x))
        elif type(x) is float:
            out.extend(b"\xcb" + struct.pack(">d", x))
        elif type(x) is str:
            b = x.encode("utf-8")
            out.extend(_head(_STR, len(b), 0xA0, 31) + b)
        elif type(x) is bytes:
            out.extend(_head(_BIN, len(x)) + x)
        elif type(x) in (list, tuple):
            out.extend(_head(_ARRAY, len(x), 0x90, 15))
            for v in x:
                put(v)
        elif type(x) is dict:
            out.extend(_head(_MAP, len(x), 0x80, 15))
            for k, v in x.items():
                put(k)
                put(v)
        elif isinstance(x, (np.ndarray, np.generic)):
            code = _EXT_NDARRAY if isinstance(x, np.ndarray) \
                else _EXT_NPSCALAR
            data = _ndarray_to_bytes(np.asarray(x))
            n = len(data)
            head = bytes([_FIXEXT[n]]) if n in _FIXEXT else _head(_EXT, n)
            out.extend(head + struct.pack(">b", code) + data)
        else:
            raise TypeError(f"msgpack: cannot write {type(x).__name__}")

    put(obj)
    return bytes(out)


def save(path: str, train_state) -> None:
    """Write the port's PPO `TrainState` in the JAX package's TrainState
    layout (`convert.flax_train_state`), as `flax.serialization.to_bytes`
    would."""
    from bez_isaacgym_tpu_torch import convert

    data = packb(convert.flax_train_state(train_state))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def checkpoint_name(run_name: str, epoch: int, reward: float) -> str:
    return f"{run_name}_{epoch}_rew_{reward:.2f}.ckpt"


def latest(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    ckpts = [f for f in os.listdir(directory) if f.endswith(".ckpt")]
    if not ckpts:
        return None

    def epoch_of(name):
        m = re.search(r"_(\d+)_rew", name)
        return int(m.group(1)) if m else -1

    return os.path.join(directory, max(ckpts, key=epoch_of))
