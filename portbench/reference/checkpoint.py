"""Reads the kick policy's checkpoint, a flax msgpack file, for the
reference: a frozen copy of the port's `utils/checkpoint.py` reader (commit
d76e677) and of the flax-to-PyTorch names of `convert.actor_critic`.
"""

from __future__ import annotations

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


def actor_critic_state(path: str, device="cpu"):
    """(state dict of `rl.networks.ActorCritic`, obs RunningMeanStd) of the
    PPO TrainState checkpoint at `path`."""
    import torch

    from portbench.reference.rl.networks import RunningMeanStd

    state = read_msgpack(path)
    params = dict(state["params"]["params"])
    log_std = params.pop("log_std")
    dense = sorted(params, key=lambda k: int(k[len("Dense_"):]))
    names = [f"hidden.{i}" for i in range(len(dense) - 2)] + ["mu", "value"]

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32).copy(),
                               device=device)

    sd = {"log_std": t(log_std)}
    for src, dst in zip(dense, names):
        sd[f"{dst}.weight"] = t(np.asarray(params[src]["kernel"]).T)
        sd[f"{dst}.bias"] = t(params[src]["bias"])
    rms = state["obs_rms"]
    return sd, RunningMeanStd(t(rms["mean"]), t(rms["var"]), t(rms["count"]))
