"""Reading the JAX package's checkpoint files without JAX, flax or the
`msgpack` package.

Layout (`emsanet_tpu/training/checkpoint.py::save_checkpoint`): the
8-byte magic `EMTP0001`, the length of the JSON metadata as 8 bytes
little-endian, the metadata (epoch, logs, extra), then flax's msgpack
payload of {'params', 'batch_stats', 'opt_state', 'step'}. flax writes
an ndarray as msgpack ext type 1 holding the msgpack array (shape, dtype
name, C-order bytes) and a numpy scalar as ext type 3 in the same form.
`msgpack_restore` is this module's decoder of that format; bfloat16
arrays come back widened to float32, exactly. flax's other forms, a
complex (ext type 2) and an array above 2**30 bytes split into a
'__msgpack_chunked_array__' map, are in no EMSANet checkpoint (its
largest tensor is a few MB) and raise.

The port takes only the model's variables: `read_variables` returns
{'params', 'batch_stats'} as nested dicts of numpy arrays, for
`weights.flax_to_state_dict` and `weights.merge_loaded_params`
(`weights.load_weights_file` dispatches on the magic). The optimizer
state is not carried over: optax's state has no counterpart in a torch
optimizer's, so a JAX file cannot resume a run.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Tuple

import numpy as np

MAGIC = b"EMTP0001"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


def is_jax_checkpoint(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(len(MAGIC)) == MAGIC


def _dtype_array(buffer: bytes, name: str, shape) -> np.ndarray:
    if name == "bfloat16":  # the upper half of a float32
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape).copy()


class _Reader:
    """A msgpack decoder over one bytes object (the subset of the format
    that msgpack's own packer writes, all of it)."""

    def __init__(self, blob: bytes, raw: bool = False):
        self.blob, self.pos, self.raw = blob, 0, raw

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.blob):
            raise ValueError("msgpack: truncated data")
        out = self.blob[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int):
        data = self._take(n)
        return data if self.raw else data.decode("utf-8")

    def _ext(self, code: int, n: int):
        data = self._take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, name, buffer = _Reader(data, raw=True).value()
            if isinstance(name, bytes):
                name = name.decode()
            arr = _dtype_array(buffer, name, tuple(shape))
            return arr[()] if code == _EXT_NPSCALAR else arr
        raise ValueError(f"msgpack: unknown ext type {code}")

    def value(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8 / 16 / 32
            return self._take(self._unpack({0xC4: ">B", 0xC5: ">H",
                                            0xC6: ">I"}[b]))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8 / 16 / 32
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(self._unpack(">b"), n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self._unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self._unpack(">b")
            return self._ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8 / 16 / 32
            return self._str(self._unpack({0xD9: ">B", 0xDA: ">H",
                                           0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            n = self._unpack(">H" if b == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def _map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError("msgpack: a chunked array (above 2**30 bytes)")
        return out


def msgpack_restore(blob: bytes) -> Any:
    """flax's `serialization.msgpack_restore` of `blob`."""
    reader = _Reader(blob)
    tree = reader.value()
    if reader.pos != len(blob):
        raise ValueError(f"msgpack: {len(blob) - reader.pos} bytes after "
                         "the value")
    return tree


def read_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the msgpack payload, the JSON metadata) of a JAX checkpoint."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if not blob.startswith(MAGIC):
        raise ValueError(f"Not an EMSANet-TPU checkpoint: {path}")
    n = int.from_bytes(blob[8:16], "little")
    meta = json.loads(blob[16:16 + n].decode())
    return msgpack_restore(blob[16 + n:]), meta


def read_variables(path: str) -> Dict[str, Any]:
    """{'params', 'batch_stats'} of a JAX checkpoint (numpy leaves)."""
    payload, _ = read_checkpoint(path)
    return {k: payload.get(k, {}) for k in ("params", "batch_stats")}
