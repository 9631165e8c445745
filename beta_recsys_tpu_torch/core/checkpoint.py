"""Reading the JAX package's checkpoints without flax or msgpack.

A checkpoint directory holds ``metadata.json`` and ``checkpoint.msgpack``,
the state tree written by ``flax.serialization.to_bytes``
(``beta_recsys_tpu/core/checkpoint.py``). ``msgpack_restore`` here decodes
the same bytes into the same tree as ``flax.serialization.msgpack_restore``:
maps become dicts (so a list of blocks arrives as a dict keyed "0", "1", ...),
arrays become lists, and flax's extension types become numpy values:

- ext code 1: an ndarray, whose payload is itself msgpack
  ``(shape, dtype name, C-order bytes)``;
- ext code 3: a numpy scalar, packed the same way as a 0-d array.
"""

import json
import os
import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def load_metadata(ckpt_dir, name="metadata.json"):
    with open(os.path.join(ckpt_dir, name)) as f:
        return json.load(f)


def load_raw_checkpoint(ckpt_dir, name="checkpoint.msgpack"):
    """The checkpoint's whole state tree (params, opt_state, rng, ...)."""
    with open(os.path.join(ckpt_dir, name), "rb") as f:
        return msgpack_restore(f.read())


def msgpack_restore(data):
    value, end = _Reader(data, raw=False).read(0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes after the msgpack object")
    return value


class _Reader:
    """Recursive-descent msgpack decoder. ``raw=True`` leaves str payloads as
    bytes, as flax decodes an ndarray's inner triple."""

    def __init__(self, data, raw):
        self.buf = memoryview(data)
        self.raw = raw

    def _take(self, pos, n):
        end = pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        return self.buf[pos:end], end

    def _unpack(self, fmt, pos):
        chunk, end = self._take(pos, struct.calcsize(fmt))
        return struct.unpack(fmt, chunk)[0], end

    def _str(self, pos, n):
        chunk, end = self._take(pos, n)
        return (bytes(chunk) if self.raw else str(chunk, "utf-8")), end

    def _bin(self, pos, n):
        chunk, end = self._take(pos, n)
        return bytes(chunk), end

    def _array(self, pos, n):
        out = []
        for _ in range(n):
            value, pos = self.read(pos)
            out.append(value)
        return out, pos

    def _map(self, pos, n):
        out = {}
        for _ in range(n):
            key, pos = self.read(pos)
            out[key], pos = self.read(pos)
        return out, pos

    def _ext(self, pos, n):
        code, pos = self._unpack(">b", pos)
        payload, pos = self._bin(pos, n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        (shape, dtype_name, buffer), end = _Reader(payload, raw=True).read(0)
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode("ascii")
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape, order="C")
        return (arr if code == _EXT_NDARRAY else arr[()]), pos

    def read(self, pos):
        (b,), pos = self._take(pos, 1)
        if b <= 0x7F:
            return b, pos
        if b >= 0xE0:
            return b - 0x100, pos
        if 0x80 <= b <= 0x8F:
            return self._map(pos, b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(pos, b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(pos, b & 0x1F)
        if b == 0xC0:
            return None, pos
        if b == 0xC2:
            return False, pos
        if b == 0xC3:
            return True, pos
        if b in _LENGTHS:
            kind, fmt = _LENGTHS[b]
            n, pos = self._unpack(fmt, pos)
            return getattr(self, kind)(pos, n)
        if b in _SCALARS:
            return self._unpack(_SCALARS[b], pos)
        if b in _FIXEXT:
            return self._ext(pos, _FIXEXT[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


# type byte -> (decoder method, big-endian length format)
_LENGTHS = {
    0xC4: ("_bin", ">B"), 0xC5: ("_bin", ">H"), 0xC6: ("_bin", ">I"),
    0xC7: ("_ext", ">B"), 0xC8: ("_ext", ">H"), 0xC9: ("_ext", ">I"),
    0xD9: ("_str", ">B"), 0xDA: ("_str", ">H"), 0xDB: ("_str", ">I"),
    0xDC: ("_array", ">H"), 0xDD: ("_array", ">I"),
    0xDE: ("_map", ">H"), 0xDF: ("_map", ">I"),
}
# type byte -> big-endian struct format of a number
_SCALARS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
# fixext type byte -> payload length
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
