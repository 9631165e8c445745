"""Reading and writing the JAX package's checkpoints without flax or msgpack.

A checkpoint directory holds ``metadata.json`` and ``checkpoint.msgpack``,
the state tree written by ``flax.serialization.to_bytes``
(``beta_recsys_tpu/core/checkpoint.py``). ``msgpack_restore`` here decodes
the same bytes into the same tree as ``flax.serialization.msgpack_restore``:
maps become dicts (so a list of blocks arrives as a dict keyed "0", "1", ...),
arrays become lists, and flax's extension types become numpy values:

- ext code 1: an ndarray, whose payload is itself msgpack
  ``(shape, dtype name, C-order bytes)``;
- ext code 3: a numpy scalar, packed the same way as a 0-d array.

``msgpack_serialize`` writes a tree of dicts, lists, numbers, strings and
numpy arrays as ``flax.serialization.msgpack_serialize`` does (arrays as ext
code 1), so the JAX package reads what the port writes.

``system.checkpoint_backend`` may be "flax" (this msgpack file) or absent.
The JAX package's "orbax" backend writes an ``orbax_state/`` directory
through orbax, which the card's machine does not have: that backend raises
``NotImplementedError``, on writing and on reading, and is not to be ported.
"""

import json
import os
import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


_ORBAX_SUBDIR = "orbax_state"


def check_backend(backend):
    """Raise unless ``backend`` is "flax" or None (the msgpack file)."""
    if backend == "orbax":
        raise NotImplementedError(
            "checkpoint_backend 'orbax' is not ported: the port has no orbax and writes the JAX package's "
            "'flax' msgpack file; set system.checkpoint_backend to 'flax' or leave it out"
        )
    if backend not in (None, "flax"):
        raise ValueError(f"unknown checkpoint_backend {backend!r}; use 'flax'")


def save_checkpoint(ckpt_dir, state, name="checkpoint.msgpack", backend="flax"):
    """Write a tree of dicts and numpy arrays as ``checkpoint.msgpack``."""
    check_backend(backend)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, name)
    with open(path, "wb") as f:
        f.write(msgpack_serialize(state))
    return path


def save_metadata(ckpt_dir, metadata, name="metadata.json"):
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, name), "w") as f:
        json.dump(metadata, f, indent=2)


def load_metadata(ckpt_dir, name="metadata.json"):
    with open(os.path.join(ckpt_dir, name)) as f:
        return json.load(f)


def load_raw_checkpoint(ckpt_dir, name="checkpoint.msgpack", backend=None):
    """The checkpoint's whole state tree (params, opt_state, rng, ...). A
    directory that holds only an orbax checkpoint raises, as does
    ``backend="orbax"``."""
    check_backend(backend)
    path = os.path.join(ckpt_dir, name)
    if not os.path.exists(path) and os.path.isdir(os.path.join(ckpt_dir, _ORBAX_SUBDIR)):
        check_backend("orbax")
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def msgpack_restore(data):
    value, end = _Reader(data, raw=False).read(0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes after the msgpack object")
    return value


def msgpack_serialize(tree):
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def _header(out, n, fix_base, fix_max, sized):
    """A length header: the fix form below ``fix_max``, else the smallest of
    ``sized`` ((type byte, struct format, limit), ...) that holds ``n``."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
        return
    for byte, fmt, limit in sized:
        if n < limit:
            out.append(byte)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} is too large for msgpack")


def _pack(obj, out):
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            out += b"\xcf" + struct.pack(">Q", obj)
        else:
            out += b"\xd3" + struct.pack(">q", obj)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 32, ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32)))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _header(out, len(obj), None, 0, ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32)))
        out += obj
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32)))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32)))
        for value in obj:
            _pack(value, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        payload = bytearray()
        _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], payload)
        _header(out, len(payload), None, 0, ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32)))
        out += struct.pack(">b", _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR)
        out += payload
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


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
