"""Checkpoints: whole training runners, and policy parameters in flax's format.

Counterpart of ``pdecontrolgym_tpu/utils/checkpointing.py``. The JAX package
saves a runner with orbax; here :func:`save` and :func:`restore` pickle the
whole runner with ``torch.save``: the networks, the optimizers' state, the
generator, the envs' state and, for SAC, the replay ring, so that training
resumes where it stopped.

:func:`load_params` and :func:`save_params` read and write the msgpack files
that ``flax.serialization.to_bytes`` writes (``examples/checkpoints/``), with
a small msgpack codec of their own in pure Python: no ``msgpack`` and no
``flax`` are needed. The files hold nested maps of string keys whose leaves
are numpy arrays, each stored as flax stores it: msgpack ext type 1, whose
payload is the msgpack triple ``(shape, dtype name, C-order bytes)``. The
codec takes maps, arrays, strings, binary, nil, booleans, ints, floats and
ext type 1. It does not take flax's chunked arrays (the dict form flax writes
for a leaf past 2**30 bytes) nor its other ext types (scalars, complex), and
it raises on them.
"""

from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np
import torch

_EXT_NDARRAY = 1


def save(path: str, runner: Any) -> None:
    """Save a whole runner (``PPOTrainer``'s ``Runner``, a ``SACRunner``)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(runner, path)


def restore(path: str, like: Any) -> Any:
    """Load a runner saved by :func:`save` onto the device of ``like`` (a
    runner of the same kind, e.g. a fresh ``trainer.init(seed)``). The file
    is unpickled: load only checkpoints this program wrote."""
    runner = torch.load(os.path.abspath(path), map_location=like.obs.device,
                        weights_only=False)
    if type(runner) is not type(like):
        raise TypeError(f"{path} holds a {type(runner).__name__}, "
                        f"not a {type(like).__name__}")
    return runner


def load_params(path: str) -> dict:
    """Read a flax msgpack parameter file into nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        data = f.read()
    tree, end = _decode(data, 0)
    if end != len(data):
        raise ValueError(f"{path}: {len(data) - end} bytes after the msgpack object")
    return tree


def save_params(path: str, tree: dict) -> None:
    """Write nested dicts of arrays (numpy arrays or tensors) in the format
    :func:`load_params` reads and ``flax.serialization.msgpack_restore``
    restores."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    out = bytearray()
    _encode(tree, out)
    with open(path, "wb") as f:
        f.write(bytes(out))


# -- decoding ----------------------------------------------------------------------


def _decode(data: bytes, i: int):
    """The msgpack object at ``data[i:]`` and the offset after it."""
    b = data[i]
    i += 1
    if b <= 0x7F:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0x80 <= b <= 0x8F:
        return _decode_map(data, i, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _decode_array(data, i, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        return _str(data, i, b & 0x1F)
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b], i
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
             0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
        fmt = fixed[b]
        return struct.unpack_from(fmt, data, i)[0], i + struct.calcsize(fmt)
    lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
               0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
               0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in lengths:
        fmt = lengths[b]
        n = struct.unpack_from(fmt, data, i)[0]
        i += struct.calcsize(fmt)
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(data[i:i + n]), i + n
        if b in (0xD9, 0xDA, 0xDB):
            return _str(data, i, n)
        if b in (0xDC, 0xDD):
            return _decode_array(data, i, n)
        if b in (0xDE, 0xDF):
            return _decode_map(data, i, n)
        return _ext(data, i, n)
    if b in fixext:
        return _ext(data, i, fixext[b])
    raise ValueError(f"msgpack type byte {b:#04x} at offset {i - 1} is not supported")


def _str(data, i, n):
    return bytes(data[i:i + n]).decode("utf-8"), i + n


def _decode_array(data, i, n):
    out = []
    for _ in range(n):
        value, i = _decode(data, i)
        out.append(value)
    return out, i


def _decode_map(data, i, n):
    out = {}
    for _ in range(n):
        key, i = _decode(data, i)
        out[key], i = _decode(data, i)
    if "__msgpack_chunked_array__" in out:
        raise ValueError("flax's chunked arrays are not supported")
    return out, i


def _ext(data, i, n):
    code = data[i]
    payload = bytes(data[i + 1:i + 1 + n])
    if code != _EXT_NDARRAY:
        raise ValueError(f"msgpack ext type {code} is not supported (only 1, ndarray)")
    (shape, dtype, raw), end = _decode(payload, 0)
    if end != len(payload):
        raise ValueError("malformed ndarray payload")
    array = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape, order="C")
    return array.copy(), i + 1 + n


# -- encoding: the choices of msgpack's own packer, so that a tree read from a
# file written by flax is written back byte for byte ------------------------------


def _length(out, n, fix_base, fix_max, codes):
    """A header for a length ``n``: the fix form below ``fix_max``, else the
    first of ``codes`` (8-, 16-, 32-bit lengths) that holds it."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
        return
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


def _encode(obj, out: bytearray):
    if isinstance(obj, dict):
        _length(out, len(obj), 0x80, 16, ((0xDE, ">H"), (0xDF, ">I")))
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"map key {key!r} is not a string")
            _encode(key, out)
            _encode(value, out)
    elif isinstance(obj, (list, tuple)):
        _length(out, len(obj), 0x90, 16, ((0xDC, ">H"), (0xDD, ">I")))
        for value in obj:
            _encode(value, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _length(out, len(raw), 0xA0, 32, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
        out += raw
    elif isinstance(obj, bytes):
        _length(out, len(obj), None, 0, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
        out += obj
    elif isinstance(obj, bool) or obj is None:
        out.append({None: 0xC0, False: 0xC2, True: 0xC3}[obj])
    elif isinstance(obj, int):
        _encode_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _encode_ndarray(obj, out)
    else:
        raise TypeError(f"cannot encode a {type(obj).__name__}")


def _encode_int(n: int, out: bytearray):
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
            if n < 1 << (8 * struct.calcsize(fmt)):
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"int {n} too large for msgpack")
    else:
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
            bits = 8 * struct.calcsize(fmt)
            if n >= -(1 << (bits - 1)):
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"int {n} too large for msgpack")


def _encode_ndarray(array, out: bytearray):
    if isinstance(array, torch.Tensor):
        array = array.detach().cpu().numpy()
    array = np.ascontiguousarray(array)
    if array.dtype.hasobject or array.nbytes > 2**30:
        raise ValueError("object arrays and arrays past 2**30 bytes are not supported")
    payload = bytearray()
    _encode(([int(d) for d in array.shape], array.dtype.name, array.tobytes("C")), payload)
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _length(out, n, None, 0, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
    out.append(_EXT_NDARRAY)
    out += payload
