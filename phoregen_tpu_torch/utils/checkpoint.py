"""Release checkpoints: a flax msgpack reader with no flax or msgpack.

The JAX package saves parameters with `flax.serialization.to_bytes`: a
msgpack map of nested string-keyed maps whose leaves are msgpack ext values
of type 1, each holding the packed triple `(shape, dtype name, raw bytes)`.
Beside `<prefix>.msgpack` sits `<prefix>.json` with the training config and
metadata. `load_release(prefix)` reads both; `from_jax_params` maps the
flax parameter tree onto the port's `state_dict` names (flax path joined by
'.'), which is the one place weights cross from the JAX package.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    """Decoder for the msgpack subset that flax writes."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _ext(self, n: int):
        code = self._unpack(">b")
        data = bytes(self._take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).read()
            return complex(re, im)
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b >= 0xE0:
            return b - 0x100
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            n = self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self._take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(n)
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        fixed = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self._unpack(fixed[b])
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self._ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            n = self._unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return str(self._take(n), "utf-8")
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(data).read()
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def _unchunk(tree):
    """Undo flax's splitting of >1 GiB leaves (`__msgpack_chunked_array__`)."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(raw: bytes) -> Dict[str, Any]:
    """Bytes written by `flax.serialization.to_bytes` -> nested dict of
    numpy arrays (same result as `flax.serialization.msgpack_restore`)."""
    r = _Reader(raw)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def load_release(prefix: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """`<prefix>.msgpack` + `<prefix>.json` -> (numpy param tree, meta).

    The param tree is the flax `params` collection of the model (the
    checkpoint's `{"params": {"params": ...}}` wrappers removed)."""
    with open(prefix + ".msgpack", "rb") as f:
        tree = msgpack_restore(f.read())
    with open(prefix + ".json") as f:
        meta = json.load(f)
    return strip_collections(tree), meta


def strip_collections(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Drop the train-state and variable-collection wrappers around a flax
    param tree ({'params': {'params': {...}}} or {'params': {...}})."""
    while isinstance(tree, dict) and set(tree) == {"params"}:
        tree = tree["params"]
    return tree


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, name))
        else:
            out[name] = v
    return out


def from_jax_params(tree: Dict[str, Any], cfg=None) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested dict of arrays) -> the port's state_dict.

    The port's modules keep flax's names and layouts (`kernel` is
    [in, out], stacked layer params lead with the layer axis), so the map
    is the flax path joined with '.'. `cfg` is accepted for symmetry with
    loaders that need the architecture; the names do not depend on it."""
    del cfg
    flat = flatten_tree(strip_collections(tree))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flat.items()}
