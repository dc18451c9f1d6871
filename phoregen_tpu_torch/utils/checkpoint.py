"""Checkpoints in the JAX package's format, read and written with no flax
or msgpack.

The JAX package saves with `flax.serialization.to_bytes`: a msgpack map of
nested string-keyed maps whose leaves are msgpack ext values of type 1,
each holding the packed triple `(shape, dtype name, raw bytes)`. Beside
`<prefix>.msgpack` sits `<prefix>.json` with the training config and
metadata. `load_release(prefix)` reads both; `msgpack_restore` /
`msgpack_serialize` are the reader and the writer of that subset.
`from_jax_params` maps the flax parameter tree onto the port's
`state_dict` names (flax path joined by '.') and `to_jax_params` maps back:
the one place weights cross between the two packages.
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


def _pack_len(n: int, codes, fix=None) -> bytes:
    """Header of a str / bin / array / map / ext of length n: `fix` is
    (base, limit) of the one-byte form, `codes` the 8/16/32-bit type
    bytes (None where the format has no such form)."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"object of length {n} is too long for msgpack")


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(bytes([obj]) if 0 <= obj < 128
                   else b"\xd3" + struct.pack(">q", obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_pack_len(len(raw), (0xD9, 0xDA, 0xDB), (0xA0, 32)))
        out.append(raw)
    elif isinstance(obj, (bytes, memoryview)):
        out.append(_pack_len(len(obj), (0xC4, 0xC5, 0xC6)))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_len(len(obj), (None, 0xDC, 0xDD), (0x90, 16)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_pack_len(len(obj), (None, 0xDE, 0xDF), (0x80, 16)))
        for k, v in obj.items():
            _pack(str(k), out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.nbytes >= 1 << 30:
            raise ValueError("leaves of 1 GiB and more (flax's chunked "
                             "arrays) are not written")
        body: list = []
        _pack((list(arr.shape), arr.dtype.name, arr.tobytes()), body)
        raw = b"".join(body)
        out.append(_pack_len(len(raw), (0xC7, 0xC8, 0xC9)))
        out.append(struct.pack(">b", _EXT_NDARRAY))
        out.append(raw)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def msgpack_serialize(tree: Dict[str, Any]) -> bytes:
    """Nested dict of numpy arrays (and str / int / float / None leaves) ->
    the bytes `flax.serialization.msgpack_restore` reads back to the same
    tree. Tensors go in as numpy arrays."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


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


def load_release(prefix: str, use_ema: bool = False
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """`<prefix>.msgpack` + `<prefix>.json` -> (numpy param tree, meta).

    The param tree is the flax `params` collection of the model (the
    checkpoint's `{"params": {"params": ...}}` wrappers removed); of a full
    training checkpoint (`last_model`, `best_model`) it is the `params`
    entry, or with `use_ema` its `ema_params` entry (the EMA shadow), the
    optimizer state and the rest left aside. `use_ema` on a checkpoint
    without `ema_params` (a release checkpoint: bare model weights) raises
    ValueError."""
    with open(prefix + ".msgpack", "rb") as f:
        tree = msgpack_restore(f.read())
    with open(prefix + ".json") as f:
        meta = json.load(f)
    if use_ema:
        if not isinstance(tree, dict) or "ema_params" not in tree:
            raise ValueError(f"{prefix}: no ema_params in the checkpoint "
                             f"(release checkpoints carry bare model "
                             f"weights)")
        return strip_collections(tree["ema_params"]), meta
    return strip_collections(tree.get("params", tree)), meta


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


def from_jax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested dict of arrays) -> the port's state_dict.

    The port's modules and parameter trees keep flax's names and layouts
    (`kernel` is [in, out]; stacked layer params lead with the layer axis
    under `denoiser.layers.layer`, unstacked ones sit under
    `denoiser.layer_<i>`), so the map is the flax path joined with '.' for
    every leaf of either path (per-layer modules or the fused stack)."""
    flat = flatten_tree(strip_collections(tree))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flat.items()}


def unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        node = out
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def to_jax_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state_dict (or any name -> tensor map with its names) ->
    the flax param tree of numpy arrays, the inverse of `from_jax_params`
    (without the `{"params": ...}` collection wrapper)."""
    return unflatten_tree({k: v.detach().cpu().numpy()
                           for k, v in state_dict.items()})
