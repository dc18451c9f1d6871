"""ctypes binding for the native host library (g++ at first use).

Counterpart of `phoregen_tpu/native/__init__.py`: C implementations of the
host side of generation, EDM bond perception and the valence /
connectivity check, over the same symbol-keyed tables as the Python
versions (`sample/predict_bonds.py`, `sample/chem.py`), which stay the
reference and the fallback where no compiler exists.

`phoregen_host.cpp` is built with `g++ -O3 -shared -fPIC` into
`phoregen_tpu_torch/_build/libphoregen_host_<hash>.so`, keyed by the
source's hash like the CUDA libraries (`ops/_build.py`), and never beside
the source. Torch-free: spawned reconstruction workers import it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..constants import SYMBOL_TO_ATOMIC_NUMBER

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "phoregen_host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")

N_Z = 120  # table dimension: atomic numbers 0..119

_lock = threading.Lock()
# the loaded library, its bond tables and max-valence table, or the reason
# it could not be built ("error")
_state: dict = {}


class _BondTables(ctypes.Structure):
    _fields_ = [
        ("bonds1", ctypes.POINTER(ctypes.c_float)),
        ("bonds2", ctypes.POINTER(ctypes.c_float)),
        ("bonds3", ctypes.POINTER(ctypes.c_float)),
        ("n_z", ctypes.c_int),
        ("margin1", ctypes.c_float),
        ("margin2", ctypes.c_float),
        ("margin3", ctypes.c_float),
    ]


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libphoregen_host_{digest}.so")


def _build() -> str:
    """The library for the current source, compiled if missing (into a
    temporary name first, so that a concurrent process never loads a
    half-written file). Raises if g++ fails or is missing."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, path)
    return path


def _sym_z(sym: str) -> Optional[int]:
    return SYMBOL_TO_ATOMIC_NUMBER.get(sym, 1 if sym == "H" else None)


def _dense_tables():
    """The symbol-keyed pm tables as dense symmetric [N_Z * N_Z] arrays
    (the Python path sorts the two symbols before its lookup, so a
    symmetric table gives it for every ordered pair)."""
    from ..sample.predict_bonds import (BONDS1, BONDS2, BONDS3, MARGIN1,
                                        MARGIN2, MARGIN3)

    def densify(d):
        arr = np.zeros((N_Z, N_Z), np.float32)
        for s1, row in d.items():
            for s2, pm in row.items():
                z1, z2 = _sym_z(s1), _sym_z(s2)
                if z1 is None or z2 is None:
                    continue
                arr[z1, z2] = max(arr[z1, z2], float(pm))
                arr[z2, z1] = max(arr[z2, z1], float(pm))
        return np.ascontiguousarray(arr.reshape(-1))

    return (densify(BONDS1), densify(BONDS2), densify(BONDS3),
            (MARGIN1, MARGIN2, MARGIN3))


def _max_valence_table() -> np.ndarray:
    from ..sample.chem import ALLOWED_VALENCES
    arr = np.zeros(N_Z, np.float32)
    for sym, vals in ALLOWED_VALENCES.items():
        z = _sym_z(sym)
        if z is not None:
            arr[z] = max(vals)
    return arr


def _load() -> Optional[dict]:
    """The loaded library state, or None when it cannot be built here
    (the reason stays in `load_error()`)."""
    with _lock:
        if "lib" in _state or "error" in _state:
            return _state if "lib" in _state else None
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, subprocess.SubprocessError) as e:
            _state["error"] = f"native build failed: {e}"
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.predict_bonds.restype = ctypes.c_int
        lib.predict_bonds.argtypes = [ctypes.POINTER(_BondTables),
                                      ctypes.c_int, i32p, f32p, i32p, i32p,
                                      i32p, ctypes.c_int]
        lib.check_mol.restype = ctypes.c_int
        lib.check_mol.argtypes = [ctypes.c_int, i32p, ctypes.c_int, i32p,
                                  i32p, i32p, f32p, ctypes.c_int]
        b1, b2, b3, margins = _dense_tables()
        tables = _BondTables(
            bonds1=b1.ctypes.data_as(f32p), bonds2=b2.ctypes.data_as(f32p),
            bonds3=b3.ctypes.data_as(f32p), n_z=N_Z, margin1=margins[0],
            margin2=margins[1], margin3=margins[2])
        # the arrays stay referenced as long as the struct points at them
        _state.update(lib=lib, tables=tables, keep=(b1, b2, b3),
                      maxval=_max_valence_table())
        return _state


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the library did not load (None if it did or was not tried)."""
    return _state.get("error")


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.int32).reshape(-1))


def _elements(elements) -> np.ndarray:
    el = _i32(elements)
    if el.size and (int(el.min()) < 0 or int(el.max()) >= N_Z):
        raise ValueError(f"atomic numbers must lie in [0, {N_Z})")
    return el


def predict_bonds_native(elements, pos
                         ) -> Optional[Tuple[List[List[int]], List[int]]]:
    """Native EDM bond perception: directed bond lists in the order of the
    Python `predict_bonds` ([i, j, i2, j2, ...] against [j, i, j2, i2,
    ...]), or None when the library is unavailable."""
    st = _load()
    if st is None:
        return None
    n = len(elements)
    el = _elements(elements)
    p = np.ascontiguousarray(np.asarray(pos, np.float32).reshape(-1))
    if p.size != 3 * n:
        raise ValueError(f"{n} elements but {p.size} coordinates")
    cap = max(n * n, 16)
    bi, bj, bo = (np.empty(cap, np.int32) for _ in range(3))
    i32p = ctypes.POINTER(ctypes.c_int32)
    m = st["lib"].predict_bonds(
        ctypes.byref(st["tables"]), n, el.ctypes.data_as(i32p),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bi.ctypes.data_as(i32p), bj.ctypes.data_as(i32p),
        bo.ctypes.data_as(i32p), cap)
    if m < 0:
        return None
    src = np.empty(2 * m, np.int64)
    dst = np.empty(2 * m, np.int64)
    src[0::2], src[1::2] = bi[:m], bj[:m]
    dst[0::2], dst[1::2] = bj[:m], bi[:m]
    return [src.tolist(), dst.tolist()], np.repeat(bo[:m], 2).tolist()


def check_mol_native(elements, bonds) -> Optional[Tuple[bool, bool]]:
    """(sanitizable, connected) from the C kernel, or None when the library
    is unavailable. bonds: iterable of undirected (i, j, order)."""
    st = _load()
    if st is None:
        return None
    n = len(elements)
    el = _elements(elements)
    bonds = list(bonds)
    m = len(bonds)
    cols = [_i32([b[c] for b in bonds]) for c in range(3)]
    if m and (min(int(c.min()) for c in cols[:2]) < 0
              or max(int(c.max()) for c in cols[:2]) >= n):
        raise ValueError("bond index out of range")
    i32p = ctypes.POINTER(ctypes.c_int32)
    ptr = lambda a: a.ctypes.data_as(i32p) if m else None
    flags = st["lib"].check_mol(
        n, el.ctypes.data_as(i32p), m, ptr(cols[0]), ptr(cols[1]),
        ptr(cols[2]), st["maxval"].ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)), N_Z)
    return bool(flags & 1), bool(flags & 2)
