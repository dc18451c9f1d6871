"""Build and load the hand-written CUDA kernels (ctypes route).

Each source under `phoregen_tpu_torch/csrc/` becomes one shared library in
`phoregen_tpu_torch/_build/`, compiled with nvcc for sm_90a at first use and
keyed by the source's hash, so an edited source rebuilds. `build()` starts
one nvcc per missing library, all together, and waits for them; `load(name)`
returns the loaded library. Every C entry takes (pointer array, pointer
count, dims array, stream) and returns a cudaError_t code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# library name -> (source file under csrc/, C entries)
LIBRARIES = {
    "layer_stack": ("layer_stack.cu",
                    ("ls_stage_node", "ls_stage_trip_pre",
                     "ls_stage_trip_att", "ls_stage_pos",
                     "ls_stage_node_pre", "ls_stage_att_pos",
                     # the same stages with bf16 blocks pre_t and q_z
                     "ls_stage_trip_pre_bf16", "ls_stage_trip_att_bf16",
                     "ls_stage_node_pre_bf16", "ls_stage_att_pos_bf16")),
    "triplet_pool": ("triplet_pool.cu", ("tp_triplet_pool",)),
}

_lock = threading.Lock()
_libs = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def source_path(name: str) -> str:
    return os.path.join(_PKG, "csrc", LIBRARIES[name][0])


def library_path(name: str = "layer_stack") -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(verbose: bool = False) -> dict:
    """Compile every library whose current source has none yet, one nvcc
    each, started together. Returns {name: library path}."""
    paths = {name: library_path(name) for name in LIBRARIES}
    missing = [n for n, p in paths.items() if not os.path.exists(p)]
    if not missing:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in missing:
        tmp = paths[name] + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else []) \
            + ["-o", tmp, source_path(name)]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{err}")
            continue
        if verbose:
            print(err)
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def declare(lib, entries) -> None:
    """Declare the C signature of each of `entries` on the loaded `lib`."""
    for entry in entries:
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int


def bind(path: str, name: str):
    """Load the shared library at `path` and declare the C entries of
    library `name` on it."""
    lib = ctypes.CDLL(path)
    declare(lib, LIBRARIES[name][1])
    return lib


def load(name: str = "layer_stack"):
    """The loaded kernel library `name` (all libraries are built on the
    first call)."""
    with _lock:
        if name not in _libs:
            _libs[name] = bind(build()[name], name)
    return _libs[name]
