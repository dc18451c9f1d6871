"""Build and load the hand-written CUDA kernels (ctypes route).

`load()` compiles `phoregen_tpu_torch/csrc/layer_stack.cu` with nvcc for
sm_90a into `phoregen_tpu_torch/_build/` (keyed by the source's hash, so an
edited source rebuilds) at first use and returns the loaded library. The C
entries take (pointer array, pointer count, dims array, stream) and return
a cudaError_t code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "layer_stack.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
ENTRIES = ("ls_stage_node", "ls_stage_trip_pre", "ls_stage_trip_att",
           "ls_stage_pos")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"liblayer_stack_{digest}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels if the current source has no library yet."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = out + f".tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else []) \
        + ["-o", tmp, SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr)
    os.replace(tmp, out)
    return out


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name in ENTRIES:
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
