"""Build and load the hand-written CUDA kernels at first use.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds into ``safeincave_torch/_build/`` and it is
loaded with ``ctypes``.  The library name carries a hash of the source, so an
edited source is rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: name -> (argtypes, restype)
SIGNATURES = {
    "band_matvec": {
        "band_matvec_f32": ([_P] * 9 + [_I, _I, _P], ctypes.c_int),
        "band_matvec_error_string": ([_I], ctypes.c_char_p),
    },
}

_loaded: dict = {}
build_seconds: dict = {}


def _nvcc() -> str:
    """nvcc of the toolkit PyTorch finds (CUDA_HOME, CUDA_PATH, PATH, then
    /usr/local/cuda)."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of safeincave_torch are built from source at "
                           "first use")
    return nvcc


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure."""
    if name in _loaded:
        return _loaded[name]
    src = os.path.join(SRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR,
                            f"lib{name}_{digest.hexdigest()[:16]}.so")
    if not os.path.isfile(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        build_seconds[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(lib_path)
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _loaded[name] = lib
    return lib
