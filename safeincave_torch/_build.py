"""Build and load the hand-written CUDA kernels, and the host C++ mesh
library, at first use.

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
# C signatures: name -> (argtypes, restype).  Every pointer, the host
# parameter struct and the stream included, is a c_void_p: ctypes would
# pass a bare Python int as a 32-bit int and cut it.
SIGNATURES = {
    "band_matvec": {
        # (const BandPlan*, ctv, u, f, stream)
        "band_matvec_f32": ([_P] * 5, ctypes.c_int),
        # (const BandPlan64*, ctv, u, f, stream)
        "band_matvec_f64": ([_P] * 5, ctypes.c_int),
        "band_matvec_error_string": ([_I], ctypes.c_char_p),
    },
    "dia_matvec": {
        # (const DiaParams*, vals, u, y, stream)
        "dia_matvec_f32": ([_P] * 5, ctypes.c_int),
        "dia_matvec_f64": ([_P] * 5, ctypes.c_int),
        "dia_matvec_error_string": ([_I], ctypes.c_char_p),
    },
    "sym_dense_matvec": {
        # (const SymPlan*, x, y, stream)
        "sym_dense_matvec_f32": ([_P] * 4, ctypes.c_int),
        "sym_dense_matvec_error_string": ([_I], ctypes.c_char_p),
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


def _paths(name: str):
    """(source, library path); the library name carries the source hash."""
    src = os.path.join(SRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(names) -> None:
    """Compile the missing libraries of ``names``, one nvcc each, all
    started together; raises if any fails."""
    jobs = {}
    try:
        for name in names:
            src, lib_path = _paths(name)
            if name in _loaded or os.path.isfile(lib_path):
                continue
            nvcc = _nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            jobs[name] = (proc, tmp, src, lib_path, time.perf_counter())
        for name, (proc, tmp, src, lib_path, t0) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{err}")
            os.replace(tmp, lib_path)
            build_seconds[name] = time.perf_counter() - t0
    finally:
        for proc, tmp, *_ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def host_library(src: str, stem: str) -> ctypes.CDLL:
    """Compile the host C++ source ``src`` with ``g++`` into
    ``_build/lib<stem>_<hash>.so`` (if that file is missing) and load it;
    raises when the source, the compiler or the build fails."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(HOST_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR,
                            f"lib{stem}_{digest.hexdigest()[:16]}.so")
    if not os.path.isfile(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            subprocess.run(["g++", *HOST_FLAGS, "-o", tmp, src], check=True,
                           capture_output=True, text=True)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        build_seconds[stem] = time.perf_counter() - t0
    return ctypes.CDLL(lib_path)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure."""
    if name in _loaded:
        return _loaded[name]
    build([name])
    lib = ctypes.CDLL(_paths(name)[1])
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _loaded[name] = lib
    return lib


def kernel(name: str, fn: str):
    """``(launcher, check)`` of C function ``fn`` in ``csrc/<name>.cu``,
    resolved once per operator: ``check(err)`` raises RuntimeError with
    CUDA's message when a launcher returned a non-zero error code."""
    lib = load(name)
    launcher = getattr(lib, fn)
    error_string = getattr(lib, f"{name}_error_string")

    def check(err: int) -> None:
        if err != 0:
            raise RuntimeError(f"{fn} launch failed: "
                               f"{error_string(err).decode()}")

    return launcher, check


def stream_query(device):
    """A function returning the raw handle of PyTorch's current stream on
    the CUDA ``device``, as an int for ctypes.  It is the query Triton's
    launcher makes; ``torch.cuda.current_stream`` builds a Python object
    per call, several microseconds of a launch's host path."""
    import torch
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    raw = torch._C._cuda_getCurrentRawStream
    return lambda: raw(index)
