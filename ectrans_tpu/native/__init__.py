"""Native (C++) host kernels, loaded via ctypes with on-demand compilation.

The shared library is built once from the checked-in C++ sources with g++
and cached next to them (or under ``ECTRANS_TPU_NATIVE_DIR``); if no
compiler is available every consumer falls back to the NumPy reference
implementation, so the native layer is a pure accelerator, never a
requirement.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import pathlib
import subprocess
import threading

import numpy as np

_MADV_HUGEPAGE = 14


def alloc_array(shape, dtype) -> np.ndarray:
    """Allocate a large array on transparent-hugepage-advised memory.

    On hosts with lazily-backed VM memory (e.g. Firecracker) first-touch page
    faults dominate large-array writes (~35 us per 4 KiB page); THP backing
    cuts the fault count 512x.  Falls back to np.empty on any failure.
    """
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if nbytes < (1 << 24):
        return np.empty(shape, dtype=dtype)
    try:
        buf = mmap.mmap(-1, nbytes)
        addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        libc = ctypes.CDLL(None, use_errno=True)
        libc.madvise(ctypes.c_void_p(addr), ctypes.c_size_t(nbytes),
                     _MADV_HUGEPAGE)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)
    except Exception:
        return np.empty(shape, dtype=dtype)

_SRC_DIR = pathlib.Path(__file__).parent
_LOCK = threading.Lock()
_LIB = None
_LIB_TRIED = False

_SOURCES = ["legendre_builder.cpp"]


def _build_dir() -> pathlib.Path:
    env = os.environ.get("ECTRANS_TPU_NATIVE_DIR")
    if env:
        return pathlib.Path(env)
    return _SRC_DIR


_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-funroll-loops"]


def _lib_path() -> pathlib.Path:
    """Library path keyed by a hash of the sources and compiler flags, so a
    library built from other sources (a stale or copied file) is never
    loaded."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in _SOURCES:
        h.update((_SRC_DIR / s).read_bytes())
    return _build_dir() / f"_ectrans_native_{h.hexdigest()[:16]}.so"


def _compile() -> pathlib.Path | None:
    srcs = [_SRC_DIR / s for s in _SOURCES]
    try:
        out = _lib_path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = ["g++"] + _FLAGS + ["-o", str(tmp)] + [str(s) for s in srcs]
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return out
    except Exception:
        return None


def _load():
    global _LIB, _LIB_TRIED
    with _LOCK:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        if os.environ.get("ECTRANS_TPU_DISABLE_NATIVE"):
            return None
        path = _compile()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
            for name, ptr_t in (
                ("et_build_legendre_parity", ctypes.POINTER(ctypes.c_double)),
                ("et_build_legendre_parity_f32", ctypes.POINTER(ctypes.c_float)),
            ):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.c_void_p,                    # nmen or NULL
                    ctypes.c_int, ptr_t, ptr_t,
                ]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def available() -> bool:
    return _load() is not None


def build_legendre_parity(
    nsmax: int,
    mu: np.ndarray,
    ntmax_extra: int = 1,
    nmen_nh: np.ndarray | None = None,
    dtype=np.float64,
) -> tuple[np.ndarray, np.ndarray, int] | None:
    """Native parity-split Legendre tables: (psym, pasym, kmax) with
    psym[m, lat, k] = Pbar at n = m+2k.  Returns None if unavailable.

    dtype float32 writes single-precision tables directly (half the memory
    traffic of the dominant cost); the recurrence is always fp64.
    """
    lib = _load()
    if lib is None:
        return None
    mu = np.ascontiguousarray(mu, dtype=np.float64)
    nlat = mu.shape[0]
    nmax = nsmax + ntmax_extra
    kmax = (nmax + 2) // 2
    M = nsmax + 1
    dt = np.dtype(dtype)
    if dt == np.float64:
        fn, ctype = lib.et_build_legendre_parity, ctypes.c_double
    elif dt == np.float32:
        fn, ctype = lib.et_build_legendre_parity_f32, ctypes.c_float
    else:
        return None
    psym = alloc_array((M, nlat, kmax), dt)
    pasym = alloc_array((M, nlat, kmax), dt)
    if nmen_nh is not None:
        nmen_arr = np.ascontiguousarray(nmen_nh, dtype=np.int32)
        nmen_ptr = nmen_arr.ctypes.data_as(ctypes.c_void_p)
    else:
        nmen_arr = None
        nmen_ptr = None
    rc = fn(
        nsmax, nmax, nlat,
        mu.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nmen_ptr, kmax,
        psym.ctypes.data_as(ctypes.POINTER(ctype)),
        pasym.ctypes.data_as(ctypes.POINTER(ctype)),
    )
    if rc != 0:
        return None
    return psym, pasym, kmax
