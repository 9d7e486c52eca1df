"""ctypes bindings to the native C++ components in ``native/``.

The reference ships two first-party MEX kernels
(``main/fastWHtrans.cpp``, ``BiGAMP/sparseMult2.c``); their framework
counterparts live as C++ with a C ABI, compiled lazily with g++ into
``native/build/`` and loaded via ctypes (no pybind11 in this image).  They
serve as host-side fast paths and as independent verification oracles for
the XLA implementations.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[str]:
    sources = [os.path.join(_NATIVE_DIR, f) for f in ("fwht.cpp", "sparse_mult.cpp")]
    if not all(os.path.exists(s) for s in sources):
        return None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, "libjstsp19_native.so")
    if os.path.exists(so_path) and all(
        os.path.getmtime(so_path) >= os.path.getmtime(s) for s in sources
    ):
        return so_path
    base = ["g++", "-O3", "-shared", "-fPIC", "-o", so_path] + sources
    # prefer host tuning, but fall back to generic codegen — some hosts
    # (cross-mounted toolchains, qemu) reject -march=native
    for cmd in (base[:2] + ["-march=native"] + base[2:], base):
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            return so_path
        except (subprocess.SubprocessError, FileNotFoundError):
            continue
    return None


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        so = _build()
        if so:
            lib = ctypes.CDLL(so)
            lib.fwht_sequency.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
            ]
            lib.fwht_natural.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
            ]
            lib.sparse_conj_mult.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
            ]
            _LIB = lib
    return _LIB


def native_available() -> bool:
    return _lib() is not None


def native_fwht(x: np.ndarray, ordering: str = "sequency") -> np.ndarray:
    """Orthonormal FWHT along the last axis (power-of-two length)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native library unavailable (g++ build failed)")
    x = np.ascontiguousarray(x, dtype=np.float64)
    n = x.shape[-1]
    out = x.reshape(-1, n).copy()
    scratch = np.empty(n, np.float64)
    pd = ctypes.POINTER(ctypes.c_double)
    for row in out:
        if ordering == "sequency":
            lib.fwht_sequency(row.ctypes.data_as(pd), scratch.ctypes.data_as(pd), n)
        elif ordering == "natural":
            lib.fwht_natural(row.ctypes.data_as(pd), n)
        else:
            raise ValueError(f"unknown ordering {ordering!r}")
    return out.reshape(x.shape)


def native_sparse_conj_mult(
    A: np.ndarray, X: np.ndarray, rows: np.ndarray, cols: np.ndarray
) -> np.ndarray:
    """Selected entries ``Z[rows[k], cols[k]]`` of ``Z = Aᴴ·X``."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native library unavailable (g++ build failed)")
    A = np.asfortranarray(A, dtype=np.complex128)
    X = np.asfortranarray(X, dtype=np.complex128)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    m = rows.shape[0]
    out = np.empty(m, np.complex128)
    n, r = A.shape
    c = X.shape[1]
    pd = ctypes.POINTER(ctypes.c_double)
    pi = ctypes.POINTER(ctypes.c_int64)
    lib.sparse_conj_mult(
        A.ctypes.data_as(pd),
        X.ctypes.data_as(pd),
        rows.ctypes.data_as(pi),
        cols.ctypes.data_as(pi),
        out.ctypes.data_as(pd),
        n, r, c, m,
    )
    return out
