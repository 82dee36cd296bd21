"""Native (C++) runtime components, loaded via ctypes.

The compute path is JAX/XLA; the host-side runtime around it
(data ingest, and over time other IO-bound pieces) is C++ like the
reference's (SURVEY.md §2.2). Libraries build lazily with g++ on first
use and fall back to pure-Python implementations when a toolchain is
unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "_native.so")
_SRC = os.path.join(_DIR, "fastq_reader.cpp")

_lib = None
_tried = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-shared", "-fPIC", _SRC, "-lz", "-o", _LIB_PATH]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def get_lib():
    """The native library handle, or None (Python fallback)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_LIB_PATH) or
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        lib = ctypes.CDLL(_LIB_PATH)
        lib.fbtpu_scan.restype = ctypes.c_int64
        lib.fbtpu_scan.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int64)]
        lib.fbtpu_fill.restype = ctypes.c_int64
        lib.fbtpu_fill.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def load_reads_native(path: str, with_quals: bool = False):
    """Parse FASTA/FASTQ(.gz) into (codes, lengths[, quals]) numpy arrays
    using the native reader. Returns None if the native lib is absent."""
    import numpy as np
    lib = get_lib()
    if lib is None:
        return None
    max_len = ctypes.c_int64(0)
    n = lib.fbtpu_scan(path.encode(), ctypes.byref(max_len))
    if n < 0:
        raise IOError(f"native reader failed to parse {path}")
    R, L = int(n), int(max_len.value)
    codes = np.empty((R, max(L, 1)), dtype=np.uint8)
    lengths = np.empty((R,), dtype=np.int32)
    quals = np.empty((R, max(L, 1)), dtype=np.uint8) if with_quals else None
    filled = lib.fbtpu_fill(
        path.encode(),
        codes.ctypes.data_as(ctypes.c_void_p),
        lengths.ctypes.data_as(ctypes.c_void_p),
        quals.ctypes.data_as(ctypes.c_void_p) if with_quals else None,
        R, max(L, 1))
    if filled != R:
        raise IOError(f"native reader: expected {R} reads, got {filled}")
    if with_quals:
        return codes, lengths, quals
    return codes, lengths
