"""Native (C++) runtime components with build-on-demand + Python fallback.

The reference's runtime is C++; here the host-side irregular work (lattice
hash-table build, forest.dat decode) is C++ too, loaded through ctypes. The
library is built from the committed sources with g++ on first use, into
``native/build/`` (git-ignored), under a name keyed by a hash of the sources
and the compiler command: a stale or foreign binary is never loaded, and the
build targets the generic x86-64/aarch64 instruction set, so a library built
on one host runs on any other. Every entry point has a NumPy fallback, so the
framework works without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")
_SOURCES = ["lattice_builder.cpp", "forest_codec.cpp"]
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def source_hash() -> str:
    """Hash of the sources and the compiler flags that build the library."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def lib_path() -> str:
    return os.path.join(BUILD_DIR, f"librovina_native-{source_hash()}.so")


def _build(path: str) -> bool:
    """Compile into a temporary file, then rename it into place, so
    concurrent processes never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = ["g++", *_FLAGS, "-o", tmp] + [
        os.path.join(_DIR, s) for s in _SOURCES
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        log.warning("native build failed, using Python fallbacks: %s", e)
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            log.warning("native load failed: %s", e)
            return None
        lib.rovina_lattice_build.restype = ctypes.c_int
        lib.rovina_lattice_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
        lib.rovina_lattice_neighbors.restype = ctypes.c_int
        lib.rovina_lattice_neighbors.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        lib.rovina_forest_decode.restype = ctypes.c_int
        lib.rovina_forest_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.rovina_forest_sizes.argtypes = [
            ctypes.POINTER(ctypes.c_int64)] * 3
        lib.rovina_forest_fetch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_lattice_build(
    features: np.ndarray,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]]:
    """(offsets, barycentric, blur_n1, blur_n2, M) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    f = np.ascontiguousarray(features, dtype=np.float32)
    n, d = f.shape
    offsets = np.empty((n, d + 1), np.int32)
    bary = np.empty((n, d + 1), np.float32)
    m = lib.rovina_lattice_build(
        _ptr(f, ctypes.c_float), n, d,
        _ptr(offsets, ctypes.c_int32), _ptr(bary, ctypes.c_float),
    )
    if m < 0:
        return None
    blur_n1 = np.empty((d + 1, m), np.int32)
    blur_n2 = np.empty((d + 1, m), np.int32)
    m2 = lib.rovina_lattice_neighbors(
        _ptr(blur_n1, ctypes.c_int32), _ptr(blur_n2, ctypes.c_int32), m
    )
    if m2 != m:
        return None
    return offsets, bary, blur_n1, blur_n2, m


def native_forest_decode(data: bytes):
    """Decode forest.dat bytes -> raw flat arrays, or None if unavailable.

    Returns (node_counts [T], split [sumN], thresholds [sumN], left [sumN],
    hist_index [R, 5], hist_values [V]).
    """
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    tree_count = lib.rovina_forest_decode(_ptr(buf, ctypes.c_uint8), len(buf))
    if tree_count < 0:
        return None
    total_nodes = ctypes.c_int64()
    hist_rows = ctypes.c_int64()
    hist_values = ctypes.c_int64()
    lib.rovina_forest_sizes(
        ctypes.byref(total_nodes), ctypes.byref(hist_rows),
        ctypes.byref(hist_values),
    )
    node_counts = np.empty(tree_count, np.int32)
    split = np.empty(total_nodes.value, np.int32)
    thr = np.empty(total_nodes.value, np.float32)
    left = np.empty(total_nodes.value, np.int32)
    hist_index = np.empty((hist_rows.value, 5), np.int32)
    hist_vals = np.empty(hist_values.value, np.float32)
    lib.rovina_forest_fetch(
        _ptr(node_counts, ctypes.c_int32), _ptr(split, ctypes.c_int32),
        _ptr(thr, ctypes.c_float), _ptr(left, ctypes.c_int32),
        _ptr(hist_index, ctypes.c_int32), _ptr(hist_vals, ctypes.c_float),
    )
    return node_counts, split, thr, left, hist_index, hist_vals
