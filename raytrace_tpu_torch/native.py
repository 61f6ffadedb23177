"""The native host library (port of ``raytrace_tpu/native.py``): a ctypes
loader for ``csrc/host/rt_native.cpp``, the port's own copy of the JAX
package's C++ source.

The library builds on first use with ``g++ -O2 -shared -fPIC`` into
``raytrace_tpu_torch/_build/``, under a name keyed by a hash of the
source (a changed source builds anew; a build goes to a temporary file
that is renamed into place, so processes that build at once do not
race). It gives the median BVH build (``bvh.build_bvh`` takes it when
it loaded) and the PNG scanline codecs (``utils/image.py``). Each entry
returns None when the library is not there (no ``g++``): the numpy
build and the Python codecs are its plain versions and give the same
results.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_PKG, "csrc", "host", "rt_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ["-O2", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> str:
    """Where the library of this source and these flags is built."""
    with open(SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"librt_native-{key.hexdigest()[:16]}.so")


def _compile(path: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> Optional[ctypes.CDLL]:
    """The library (built if needed), or None where it cannot be built."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not os.path.exists(path) and not _compile(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32 = ctypes.c_int32
        lib.rt_build_bvh.restype = i32
        lib.rt_build_bvh.argtypes = [f32p, f32p, i32, i32, f32p, f32p, i32p,
                                     i32p, i32p, i32p]
        lib.rt_png_unfilter.restype = i32
        lib.rt_png_unfilter.argtypes = [u8p, u8p, u8p, i32, i32, i32]
        lib.rt_png_filter_paeth.restype = None
        lib.rt_png_filter_paeth.argtypes = [u8p, u8p, i32, i32, i32]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def build_bvh_native(lo: np.ndarray, hi: np.ndarray, leaf_size: int = 4):
    """The median-split tree as flat numpy arrays (node_min, node_max,
    node_skip, node_first, node_count, prim_index), or None without the
    library or primitives."""
    lib = load()
    if lib is None:
        return None
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = lo.shape[0]
    if n == 0:
        return None
    if hi.shape != (n, 3) or lo.shape != (n, 3):
        raise ValueError(f"boxes: lo {lo.shape}, hi {hi.shape}, not (n, 3)")
    cap = 2 * n
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_skip = np.empty(cap, np.int32)
    node_first = np.empty(cap, np.int32)
    node_count = np.empty(cap, np.int32)
    prim_index = np.empty(n, np.int32)
    m = lib.rt_build_bvh(lo.reshape(-1), hi.reshape(-1), n, leaf_size,
                         node_min.reshape(-1), node_max.reshape(-1),
                         node_skip, node_first, node_count, prim_index)
    return (node_min[:m], node_max[:m], node_skip[:m], node_first[:m],
            node_count[:m], prim_index)


def png_unfilter_native(filters: np.ndarray,
                        data: np.ndarray, bpp: int) -> Optional[np.ndarray]:
    """Unfiltered (h, stride) scanlines, or None without the library;
    raises on an unknown filter byte."""
    lib = load()
    if lib is None:
        return None
    filters = np.ascontiguousarray(filters, np.uint8)
    data = np.ascontiguousarray(data, np.uint8)
    h, stride = data.shape
    if filters.shape != (h,):
        raise ValueError(f"filters {filters.shape} for {h} scanlines")
    out = np.empty_like(data)
    rc = lib.rt_png_unfilter(filters, data, out, h, stride, bpp)
    if rc != 0:
        raise ValueError(f"unknown PNG filter {rc}")
    return out


def png_filter_paeth_native(data: np.ndarray,
                            bpp: int) -> Optional[np.ndarray]:
    """Paeth-filtered (h, stride + 1) scanlines (filter byte 4 first), or
    None without the library."""
    lib = load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.uint8)
    h, stride = data.shape
    out = np.empty((h, stride + 1), np.uint8)
    lib.rt_png_filter_paeth(data, out, h, stride, bpp)
    return out
