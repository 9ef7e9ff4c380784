"""ctypes bridge to the C++ host runtime (native/libjetpbrt.so).

The reference implements its whole runtime in C++; here the hot *device*
path is JAX/XLA, and the native library accelerates the hot *host* paths:
OBJ parsing and BVH construction. The library is built from the committed
sources at first use (`make -C native`). If the build fails, that is logged
once and everything falls back to the numpy implementations, which give the
same results.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
LIB_PATH = os.path.join(NATIVE_DIR, "libjetpbrt.so")

_LIB = None
_TRIED = False


def _build() -> bool:
    """Build LIB_PATH under a file lock (parallel test workers race here):
    compile to a temporary name, then rename atomically."""
    from .log import log_print

    with open(os.path.join(NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(LIB_PATH):
            return True
        tmp = f"libjetpbrt.so.tmp{os.getpid()}"
        try:
            subprocess.run(["make", "-s", "-C", NATIVE_DIR, f"LIB={tmp}"],
                           check=True, capture_output=True, text=True,
                           timeout=300)
            os.replace(os.path.join(NATIVE_DIR, tmp), LIB_PATH)
            return True
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            log_print("native library build failed; using the numpy "
                      f"fallbacks: {detail.strip()[-500:]}")
            return False
        finally:
            if os.path.exists(os.path.join(NATIVE_DIR, tmp)):
                os.remove(os.path.join(NATIVE_DIR, tmp))


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.path.exists(LIB_PATH) or _build():
        try:
            lib = ctypes.CDLL(LIB_PATH)
            lib.jp_obj_count.restype = ctypes.c_longlong
            lib.jp_obj_count.argtypes = [ctypes.c_char_p]
            lib.jp_obj_load.restype = ctypes.c_longlong
            lib.jp_obj_load.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_longlong,
            ]
            lib.jp_bvh_build.restype = ctypes.c_longlong
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_longlong)
            lib.jp_bvh_build.argtypes = [
                f32p, f32p, f32p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, f32p, f32p, i32p, i32p, i32p, i64p, i64p,
            ]
            _LIB = lib
        except OSError:
            _LIB = None
    return _LIB


def try_load_obj_native(path: str):
    """Returns (tris [T,3,3], uvs [T,3,2]) or None if no native lib."""
    lib = _lib()
    if lib is None:
        return None
    n = lib.jp_obj_count(path.encode())
    if n < 0:
        return None
    tris = np.zeros((n, 3, 3), np.float32)
    uvs = np.zeros((n, 3, 2), np.float32)
    got = lib.jp_obj_load(
        path.encode(),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        uvs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
    )
    if got != n:
        return None
    return tris, uvs


def native_available() -> bool:
    return _lib() is not None


def try_build_bvh_native(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray,
                         leaf_size: int, use_sah: bool):
    """Binned-SAH BVH build in C++ (native/bvh_build.cc). Returns the same
    ((bmin, bmax, miss, leaf_first, leaf_count), order) tuple as the numpy
    builder, or None when the library isn't built."""
    lib = _lib()
    if lib is None:
        return None
    t = len(p0)
    cap = 2 * t + 2
    cap_order = 4 * t + 4 * leaf_size
    bmin = np.zeros((cap, 3), np.float32)
    bmax = np.zeros((cap, 3), np.float32)
    miss = np.zeros((cap,), np.int32)
    leaf_first = np.zeros((cap,), np.int32)
    leaf_count = np.zeros((cap,), np.int32)
    order = np.zeros((cap_order,), np.int64)
    order_len = ctypes.c_longlong(0)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    p0 = np.ascontiguousarray(p0, np.float32)
    p1 = np.ascontiguousarray(p1, np.float32)
    p2 = np.ascontiguousarray(p2, np.float32)
    n_nodes = lib.jp_bvh_build(
        fp(p0), fp(p1), fp(p2), t, leaf_size, int(use_sah),
        fp(bmin), fp(bmax), ip(miss), ip(leaf_first), ip(leaf_count),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        ctypes.byref(order_len),
    )
    if n_nodes <= 0:
        return None
    k = int(n_nodes)
    return (
        (bmin[:k].copy(), bmax[:k].copy(), miss[:k].copy(),
         leaf_first[:k].copy(), leaf_count[:k].copy()),
        order[: order_len.value].copy(),
    )
