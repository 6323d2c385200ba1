"""ctypes binding for the native C++ IO library (native/revo_io.cpp).

Provides PNG decode and a threaded prefetch pipeline that replaces the
reference's IO producer thread (iowrapperRGBD.cpp:257-352).  Falls back to
OpenCV decode transparently when the shared library cannot be built or
loaded (it is compiled from native/revo_io.cpp on first use).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

from revo_tpu.io.native_build import load_native

_lib: Optional[ctypes.CDLL] = None


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    lib = load_native("librevo_io.so")
    if lib is None:
        return None
    lib.revo_png_info.restype = ctypes.c_int
    lib.revo_png_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.revo_load_gray.restype = ctypes.c_int
    lib.revo_load_gray.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.revo_load_depth16.restype = ctypes.c_int
    lib.revo_load_depth16.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.revo_prefetch_create.restype = ctypes.c_void_p
    lib.revo_prefetch_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.revo_prefetch_get.restype = ctypes.c_int
    lib.revo_prefetch_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.revo_prefetch_destroy.restype = None
    lib.revo_prefetch_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def png_info(path: str) -> Tuple[int, int, bool]:
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    w = ctypes.c_int()
    h = ctypes.c_int()
    is16 = ctypes.c_int()
    rc = lib.revo_png_info(path.encode(), w, h, is16)
    if rc != 0:
        raise IOError(f"cannot read PNG {path}")
    return w.value, h.value, bool(is16.value)


def load_gray(path: str) -> np.ndarray:
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    w, h, _ = png_info(path)
    out = np.empty((h, w), np.uint8)
    rc = lib.revo_load_gray(path.encode(), out.ctypes.data, w, h)
    if rc != 0:
        raise IOError(f"gray decode failed ({rc}): {path}")
    return out


def load_depth16(path: str) -> np.ndarray:
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    w, h, _ = png_info(path)
    out = np.empty((h, w), np.uint16)
    rc = lib.revo_load_depth16(path.encode(), out.ctypes.data, w, h)
    if rc != 0:
        raise IOError(f"depth decode failed ({rc}): {path}")
    return out


class NativePrefetcher:
    """Ordered multi-threaded (gray, depth) frame prefetcher.

    Usage:
        with NativePrefetcher(rgb_paths, depth_paths, (480, 640)) as pf:
            for i in range(len(rgb_paths)):
                gray_u8, depth_u16 = pf.get(i)
    """

    def __init__(
        self,
        rgb_paths: Sequence[str],
        depth_paths: Sequence[str],
        shape_hw: Tuple[int, int],
        n_threads: int = 3,
        window: int = 16,
    ):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native IO library unavailable")
        self._lib = lib
        self._n = len(rgb_paths)
        self._h, self._w = shape_hw
        rgb_arr = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in rgb_paths]
        )
        dep_arr = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in depth_paths]
        )
        self._handle = lib.revo_prefetch_create(
            rgb_arr, dep_arr, self._n, n_threads, window
        )
        if not self._handle:
            raise RuntimeError("prefetcher creation failed")

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        gray = np.empty((self._h, self._w), np.uint8)
        depth = np.empty((self._h, self._w), np.uint16)
        rc = self._lib.revo_prefetch_get(
            self._handle, idx, gray.ctypes.data, depth.ctypes.data,
            self._w, self._h,
        )
        if rc != 0:
            raise IOError(f"prefetch_get({idx}) failed ({rc})")
        return gray, depth

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.revo_prefetch_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
