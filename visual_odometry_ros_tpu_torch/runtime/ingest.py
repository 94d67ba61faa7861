"""ctypes wrapper for the native ingest runtime (runtime/ingest.cpp).

Counterpart of `visual_odometry_ros_tpu/runtime/ingest.py`: decode-ahead
frame ingestion in a C++ worker thread (8-bit grey/RGB/RGBA PNG and binary
PGM to float32 grey), with the same functions and return codes. The library
is the port's own: at first use `build()` compiles this directory's
`ingest.cpp` with g++ into `build/ingest/` at the repository root, named by
a hash of the source. A failed build raises with the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ingest"
_lib = None


def build() -> Path:
    """Compile ingest.cpp (once per source version); returns the library's path."""
    tag = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    so = BUILD_DIR / f"libvo_ingest_{tag}.so"
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("cannot build native ingest: g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libvo_ingest_{tag}.{os.getpid()}.tmp.so"
    cmd = [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o", str(tmp), "-lz", "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cannot build native ingest: g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    lib.vo_ingest_open.restype = ctypes.c_void_p
    lib.vo_ingest_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.vo_ingest_next.restype = ctypes.c_int
    lib.vo_ingest_next.argtypes = [ctypes.c_void_p, f32p, f32p, ctypes.c_int, ctypes.c_int, i32p, i32p]
    lib.vo_ingest_close.argtypes = [ctypes.c_void_p]
    lib.vo_decode_image.restype = ctypes.c_int
    lib.vo_decode_image.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int, ctypes.c_int, i32p, i32p]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the library builds and loads here (g++ and zlib present)."""
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


def decode_image(path: str, max_h: int = 2048, max_w: int = 4096) -> np.ndarray:
    """One-shot native decode -> float32 grayscale array [H, W]."""
    lib = _load()
    buf = np.empty((max_h, max_w), np.float32)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.vo_decode_image(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_h, max_w,
        ctypes.byref(h), ctypes.byref(w),
    )
    if rc != 0:
        raise ValueError(f"native decode failed for {path}")
    # The C side writes a contiguous h*w block at the buffer start.
    return buf.reshape(-1)[: h.value * w.value].reshape(h.value, w.value).copy()


class NativeSequence:
    """Iterator over decode-ahead stereo (or mono) frames.

    left/right: lists of image paths. Yields (index, left, right | None).
    """

    def __init__(self, left_paths, right_paths=None, queue_depth: int = 4,
                 max_h: int = 2048, max_w: int = 4096):
        self._closed = True
        lib = _load()
        self._lib = lib
        self.max_h, self.max_w = max_h, max_w
        lp = b"\0".join(p.encode() for p in left_paths) + b"\0\0"
        rp = None
        if right_paths:
            if len(right_paths) != len(left_paths):
                raise ValueError(f"{len(left_paths)} left paths but {len(right_paths)} right paths")
            rp = b"\0".join(p.encode() for p in right_paths) + b"\0\0"
        self._handle = lib.vo_ingest_open(lp, rp, queue_depth)
        if not self._handle:
            raise RuntimeError("vo_ingest_open failed (path list mismatch?)")
        self._stereo = right_paths is not None
        self._closed = False

    def __iter__(self):
        lb = np.empty((self.max_h, self.max_w), np.float32)
        rb = np.empty((self.max_h, self.max_w), np.float32)
        h = ctypes.c_int()
        w = ctypes.c_int()
        f32p = ctypes.POINTER(ctypes.c_float)
        while True:
            idx = self._lib.vo_ingest_next(
                self._handle, lb.ctypes.data_as(f32p), rb.ctypes.data_as(f32p), self.max_h, self.max_w,
                ctypes.byref(h), ctypes.byref(w),
            )
            if idx == -2:
                return
            if idx == -1:
                raise ValueError("native decode error in sequence")
            n = h.value * w.value
            left = lb.reshape(-1)[:n].reshape(h.value, w.value).copy()
            right = rb.reshape(-1)[:n].reshape(h.value, w.value).copy() if self._stereo else None
            yield idx, left, right

    def close(self):
        if not self._closed:
            self._lib.vo_ingest_close(self._handle)
            self._closed = True

    def __del__(self):
        self.close()
