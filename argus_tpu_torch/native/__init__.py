"""Native (C++) input-feed runtime: batched PNG decode and centre crop with
libpng, a copy of `argus_tpu/native`.

`loader.cpp` is built with ``g++ -O3 -shared -fPIC -std=c++17 -lpng -lz`` at
first use into `argus_tpu_torch/_build/` (named by a hash of the source) and
bound with ctypes. When no compiler or libpng is there, `available()` is
False and `data.dataset` decodes with cv2 on the host instead, argus_tpu's
order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libargusloader-{digest}.so")


def _build(path: str) -> Optional[str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-lpng", "-lz", "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, path)
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = library_path()
        if not os.path.exists(path):
            path = _build(path)
        if path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _build_failed = True
            return None
        lib.argus_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        lib.argus_decode_batch.restype = ctypes.c_int
        lib.argus_png_size.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.argus_png_size.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native decoder built and loaded."""
    return _load() is not None


def png_size(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG without decoding its pixels."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.argus_png_size(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise FileNotFoundError(f"failed to read PNG header: {path}")
    return h.value, w.value


def decode_batch(paths: Sequence[str], crop_hw: Tuple[int, int], n_threads: int = 8,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode and centre-crop a batch of PNGs -> uint8 (n, crop_h, crop_w, 3),
    in one C call (the thread pool lives in the library)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    n = len(paths)
    ch, cw = crop_hw
    if out is None:
        out = np.empty((n, ch, cw, 3), np.uint8)
    if not out.flags["C_CONTIGUOUS"] or out.shape != (n, ch, cw, 3):
        raise ValueError(f"out must be a contiguous uint8 array of shape {(n, ch, cw, 3)}")
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.argus_decode_batch(arr, n, ch, cw, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    if rc != 0:
        raise IOError(f"native PNG decode failed with code {rc} (first failing image zeroed)")
    return out
