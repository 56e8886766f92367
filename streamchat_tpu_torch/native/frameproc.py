"""Host-side frame preprocessing in C++ (`streamchat_tpu/native/frameproc.py`).

`preprocess_frames_host(frames)` does on the host what
`pipeline/preprocess.preprocess_frames` does on the card: uint8 RGB
[N, H, W, 3] -> CLIP-normalized float32 [N, 3, S, S] (shortest-edge
antialiased bicubic resize, center crop, mean / std), threaded across
frames. `frameproc.cpp` beside this file is a byte-for-byte copy of the
repo's `native/frameproc.cpp`.

The library is built at first use with the original's flags (`g++ -O3
-march=native -shared -fPIC`: the same code generation keeps its results,
and anyres's, the JAX package's bit for bit) into the package's `build/`
directory, and rebuilt when the source is newer. Each
build writes a name of its own and `os.replace`s it into place, so
processes that build at once (test workers) never load a half-written
file. A failed build, a library that will not load or an ABI version other
than the source's raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from typing import Optional

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(PKG_DIR, "native", "frameproc.cpp")
SO = os.path.join(PKG_DIR, "build", "libframeproc.so")
ABI_VERSION = 1
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> dict:
    """Compile frameproc.cpp into SO when stale (or `force`) ->
    {"seconds", "built"}; raises RuntimeError with g++'s output on failure."""
    stale = (force or not os.path.exists(SO)
             or os.path.getmtime(SO) < os.path.getmtime(SRC))
    if not stale:
        return {"seconds": 0.0, "built": False}
    os.makedirs(os.path.dirname(SO), exist_ok=True)
    tmp = f"{SO}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"frameproc: g++ could not build {SRC}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"frameproc: g++ failed on {SRC}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, SO)
    return {"seconds": time.perf_counter() - t0, "built": True}


def library() -> ctypes.CDLL:
    """The loaded library (built first when stale)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(SO)
            lib.preprocess_frames.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
            lib.preprocess_frames.restype = None
            lib.frameproc_abi_version.restype = ctypes.c_int
            version = lib.frameproc_abi_version()
            if version != ABI_VERSION:
                raise RuntimeError(f"frameproc: {SO} has ABI version {version}, "
                                   f"expected {ABI_VERSION}")
            _lib = lib
        return _lib


def preprocess_frames_host(frames: np.ndarray, image_size: int = 336,
                           num_threads: int = 0) -> np.ndarray:
    """uint8 RGB [N, H, W, 3] -> normalized float32 [N, 3, S, S] on the
    host; `num_threads` <= 0 uses every hardware thread."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected RGB frames [N, H, W, 3], got {frames.shape}")
    n, h, w, _ = frames.shape
    out = np.empty((n, 3, image_size, image_size), np.float32)
    if n == 0:
        return out
    library().preprocess_frames(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), image_size, num_threads)
    return out
