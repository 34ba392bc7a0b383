"""ctypes bridge to the native dataset-loader runtime (``native/dataloader.cpp``).

Counterpart of ``okvis2x_tpu/io/native_loader.py``.  The reference keeps
dataset streaming in C++ (DatasetReader's reader thread and
threadsafe::Queue, okvis_multisensor_processing/src/DatasetReader.cpp); here
the same role is played by a libpng-backed worker pool that decodes frames
ahead of the consumer off the GIL and delivers them strictly in order, and by
a bounded byte queue in native memory.

The source is compiled with g++ on first use into ``build/okvis2x_tpu_torch/``
at the root of the checkout, keyed by the digest of the source and its flags,
under the port's build lock; the JAX package builds its own copy into
``native/``, which the port never loads.  Where the build fails (no libpng:
the H100 machine has none), ``available()`` is False, as in the JAX package,
and frames are decoded by the port's own codec ``io/png.py``; every frame that
takes that route is counted in ``FALLBACKS``.  `NativeQueue` needs the
library and raises without it, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

from okvis2x_tpu_torch.io import png
from okvis2x_tpu_torch.ops.hamming import BUILD_DIR, BUILD_LOCK

SRC = BUILD_DIR.parents[1] / "native" / "dataloader.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
GXX_LIBS = ["-lpng", "-lz", "-lpthread"]

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int)


class _Library:
    """The built library, or the reason it could not be built."""

    def __init__(self):
        self.lib: Optional[ctypes.CDLL] = None
        self.error: Optional[str] = None  # the failed build's message

    def load(self) -> Optional[ctypes.CDLL]:
        with BUILD_LOCK:
            if self.lib is None and self.error is None:
                try:
                    self.lib = self._build_and_load()
                except (OSError, RuntimeError) as e:
                    self.error = str(e)
        return self.lib

    @staticmethod
    def _build_and_load() -> ctypes.CDLL:
        digest = hashlib.sha1(SRC.read_bytes() + " ".join(GXX_FLAGS + GXX_LIBS).encode())
        so = BUILD_DIR / f"libdataloader_{digest.hexdigest()[:12]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC), *GXX_LIBS],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed on {SRC}:\n{res.stdout}{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.dl_decode.restype = ctypes.c_int
        lib.dl_decode.argtypes = [ctypes.c_char_p, _U8P, ctypes.c_int64, _I32P, _I32P]
        lib.dl_open.restype = ctypes.c_void_p
        lib.dl_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.dl_next.restype = ctypes.c_int
        lib.dl_next.argtypes = [ctypes.c_void_p, _U8P, ctypes.c_int64, _I32P, _I32P]
        lib.dl_close.restype = None
        lib.dl_close.argtypes = [ctypes.c_void_p]
        lib.tsq_create.restype = ctypes.c_void_p
        lib.tsq_create.argtypes = [ctypes.c_int]
        lib.tsq_push.restype = ctypes.c_int
        lib.tsq_push.argtypes = [ctypes.c_void_p, _U8P, ctypes.c_int64]
        lib.tsq_push_dropping.restype = ctypes.c_int
        lib.tsq_push_dropping.argtypes = [ctypes.c_void_p, _U8P, ctypes.c_int64]
        lib.tsq_pop.restype = ctypes.c_int64
        lib.tsq_pop.argtypes = [ctypes.c_void_p, _U8P, ctypes.c_int64, ctypes.c_int]
        lib.tsq_size.restype = ctypes.c_int
        lib.tsq_size.argtypes = [ctypes.c_void_p]
        lib.tsq_shutdown.restype = None
        lib.tsq_shutdown.argtypes = [ctypes.c_void_p]
        lib.tsq_destroy.restype = None
        lib.tsq_destroy.argtypes = [ctypes.c_void_p]
        return lib


LIBRARY = _Library()


class _Fallbacks:
    """Frames decoded by ``io/png.py`` instead of the library, counted under
    a lock (the prefetcher runs on the reader thread)."""

    def __init__(self):
        self.frames = 0
        self._lock = threading.Lock()

    def decode(self, path: str) -> np.ndarray:
        with self._lock:
            self.frames += 1
        return png.decode_image(path)

    def reset(self):
        with self._lock:
            self.frames = 0


FALLBACKS = _Fallbacks()


def available() -> bool:
    return LIBRARY.load() is not None


def _frame(buf: np.ndarray, w: ctypes.c_int, h: ctypes.c_int) -> np.ndarray:
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


def decode_image(path: str, max_bytes: int = 1 << 24) -> np.ndarray:
    """Decode one image file to a (H, W) uint8 array."""
    lib = LIBRARY.load()
    if lib is None:
        return FALLBACKS.decode(path)
    buf = np.empty(max_bytes, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.dl_decode(path.encode(), buf.ctypes.data_as(_U8P), max_bytes,
                       ctypes.byref(w), ctypes.byref(h))
    if rc == -2:
        return decode_image(path, max_bytes=w.value * h.value)
    if rc != 0:
        return FALLBACKS.decode(path)
    return _frame(buf, w, h)


class ImagePrefetcher:
    """Iterator over decoded frames, prefetched by native worker threads in
    strict file-list order."""

    def __init__(self, paths: Sequence[str], n_threads: int = 4, window: int = 8,
                 max_bytes: int = 1 << 24):
        self._handle = None
        self._paths: List[str] = list(paths)
        self._max_bytes = max_bytes
        self._i = 0
        self._lib = LIBRARY.load()
        if self._lib is not None and self._paths:
            self._blob = b"".join(p.encode() + b"\0" for p in self._paths)  # kept alive
            self._handle = self._lib.dl_open(self._blob, len(self._paths), n_threads, window)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self._paths)

    def __next__(self) -> np.ndarray:
        if self._i >= len(self._paths):
            self.close()
            raise StopIteration
        path = self._paths[self._i]
        self._i += 1
        if self._handle is None:
            return FALLBACKS.decode(path)
        buf = np.empty(self._max_bytes, np.uint8)
        w, h = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.dl_next(self._handle, buf.ctypes.data_as(_U8P), self._max_bytes,
                               ctypes.byref(w), ctypes.byref(h))
        if rc != 0:  # this frame failed to decode (or outgrew the buffer): it alone falls back
            return FALLBACKS.decode(path)
        return _frame(buf, w, h)

    def close(self):
        if self._handle is not None:
            self._lib.dl_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        self.close()


class NativeQueue:
    """Bounded MPMC queue holding serialized numpy payloads in native memory
    (≙ okvis::threadsafe::Queue semantics: blocking push, dropping push,
    pop with timeout, shutdown)."""

    def __init__(self, capacity: int = 16):
        lib = LIBRARY.load()
        if lib is None:
            raise RuntimeError(f"native dataloader library unavailable: {LIBRARY.error}")
        self._lib = lib
        self._handle = lib.tsq_create(capacity)

    def push(self, data: np.ndarray, block: bool = True) -> int:
        """0 pushed (1: the oldest dropped to make room, non-blocking), -1
        after shutdown."""
        buf = np.ascontiguousarray(data).view(np.uint8).ravel()
        fn = self._lib.tsq_push if block else self._lib.tsq_push_dropping
        return fn(self._handle, buf.ctypes.data_as(_U8P), buf.nbytes)

    def pop(self, max_bytes: int = 1 << 22, timeout_ms: int = -1) -> Optional[np.ndarray]:
        """The oldest payload's bytes, or None on timeout or after shutdown."""
        buf = np.empty(max_bytes, np.uint8)
        n = self._lib.tsq_pop(self._handle, buf.ctypes.data_as(_U8P), max_bytes, timeout_ms)
        if n == -2:
            return self.pop(max_bytes * 4, timeout_ms)
        if n < 0:
            return None
        return buf[:n].copy()

    def size(self) -> int:
        return self._lib.tsq_size(self._handle)

    def shutdown(self):
        self._lib.tsq_shutdown(self._handle)

    def __del__(self):  # pragma: no cover - GC timing
        handle, self._handle = getattr(self, "_handle", None), None
        if handle is not None:
            self._lib.tsq_shutdown(handle)
            self._lib.tsq_destroy(handle)
