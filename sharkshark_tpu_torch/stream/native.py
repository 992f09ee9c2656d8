"""ctypes bindings for the native frame pump (native/framepump.cpp at the
repository root; a copy of the JAX package's stream/native.py).

Build-on-first-use with graceful fallback: if g++ or the build fails,
callers keep the pure-Python pipe path (ffmpeg_io.RawFrameSource). Set
SHARKSHARK_NO_NATIVE=1 to force the Python path.  The library is built
into this package's build/ directory (beside the CUDA kernels), never
into native/, whose libframepump.so belongs to the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..utils import get_logger

__all__ = ["load_library", "NativePump", "NativeSink", "native_available"]

log = get_logger("stream.native")

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "build")
_CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
_LIB = None
_LIB_LOCK = threading.Lock()


def load_library():
    """Build (if needed) and dlopen libframepump.so; None on failure."""
    global _LIB
    if os.environ.get("SHARKSHARK_NO_NATIVE"):
        return None
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB or None
        so = os.path.abspath(os.path.join(_BUILD_DIR, "libframepump.so"))
        src = os.path.abspath(os.path.join(_NATIVE_DIR, "framepump.cpp"))
        try:
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
                # build to a private temp and rename, as native/Makefile does:
                # concurrent processes must never dlopen a half-written .so
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = f"{so}.tmp.{os.getpid()}"
                subprocess.run(
                    [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp, src],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
        except Exception as ex:  # noqa: BLE001 - fall back to Python path
            log.warning("native framepump unavailable: %s", ex)
            _LIB = False
            return None

        lib.pump_create.restype = ctypes.c_void_p
        lib.pump_create.argtypes = [ctypes.c_int, ctypes.c_size_t, ctypes.c_int, ctypes.c_int]
        lib.pump_grab.restype = ctypes.c_int
        lib.pump_grab.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.pump_depth.argtypes = [ctypes.c_void_p]
        lib.pump_eof.argtypes = [ctypes.c_void_p]
        lib.pump_frames_read.restype = ctypes.c_uint64
        lib.pump_frames_read.argtypes = [ctypes.c_void_p]
        lib.pump_frames_dropped.restype = ctypes.c_uint64
        lib.pump_frames_dropped.argtypes = [ctypes.c_void_p]
        lib.pump_shutdown.argtypes = [ctypes.c_void_p]
        lib.pump_destroy.argtypes = [ctypes.c_void_p]

        lib.sink_create.restype = ctypes.c_void_p
        lib.sink_create.argtypes = [
            ctypes.c_int, ctypes.c_size_t, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ]
        lib.sink_put.restype = ctypes.c_int
        lib.sink_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.sink_depth.argtypes = [ctypes.c_void_p]
        lib.sink_broken.argtypes = [ctypes.c_void_p]
        lib.sink_sent.restype = ctypes.c_uint64
        lib.sink_sent.argtypes = [ctypes.c_void_p]
        lib.sink_underruns.restype = ctypes.c_uint64
        lib.sink_underruns.argtypes = [ctypes.c_void_p]
        lib.sink_destroy.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _LIB = lib
        return lib


def native_available() -> bool:
    return load_library() is not None


class NativePump:
    """Ring-buffered pipe reader: grab() -> ndarray of `shape`/`dtype`."""

    def __init__(self, fd: int, shape, dtype=np.uint8, capacity: int = 64,
                 drop_when_full: bool = False):
        self.lib = load_library()
        if self.lib is None:
            raise RuntimeError("native framepump not available")
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.frame_bytes = int(np.prod(self.shape)) * self.dtype.itemsize
        self._p = self.lib.pump_create(
            fd, self.frame_bytes, capacity, int(drop_when_full)
        )

    def grab(self, timeout: float = 30.0):
        buf = np.empty(self.shape, self.dtype)
        rc = self.lib.pump_grab(
            self._p,
            buf.ctypes.data_as(ctypes.c_char_p),
            int(timeout * 1000),
        )
        if rc == 1:
            return buf
        return None  # timeout or EOF

    @property
    def depth(self) -> int:
        return self.lib.pump_depth(self._p)

    @property
    def eof(self) -> bool:
        return bool(self.lib.pump_eof(self._p))

    @property
    def stats(self) -> dict:
        if not self._p:
            return getattr(self, "_final_stats", {"read": 0, "dropped": 0})
        return {
            "read": self.lib.pump_frames_read(self._p),
            "dropped": self.lib.pump_frames_dropped(self._p),
        }

    def shutdown(self) -> None:
        """Cross-thread-safe stop: raises the native stop/eof flags and
        wakes any blocked grab(), WITHOUT freeing the Pump — another
        thread may still be inside pump_grab (ctypes releases the GIL),
        and pump_destroy would delete the ring mutex under it. Call
        terminate() afterwards from the grabbing thread to free."""
        if self._p:
            self.lib.pump_shutdown(self._p)

    def terminate(self) -> None:
        """Join the reader and free the native Pump. Must only run when
        no other thread can be inside grab() (the grabbing thread
        itself, or after it has exited) — use shutdown() cross-thread."""
        if self._p:
            self._final_stats = self.stats
            self.lib.pump_destroy(self._p)
            self._p = None


class NativeSink:
    """Paced ring-buffered pipe writer (native twin of _PacedChannel)."""

    def __init__(self, fd: int, frame_bytes: int, fps: float,
                 capacity: int = 64, realtime: bool = True):
        self.lib = load_library()
        if self.lib is None:
            raise RuntimeError("native framepump not available")
        self.frame_bytes = frame_bytes
        self._s = self.lib.sink_create(
            fd, frame_bytes, capacity, float(fps), int(realtime)
        )

    def put(self, frame: np.ndarray) -> bool:
        frame = np.ascontiguousarray(frame)
        assert frame.nbytes == self.frame_bytes, (frame.nbytes, self.frame_bytes)
        return bool(self.lib.sink_put(self._s, frame.ctypes.data_as(ctypes.c_char_p)))

    @property
    def depth(self) -> int:
        return self.lib.sink_depth(self._s)

    @property
    def broken(self) -> bool:
        return bool(self.lib.sink_broken(self._s))

    @property
    def stats(self) -> dict:
        if not self._s:
            return getattr(self, "_final_stats", {"sent": 0, "underruns": 0})
        return {
            "sent": self.lib.sink_sent(self._s),
            "underruns": self.lib.sink_underruns(self._s),
        }

    def close(self, drain: bool = True) -> None:
        if self._s:
            if drain:
                import time

                while self.lib.sink_depth(self._s) > 0 and not self.broken:
                    time.sleep(0.001)
            self._final_stats = self.stats
            self.lib.sink_destroy(self._s, 0)
            self._s = None
