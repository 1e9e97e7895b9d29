"""Frame pump: threaded, double-buffered frame IO.

Prefers the native C++ pump (``native/libwmpump.so``, built with
``make -C native``) — a reader/writer thread pair with a ring of frame
buffers so decode/encode IO overlaps device compute, replacing the reference's
synchronous pinned-buffer loop
(``/root/reference/Watermark_GPU/main.cpp:271-275,319-340``). Falls back to a
pure-Python threaded implementation with identical semantics when the shared
library is not built.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "libwmpump.so")

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _lib = False
        return _lib
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        _lib = False
        return _lib
    lib.wmp_reader_open.restype = ctypes.c_void_p
    lib.wmp_reader_open.argtypes = [ctypes.c_int, ctypes.c_size_t,
                                    ctypes.c_int]
    lib.wmp_reader_next.restype = ctypes.c_int
    lib.wmp_reader_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.wmp_reader_close.argtypes = [ctypes.c_void_p]
    lib.wmp_writer_open.restype = ctypes.c_void_p
    lib.wmp_writer_open.argtypes = [ctypes.c_int, ctypes.c_size_t,
                                    ctypes.c_int]
    lib.wmp_writer_put.restype = ctypes.c_int
    lib.wmp_writer_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.wmp_writer_close.restype = ctypes.c_int
    lib.wmp_writer_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return bool(_load_lib())


class FrameReader:
    """Prefetching reader of fixed-size frames from a file descriptor."""

    def __init__(self, fd: int, frame_bytes: int, depth: int = 4,
                 force_python: bool = False):
        self.frame_bytes = frame_bytes
        lib = None if force_python else _load_lib()
        self._native = bool(lib)
        if self._native:
            self._lib = lib
            self._handle = lib.wmp_reader_open(fd, frame_bytes, depth)
            self._buf = ctypes.create_string_buffer(frame_bytes)
        else:
            self._queue: queue.Queue = queue.Queue(maxsize=depth)
            self._fd = fd
            self._exc: OSError | None = None
            self._done = False
            self._thread = threading.Thread(target=self._pump, daemon=True)
            self._thread.start()

    def _pump(self):
        # Whatever happens — clean EOF, short trailing frame, or the fd
        # being closed/going bad mid-stream — this thread MUST enqueue the
        # terminal None sentinel before exiting, or a consumer blocked in
        # next()'s queue.get() waits forever (the native reader handles the
        # same event via its rc<0 path, native/wmpump.cpp read_full<0).
        try:
            while True:
                chunks = []
                remaining = self.frame_bytes
                while remaining:
                    chunk = os.read(self._fd, remaining)
                    if not chunk:
                        break
                    chunks.append(chunk)
                    remaining -= len(chunk)
                if remaining:      # EOF (partial trailing frame dropped)
                    break
                self._queue.put(b"".join(chunks))
        except OSError as exc:     # fd closed / EBADF / EIO mid-stream
            self._exc = exc
        finally:
            self._queue.put(None)

    def next(self) -> np.ndarray | None:
        """Next frame as a uint8 array, or None at EOF.

        Raises IOError if the underlying read failed (e.g. the source fd
        was closed mid-stream) — mirroring the native reader's rc<0 path.
        """
        if self._native:
            rc = self._lib.wmp_reader_next(self._handle, self._buf)
            if rc <= 0:
                if rc < 0:
                    raise IOError("native frame reader failed")
                return None
            return np.frombuffer(self._buf.raw, dtype=np.uint8).copy()
        if not self._done:
            data = self._queue.get()
            if data is not None:
                return np.frombuffer(data, dtype=np.uint8)
            self._done = True      # terminal: every later call short-circuits
        if self._exc is not None:
            raise IOError("frame reader failed") from self._exc
        return None

    def close(self):
        if self._native and self._handle:
            self._lib.wmp_reader_close(self._handle)
            self._handle = None


class FrameWriter:
    """Buffered writer of fixed-size frames to a file descriptor."""

    def __init__(self, fd: int, frame_bytes: int, depth: int = 4,
                 force_python: bool = False):
        self.frame_bytes = frame_bytes
        lib = None if force_python else _load_lib()
        self._native = bool(lib)
        if self._native:
            self._lib = lib
            self._handle = lib.wmp_writer_open(fd, frame_bytes, depth)
        else:
            self._fd = fd
            self._queue: queue.Queue = queue.Queue(maxsize=depth)
            self._error = False
            self._thread = threading.Thread(target=self._pump, daemon=True)
            self._thread.start()

    def _pump(self):
        while True:
            data = self._queue.get()
            if data is None:
                return
            if self._error:
                continue           # drain mode: keep put() from blocking
            try:
                # loop on short writes (signal interruption mid-frame would
                # silently desynchronize the yuv420p stream otherwise;
                # mirrors write_full in native/wmpump.cpp)
                view = memoryview(data)
                while view:
                    written = os.write(self._fd, view)
                    view = view[written:]
            except OSError:
                # Do NOT exit: a producer blocked in put() on a full queue
                # would never unblock. Stay alive discarding frames until
                # close() sends the None sentinel; put() raises on the next
                # call once it observes _error.
                self._error = True

    def put(self, frame: np.ndarray | bytes):
        """Queue one frame. Arrays are passed ZERO-COPY (enqueued by
        reference on the Python path; pointer handed to the native ring,
        which memcpys into its own buffer) — the caller must not mutate
        an array after putting it. The old ``tobytes()`` staging copied
        every frame twice on the egress hot path (r5 soak attribution)."""
        if isinstance(frame, np.ndarray):
            if frame.dtype != np.uint8 or not frame.flags.c_contiguous:
                frame = np.ascontiguousarray(frame, dtype=np.uint8)
            nbytes = frame.nbytes
        else:
            nbytes = len(frame)
        if nbytes != self.frame_bytes:
            raise ValueError(
                f"frame is {nbytes} bytes, expected {self.frame_bytes}")
        if self._native:
            src = (frame.ctypes.data_as(ctypes.c_char_p)
                   if isinstance(frame, np.ndarray) else frame)
            if self._lib.wmp_writer_put(self._handle, src) < 0:
                raise IOError("native frame writer failed")
        else:
            if self._error:
                raise IOError("frame writer failed")
            self._queue.put(frame)

    def close(self):
        if self._native:
            if self._handle:
                rc = self._lib.wmp_writer_close(self._handle)
                self._handle = None
                if rc < 0:
                    raise IOError("native frame writer failed on close")
        else:
            self._queue.put(None)
            self._thread.join()
            if self._error:
                raise IOError("frame writer failed")
