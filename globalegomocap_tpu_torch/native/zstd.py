"""zstd frames through the system's libzstd, bound with ctypes.

Orbax checkpoints (`models/orbax.py`) compress every zarr chunk and every
OCDBT manifest and b-tree node as one zstd frame (RFC 8878).  The port
reads and writes them with the operating system's `libzstd.so.1`
(`ZSTD_compress`, `ZSTD_decompress`, `ZSTD_getFrameContentSize`), loaded
at first use.  There is no other route: where the library is missing,
the first call raises RuntimeError naming it.

The buffers cross by pointer: `compress` reads a C-contiguous numpy
array in place and `decompress_into` writes straight into the caller's
array, so a leaf of a checkpoint is copied once on its way between the
file and the array.  Zarr's chunk frames carry no content size (their
frame header descriptor is 0x00); their size comes from the chunk's
shape and dtype.  A frame that does carry one is sized from it, and one
that carries none and has no size given is decoded into a buffer that
doubles until it fits.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

LIBRARY = "libzstd.so.1"
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2

_lib = None
_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(LIBRARY)
            except OSError as e:
                raise RuntimeError(
                    f"zstd: the system library {LIBRARY} could not be "
                    f"loaded ({e}); Orbax checkpoints need it") from None
            size, vp = ctypes.c_size_t, ctypes.c_void_p
            lib.ZSTD_compress.argtypes = [vp, size, vp, size, ctypes.c_int]
            lib.ZSTD_compress.restype = size
            lib.ZSTD_compressBound.argtypes = [size]
            lib.ZSTD_compressBound.restype = size
            lib.ZSTD_decompress.argtypes = [vp, size, vp, size]
            lib.ZSTD_decompress.restype = size
            lib.ZSTD_getFrameContentSize.argtypes = [vp, size]
            lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            lib.ZSTD_isError.argtypes = [size]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_getErrorName.argtypes = [size]
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _as_bytes(buf) -> np.ndarray:
    """A C-contiguous buffer (bytes, memoryview, numpy array) as a uint8
    array over the same memory."""
    a = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) \
        else buf
    if not a.flags.c_contiguous:
        raise ValueError("zstd: the buffer is not C-contiguous")
    return a.reshape(-1).view(np.uint8)


def _check(lib, ret: int, what: str) -> int:
    if lib.ZSTD_isError(ret):
        raise ValueError(f"zstd: {what}: "
                         f"{lib.ZSTD_getErrorName(ret).decode()}")
    return ret


def compress(buf, level: int = 1) -> memoryview:
    """One zstd frame of `buf` (bytes or a C-contiguous array, read in
    place) at `level`, as a memoryview of a fresh buffer."""
    lib = _library()
    src = _as_bytes(buf)
    dst = np.empty(lib.ZSTD_compressBound(src.size), np.uint8)
    n = _check(lib, lib.ZSTD_compress(dst.ctypes.data, dst.size,
                                      src.ctypes.data, src.size, level),
               "compress")
    return memoryview(dst)[:n]


def content_size(frame) -> int | None:
    """The decompressed size a frame's header states, or None where it
    states none."""
    lib = _library()
    src = _as_bytes(frame)
    n = lib.ZSTD_getFrameContentSize(src.ctypes.data, src.size)
    if n == _CONTENTSIZE_ERROR:
        raise ValueError("zstd: not a zstd frame")
    return None if n == _CONTENTSIZE_UNKNOWN else n


def decompress_into(frame, out: np.ndarray) -> None:
    """Decode `frame` into the C-contiguous array `out`, which must be
    exactly the frame's decompressed size."""
    lib = _library()
    src, dst = _as_bytes(frame), _as_bytes(out)
    n = _check(lib, lib.ZSTD_decompress(dst.ctypes.data, dst.size,
                                        src.ctypes.data, src.size),
               "decompress")
    if n != dst.size:
        raise ValueError(f"zstd: the frame holds {n} bytes, {dst.size} "
                         "expected")


def decompress(frame, size: int | None = None,
               limit: int = 1 << 31) -> bytes:
    """The bytes of `frame`: `size` of them where given, else as many as
    its header states, else decoded into a buffer doubled from 8 times
    the frame's size up to `limit` bytes."""
    if size is None:
        size = content_size(frame)
    if size is not None:
        out = np.empty(size, np.uint8)
        decompress_into(frame, out)
        return out.tobytes()
    lib = _library()
    src = _as_bytes(frame)
    cap = max(8 * src.size, 1 << 16)
    while True:
        out = np.empty(cap, np.uint8)
        ret = lib.ZSTD_decompress(out.ctypes.data, cap, src.ctypes.data,
                                  src.size)
        if not lib.ZSTD_isError(ret):
            return out[:ret].tobytes()
        if cap >= limit or b"too small" not in lib.ZSTD_getErrorName(ret):
            _check(lib, ret, "decompress")
        cap = min(2 * cap, limit)
