"""Minimal zstd bindings over libzstd via ctypes.

The environment has no `zstandard` Python package, but libzstd.so is present.
We need three capabilities (parity with reference src/silo/zstdfasta/
zstd_compressor.cpp / zstd_decompressor.cpp):

- plain compress/decompress (snapshot blobs, .zst input files)
- dictionary compress/decompress where the dictionary is the reference
  genome (sequences differ from the reference in few places, so this is a
  dramatic ratio win)
- streaming decompress for .zst files of unknown decompressed size
"""

from __future__ import annotations

import ctypes
import ctypes.util

_lib = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")

_lib.ZSTD_compressBound.restype = ctypes.c_size_t
_lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
_lib.ZSTD_isError.restype = ctypes.c_uint
_lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
_lib.ZSTD_getErrorName.restype = ctypes.c_char_p
_lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
_lib.ZSTD_compress.restype = ctypes.c_size_t
_lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                               ctypes.c_size_t, ctypes.c_int]
_lib.ZSTD_decompress.restype = ctypes.c_size_t
_lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                 ctypes.c_size_t]
_lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
_lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]

_lib.ZSTD_createCCtx.restype = ctypes.c_void_p
_lib.ZSTD_createDCtx.restype = ctypes.c_void_p
_lib.ZSTD_compress_usingDict.restype = ctypes.c_size_t
_lib.ZSTD_compress_usingDict.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
    ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
_lib.ZSTD_decompress_usingDict.restype = ctypes.c_size_t
_lib.ZSTD_decompress_usingDict.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
    ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]

# Streaming decompression
_lib.ZSTD_createDStream.restype = ctypes.c_void_p
_lib.ZSTD_initDStream.restype = ctypes.c_size_t
_lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
_lib.ZSTD_freeDStream.restype = ctypes.c_size_t
_lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
_lib.ZSTD_DStreamInSize.restype = ctypes.c_size_t
_lib.ZSTD_DStreamOutSize.restype = ctypes.c_size_t


class _Buffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_lib.ZSTD_decompressStream.restype = ctypes.c_size_t
_lib.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Buffer),
                                       ctypes.POINTER(_Buffer)]

_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2


def _check(code: int) -> int:
    if _lib.ZSTD_isError(code):
        raise RuntimeError(f"zstd error: {_lib.ZSTD_getErrorName(code).decode()}")
    return code


def compress(data: bytes, level: int = 3) -> bytes:
    bound = _lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(bound)
    n = _check(_lib.ZSTD_compress(out, bound, data, len(data), level))
    return out.raw[:n]


def decompress(data: bytes, max_size: int | None = None) -> bytes:
    size = _lib.ZSTD_getFrameContentSize(data, len(data))
    if size in (_CONTENTSIZE_UNKNOWN, _CONTENTSIZE_ERROR):
        return decompress_stream(data)
    out = ctypes.create_string_buffer(size)
    n = _check(_lib.ZSTD_decompress(out, size, data, len(data)))
    return out.raw[:n]


def frame_content_size(data: bytes) -> int | None:
    """Decompressed size recorded in the frame header, or None if absent
    (frames we write always carry it)."""
    size = _lib.ZSTD_getFrameContentSize(data, len(data))
    if size in (_CONTENTSIZE_UNKNOWN, _CONTENTSIZE_ERROR):
        return None
    return size


def decompress_into(data: bytes, dest) -> int:
    """Decompress one frame directly into a writable buffer (numpy uint8
    view); returns the decompressed byte count. Avoids the scratch-buffer
    zero-fill and the extra copies of the bytes-returning path."""
    dest = memoryview(dest)
    size = _lib.ZSTD_getFrameContentSize(data, len(data))
    if size in (_CONTENTSIZE_UNKNOWN, _CONTENTSIZE_ERROR):
        raw = decompress_stream(data)
        dest[: len(raw)] = raw
        return len(raw)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(dest))
    return _check(_lib.ZSTD_decompress(
        ctypes.c_void_p(addr), len(dest), data, len(data)))


def decompress_stream(data: bytes) -> bytes:
    """Streaming decompress for frames without a content-size header."""
    ds = _lib.ZSTD_createDStream()
    _check(_lib.ZSTD_initDStream(ds))
    out_chunk = _lib.ZSTD_DStreamOutSize()
    src = ctypes.create_string_buffer(data, len(data))
    in_buf = _Buffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
    chunks = []
    dst = ctypes.create_string_buffer(out_chunk)
    while True:
        out_buf = _Buffer(ctypes.cast(dst, ctypes.c_void_p), out_chunk, 0)
        _check(_lib.ZSTD_decompressStream(ds, ctypes.byref(out_buf), ctypes.byref(in_buf)))
        chunks.append(dst.raw[: out_buf.pos])
        # done only when ALL input is consumed AND zstd flushed everything
        # it had buffered (an exactly-full output buffer means "call again")
        if in_buf.pos >= in_buf.size and out_buf.pos < out_chunk:
            break
    _lib.ZSTD_freeDStream(ds)
    return b"".join(chunks)


class _ZstdRawReader:
    """Incremental .zst reader (io.RawIOBase protocol): decompresses on
    demand so multi-GB inputs never materialize in RAM (the streaming
    counterpart of the reference's boost::iostreams zstd filter,
    src/silo/common/input_stream_wrapper.cpp)."""

    def __init__(self, fileobj):
        import io

        self._f = fileobj
        self._ds = _lib.ZSTD_createDStream()
        _check(_lib.ZSTD_initDStream(self._ds))
        self._in_chunk = _lib.ZSTD_DStreamInSize()
        self._src = b""
        self._src_ptr = None
        self._src_pos = 0
        self._eof = False
        self._io = io
        self._dst = None  # grow-only scratch (create_string_buffer zeroes
        self._dst_cap = 0  # its whole capacity per call — O(cap) memset)

    def readable(self):
        return True

    def readinto(self, b) -> int:
        if self._eof:
            return 0
        view = memoryview(b)
        need = len(view)
        if need > self._dst_cap:
            self._dst = ctypes.create_string_buffer(need)
            self._dst_cap = need
        out_buf = _Buffer(ctypes.cast(self._dst, ctypes.c_void_p), need, 0)
        while out_buf.pos == 0:
            if self._src_pos >= len(self._src):
                self._src = self._f.read(self._in_chunk)
                self._src_pos = 0
                if not self._src:
                    self._eof = True
                    break
                # zstd only READS the input: borrow the bytes in place
                self._src_ptr = ctypes.cast(ctypes.c_char_p(self._src),
                                            ctypes.c_void_p)
            in_buf = _Buffer(self._src_ptr, len(self._src), self._src_pos)
            _check(_lib.ZSTD_decompressStream(
                self._ds, ctypes.byref(out_buf), ctypes.byref(in_buf)))
            self._src_pos = in_buf.pos
        view[: out_buf.pos] = self._dst[: out_buf.pos]
        return out_buf.pos

    def close(self):
        if self._ds is not None:
            _lib.ZSTD_freeDStream(self._ds)
            self._ds = None
        self._f.close()


def open_zst_binary(path: str):
    """Buffered binary stream over a .zst file, decompressed incrementally."""
    import io

    raw = _ZstdRawReader(open(path, "rb"))

    class _Adapter(io.RawIOBase):
        def readable(self):
            return True

        def readinto(self, b):
            return raw.readinto(b)

        def close(self):
            raw.close()
            super().close()

    return io.BufferedReader(_Adapter(), 1 << 20)


def open_zst_text(path: str, encoding: str = "utf-8"):
    """Text stream over a .zst file, decompressed incrementally."""
    import io

    return io.TextIOWrapper(open_zst_binary(path), encoding=encoding)


class DictCompressor:
    """zstd compressor with a fixed dictionary (e.g. the reference genome)."""

    def __init__(self, dictionary: bytes, level: int = 3):
        import threading

        self._dict = dictionary
        self._level = level
        # ZSTD contexts are not thread-safe and the grow-only scratch must
        # not be shared either: stores are queried concurrently (the HTTP
        # servers run many worker threads), so both live per-thread
        # (reference sql_function.cpp uses thread_local compressors too)
        self._local = threading.local()

    def compress(self, data: bytes) -> bytes:
        local = self._local
        if getattr(local, "cctx", None) is None:
            local.cctx = _lib.ZSTD_createCCtx()
            local.buf = None
            local.cap = 0
        bound = _lib.ZSTD_compressBound(len(data))
        if bound > local.cap:
            local.buf = ctypes.create_string_buffer(bound)
            local.cap = bound
        n = _check(_lib.ZSTD_compress_usingDict(
            local.cctx, local.buf, local.cap, data, len(data),
            self._dict, len(self._dict), self._level))
        return local.buf[:n]


class DictDecompressor:
    """zstd decompressor with a fixed dictionary."""

    def __init__(self, dictionary: bytes):
        import threading

        self._dict = dictionary
        self._local = threading.local()  # dctx + scratch per thread (see
        # DictCompressor: stores serve concurrent queries)

    def decompress(self, data: bytes) -> bytes:
        local = self._local
        if getattr(local, "dctx", None) is None:
            local.dctx = _lib.ZSTD_createDCtx()
            local.buf = None
            local.cap = 0
        size = _lib.ZSTD_getFrameContentSize(data, len(data))
        if size in (_CONTENTSIZE_UNKNOWN, _CONTENTSIZE_ERROR):
            # Fall back to a generous bound: dict-based frames we write
            # always carry the content size, so this is input-robustness only.
            size = max(len(self._dict) * 4, len(data) * 20, 1 << 20)
        if size > local.cap:
            local.buf = ctypes.create_string_buffer(size)
            local.cap = size
        n = _check(_lib.ZSTD_decompress_usingDict(
            local.dctx, local.buf, local.cap, data, len(data),
            self._dict, len(self._dict)))
        return local.buf[:n]
