"""ctypes wrapper for the native NDJSON scanner (native/silo_ndjson.cpp).

The scanner tokenizes each NDJSON line in C++, extracts the aligned /
unaligned sequence strings and zstd-dict-compresses them in worker threads
(the reference feeds lines to DuckDB's native JSON reader + a compress UDF,
src/silo/preprocessing/preprocessor.cpp:87-131, sql_function.cpp:21-65).
Python only json.loads the small `metadata` / insertion sub-objects.

Records the scanner cannot handle exactly (escape sequences in sequence
strings, duplicate keys, unusual value types) come back with status < 0 and
the caller re-parses the full line with json.loads — semantics are always
identical to the pure-Python path.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

from ..native import get_named_lib

BLOB_ABSENT = -2
BLOB_NULL = -1


@dataclass
class ParsedRecord:
    status: int
    meta_span: tuple[int, int] | None  # (off, len) into the line
    nuc_ins_span: tuple[int, int] | None
    aa_ins_span: tuple[int, int] | None
    # per segment (scanner order): BLOB_ABSENT | BLOB_NULL | bytes
    blobs: list


class NativeNdjsonScanner:
    """One scanner per ingest run. `segments` is a list of
    (name, category, dictionary_bytes) where category is
    0 = alignedNucleotideSequences, 1 = alignedAminoAcidSequences,
    2 = unalignedNucleotideSequences."""

    def __init__(self, segments, level: int = 3, n_threads: int | None = None):
        lib = get_named_lib("libsilo_ndjson.so")
        if lib is None:
            raise OSError("libsilo_ndjson.so unavailable")
        self._lib = lib
        self._configure(lib)
        self.segments = list(segments)
        n = len(self.segments)
        names_blob = b"".join(name.encode("utf-8") for name, _, _ in self.segments)
        name_lens = (ctypes.c_int32 * n)(
            *[len(name.encode("utf-8")) for name, _, _ in self.segments])
        name_cats = (ctypes.c_int32 * n)(*[cat for _, cat, _ in self.segments])
        dict_blob = b"".join(d for _, _, d in self.segments)
        dict_lens = (ctypes.c_int64 * n)(*[len(d) for _, _, d in self.segments])
        if n_threads is None:
            n_threads = min(os.cpu_count() or 1, 8)
        self._ctx = lib.silo_ndjson_create(
            names_blob, name_lens, name_cats, n,
            dict_blob, dict_lens, level, n_threads,
        )
        if not self._ctx:
            raise OSError("silo_ndjson_create failed")
        self._hdr_ints = lib.silo_ndjson_header_ints(self._ctx)

    @staticmethod
    def _configure(lib):
        if getattr(lib, "_ndjson_configured", False):
            return
        lib.silo_ndjson_create.restype = ctypes.c_void_p
        lib.silo_ndjson_create.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.silo_ndjson_destroy.restype = None
        lib.silo_ndjson_destroy.argtypes = [ctypes.c_void_p]
        lib.silo_ndjson_header_ints.restype = ctypes.c_int32
        lib.silo_ndjson_header_ints.argtypes = [ctypes.c_void_p]
        lib.silo_ndjson_parse.restype = None
        lib.silo_ndjson_parse.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib._ndjson_configured = True

    def parse(self, lines: list[bytes]) -> list[ParsedRecord]:
        """Parse a batch of raw NDJSON lines (no trailing newline needed —
        the scanner tolerates surrounding whitespace)."""
        n = len(lines)
        if n == 0:
            return []
        blob = b"".join(lines)
        offsets = (ctypes.c_int64 * (n + 1))()
        pos = 0
        for i, line in enumerate(lines):
            offsets[i] = pos
            pos += len(line)
        offsets[n] = pos

        headers_p = ctypes.POINTER(ctypes.c_int32)()
        blobs_p = ctypes.POINTER(ctypes.c_uint8)()
        blobs_len = ctypes.c_int64()
        self._lib.silo_ndjson_parse(
            self._ctx, blob, offsets, n,
            ctypes.byref(headers_p), ctypes.byref(blobs_p),
            ctypes.byref(blobs_len),
        )
        hdr_ints = self._hdr_ints
        n_segments = len(self.segments)
        headers = ctypes.cast(
            headers_p, ctypes.POINTER(ctypes.c_int32 * (hdr_ints * n))
        ).contents
        blobs_buf = ctypes.string_at(blobs_p, blobs_len.value) if blobs_len.value else b""

        out = []
        blob_pos = 0
        for i in range(n):
            base = i * hdr_ints
            status = headers[base]
            def span(off_idx):
                off = headers[base + off_idx]
                if off < 0:
                    return None
                return (off, headers[base + off_idx + 1])
            blobs: list = []
            for s in range(n_segments):
                blen = headers[base + 7 + s]
                if blen >= 0:
                    blobs.append(blobs_buf[blob_pos:blob_pos + blen])
                    blob_pos += blen
                else:
                    blobs.append(blen)
            out.append(ParsedRecord(
                status=status,
                meta_span=span(1),
                nuc_ins_span=span(3),
                aa_ins_span=span(5),
                blobs=blobs,
            ))
        return out

    def close(self):
        if self._ctx:
            self._lib.silo_ndjson_destroy(self._ctx)
            self._ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
