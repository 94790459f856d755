"""Input readers: FASTA (with transparent .zst/.xz decompression), TSV.

Parity with reference src/silo/common/fasta_reader.cpp and
input_stream_wrapper.cpp (which probes <file>, <file>.zst, <file>.xz).
"""

from __future__ import annotations

import csv
import io
import lzma
import os

from ..common import zstd


def open_text_stream(path: str, encoding: str = "ascii") -> io.TextIOBase | None:
    """Open <path> as a STREAMING text file, decompressing .zst/.xz
    incrementally (never materializing the whole input); None if absent."""
    if not os.path.exists(path):
        return None
    if path.endswith(".zst"):
        return zstd.open_zst_text(path, encoding=encoding)
    if path.endswith(".xz"):
        return lzma.open(path, "rt", encoding=encoding)
    return open(path, encoding=encoding)


def open_binary_stream(path: str) -> io.BufferedIOBase | None:
    """Binary counterpart of open_text_stream (for the native NDJSON
    scanner, which consumes raw line bytes); None if absent."""
    if not os.path.exists(path):
        return None
    if path.endswith(".zst"):
        return zstd.open_zst_binary(path)
    if path.endswith(".xz"):
        return lzma.open(path, "rb")
    return open(path, "rb")


def open_maybe_compressed(path_no_ext: str, extension: str = ".fasta") -> io.TextIOBase | None:
    """Try <p><ext>, <p><ext>.zst, <p><ext>.xz; None if none exist.
    Streaming for every flavor (reference input_stream_wrapper.cpp probes
    the same suffixes and wraps a decompressing stream)."""
    base = path_no_ext + extension
    for candidate in (base, base + ".zst", base + ".xz"):
        stream = open_text_stream(candidate)
        if stream is not None:
            return stream
    return None


def iter_fasta(stream: io.TextIOBase):
    """Streaming FASTA records: yields (key, sequence) pairs one at a time.
    Multi-line sequences are concatenated."""
    key: str | None = None
    parts: list[str] = []
    for line in stream:
        line = line.rstrip("\n").rstrip("\r")
        if not line:
            continue
        if line.startswith(">"):
            if key is not None:
                yield key, "".join(parts)
            key = line[1:].strip()
            parts = []
        else:
            parts.append(line)
    if key is not None:
        yield key, "".join(parts)


def read_fasta(stream: io.TextIOBase) -> dict[str, str]:
    """FASTA -> {key: sequence} (whole-file form; large inputs should use
    iter_fasta)."""
    return dict(iter_fasta(stream))


def read_fasta_file(path_no_ext: str) -> dict[str, str] | None:
    stream = open_maybe_compressed(path_no_ext)
    if stream is None:
        return None
    with stream:
        return read_fasta(stream)


def read_tsv(path: str) -> tuple[list[str], list[dict[str, str]]]:
    """TSV -> (header, rows as dicts of raw strings)."""
    with open(path, encoding="utf-8", newline="") as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader)
        rows = []
        for raw in reader:
            if not raw:
                continue
            row = {h: (raw[i] if i < len(raw) else "") for i, h in enumerate(header)}
            rows.append(row)
    return header, rows
