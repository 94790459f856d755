"""Per-partition compressed sequence spools for streaming ingest.

The reference never holds a corpus of raw genomes in RAM: sequences go
through zstd-compressed DuckDB tables partitioned on disk, and the index
builder streams each partition back out in partition-row order
(reference src/silo/preprocessing/preprocessor.cpp:255-333 +
src/silo/storage/sequence_store.cpp:33-68). This module is the same
pattern without DuckDB: each (segment, partition) gets an append-only
spool file of `(row_idx, zstd blob)` frames, compressed against the
segment's reference sequence as dictionary (common/zstd.DictCompressor ==
the reference's compress UDF, sql_function.cpp:21-65). Peak ingest RAM is
one partition's *compressed* blobs, ~50x smaller than raw genomes.

Frames may arrive in any input-file order; `iter_rows` re-orders by the
row index when reading a partition back (missing rows yield None — null
genomes, which the index builder interprets as all-missing).
"""

from __future__ import annotations

import os
import struct

from ..common.zstd import DictCompressor, DictDecompressor

_FRAME = struct.Struct("<II")  # (row_idx, blob_len)


class SequenceSpool:
    """Disk spool of compressed sequences for ONE segment, split by
    partition. `tag` names the spool files inside `tmpdir`."""

    def __init__(self, tmpdir: str, tag: str, n_partitions: int,
                 dictionary: bytes):
        self.dictionary = dictionary
        self._compressor = DictCompressor(dictionary)
        self._decompressor = DictDecompressor(dictionary)
        self._paths = [
            os.path.join(tmpdir, f"{tag}.p{pid}.spool")
            for pid in range(n_partitions)
        ]
        self._writers = [None] * n_partitions

    def _writer(self, pid: int):
        w = self._writers[pid]
        if w is None:
            w = self._writers[pid] = open(self._paths[pid], "ab", buffering=1 << 20)
        return w

    def add(self, pid: int, row: int, sequence: str | None):
        if sequence is None:
            return  # absent rows read back as None
        self.add_compressed(pid, row, self._compressor.compress(
            sequence.encode("ascii")))

    def add_compressed(self, pid: int, row: int, blob: bytes):
        w = self._writer(pid)
        w.write(_FRAME.pack(row, len(blob)))
        w.write(blob)

    def finish_writes(self):
        for i, w in enumerate(self._writers):
            if w is not None:
                w.close()
                self._writers[i] = None

    def iter_frames(self, pid: int):
        """Yields (row_idx, compressed blob) in file (arrival) order."""
        path = self._paths[pid]
        if not os.path.exists(path):
            return
        with open(path, "rb", buffering=1 << 20) as f:
            while True:
                header = f.read(_FRAME.size)
                if not header:
                    return
                row, size = _FRAME.unpack(header)
                yield row, f.read(size)

    def read_partition(self, pid: int) -> dict[int, bytes]:
        """All of one partition's compressed blobs, keyed by row index
        (later frames for the same row win, matching last-record-wins
        FASTA semantics)."""
        return dict(self.iter_frames(pid))

    def iter_rows(self, pid: int, n_rows: int):
        """Yields the partition's sequences (bytes | None) in row order,
        decompressing one at a time (bytes, not str — the index builder
        consumes raw ASCII and a decode/encode round-trip is pure waste)."""
        blobs = self.read_partition(pid)
        for row in range(n_rows):
            blob = blobs.get(row)
            yield (None if blob is None
                   else self._decompressor.decompress(blob))

    def route(self, target: "SequenceSpool",
              assignment: list[tuple[int, int]]):
        """Re-route a single-partition global spool (rows = global row ids)
        into `target`'s per-partition spools. `assignment[global_row] =
        (pid, local_row)`. Blobs move verbatim (same dictionary) — no
        decompression."""
        for global_row, blob in self.iter_frames(0):
            pid, local_row = assignment[global_row]
            target.add_compressed(pid, local_row, blob)
        target.finish_writes()

    def reset(self):
        """Drop any partial frames from a crashed prior run (resume path):
        duplicates would still read back correctly — last frame per row
        wins — but re-appending doubles the disk footprint."""
        self.cleanup()

    def cleanup(self):
        self.finish_writes()
        for path in self._paths:
            if os.path.exists(path):
                os.unlink(path)
