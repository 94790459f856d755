"""Unaligned sequence store: per-partition zstd-compressed blobs.

The reference keeps unaligned sequences out of the index entirely (hive-
partitioned Parquet of zstd blobs, src/silo/storage/unaligned_sequence_store.cpp)
and reads them lazily for the Fasta action. We keep the same shape: a
row-aligned list of dictionary-compressed blobs per partition per segment,
decompressed only for the (<=10k) selected rows.
"""

from __future__ import annotations

from ..common.zstd import DictCompressor, DictDecompressor


class UnalignedPartitionStore:
    def __init__(self, reference_sequence: str):
        self.reference_sequence = reference_sequence
        self.blobs: list[bytes | None] = []
        self._compressor = DictCompressor(reference_sequence.encode("ascii"))
        self._decompressor: DictDecompressor | None = None

    def add(self, sequence: str | None):
        if sequence is None:
            self.blobs.append(None)
        else:
            self.blobs.append(self._compressor.compress(sequence.encode("ascii")))

    def add_compressed(self, blob: bytes | None):
        """Append an already-compressed blob (must use this store's
        reference sequence as dictionary — the ingest spool does)."""
        self.blobs.append(blob)

    def get(self, row: int) -> str | None:
        blob = self.blobs[row]
        if blob is None:
            return None
        if self._decompressor is None:
            self._decompressor = DictDecompressor(self.reference_sequence.encode("ascii"))
        return self._decompressor.decompress(blob).decode("ascii")
