"""Stored-row backends for the compact segment index.

Two physical layouts behind one interface:

- ``DenseRowStore``: ``uint32[ns, W]`` — every stored row holds all W packed
  words. Right for small corpora (W below ~8k words) where rows are
  word-dense anyway and O(1) row views matter.
- ``CsrRowStore``: CSR-of-words — per row only the *non-zero* words as
  ``(word_idx, word)`` pairs in one flat pair of arrays plus row offsets.
  At 10M sequences a typical mutation row has ~10^2..10^3 set bits spread
  over 312k words, so CSR cuts row memory ~100x and is what unlocks
  10M+ sequences per host / chip. The device engine mirrors this split as
  a two-tier bank (ops/device_engine.py).

Both stores are immutable after construction. Row order is whatever the
caller fixed (SegmentIndex keeps pos-major order).
"""

from __future__ import annotations

import numpy as np

# Corpora with at least this many packed words get CSR rows by default
# (256k sequences); below it dense rows are smaller in practice and faster.
CSR_MIN_WORDS = 8192
# A row denser than 1/DENSITY_CUTOFF non-zero words stays dense on device.
DENSITY_CUTOFF = 8


class DenseRowStore:
    kind = "dense"

    def __init__(self, rows: np.ndarray):
        assert rows.dtype == np.uint32 and rows.ndim == 2
        self.rows = rows
        self.n_stored, self.n_words = rows.shape

    def row(self, i: int) -> np.ndarray:
        return self.rows[i]

    def materialize(self, indices) -> np.ndarray:
        return self.rows[indices]

    def or_rows(self, indices) -> np.ndarray:
        if len(indices) == 0:
            return np.zeros(self.n_words, dtype=np.uint32)
        return np.bitwise_or.reduce(self.rows[indices], axis=0)

    def popcounts(self) -> np.ndarray:
        return _chunked(self.rows, None)

    def masked_popcounts(self, filter_words: np.ndarray) -> np.ndarray:
        return _chunked(self.rows, filter_words)

    def word_column(self, word: int) -> np.ndarray:
        """uint32[ns]: the given packed word of every stored row."""
        return self.rows[:, word]

    def replace_row(self, i: int, dense_row: np.ndarray) -> "DenseRowStore":
        self.rows[i] = dense_row
        return self

    def row_nnz(self) -> np.ndarray:
        """int64[ns]: non-zero word count per row."""
        out = np.empty(self.n_stored, dtype=np.int64)
        chunk = max(1, (64 << 20) // max(1, self.n_words * 4))
        for lo in range(0, self.n_stored, chunk):
            out[lo : lo + chunk] = np.count_nonzero(self.rows[lo : lo + chunk], axis=1)
        return out

    def row_words(self, i: int):
        """(word_idx int32[], words u32[]) of one row's non-zero words."""
        nz = np.nonzero(self.rows[i])[0]
        return nz.astype(np.int32), self.rows[i][nz]

    def gather_rows_csr(self, indices):
        """Concatenated non-zero words of the given rows:
        (idx int32[], words u32[], lengths int64[len(indices)])."""
        parts = [self.row_words(int(i)) for i in indices]
        lengths = np.array([len(p[0]) for p in parts], dtype=np.int64)
        if not parts:
            return (np.zeros(0, np.int32), np.zeros(0, np.uint32), lengths)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]), lengths)

    def nbytes(self) -> int:
        return int(self.rows.nbytes)

    def reorder(self, order: np.ndarray) -> "DenseRowStore":
        return DenseRowStore(np.ascontiguousarray(self.rows[order]))


class CsrRowStore:
    kind = "csr"

    def __init__(self, n_words: int, idx: np.ndarray, words: np.ndarray,
                 offsets: np.ndarray):
        assert idx.dtype == np.int32 and words.dtype == np.uint32
        self.n_words = n_words
        self.idx = idx
        self.words = words
        self.offsets = offsets.astype(np.int64)
        self.n_stored = len(offsets) - 1

    @classmethod
    def from_coo(cls, n_words: int, n_stored: int, row_ids: np.ndarray,
                 idx: np.ndarray, words: np.ndarray) -> "CsrRowStore":
        """COO triples -> CSR; duplicate (row, idx) pairs OR-merge (batches
        sharing a 32-sequence boundary word each contribute a partial)."""
        order = np.lexsort((idx, row_ids))
        row_ids, idx, words = row_ids[order], idx[order], words[order]
        if len(row_ids):
            key = row_ids.astype(np.int64) * n_words + idx
            first = np.empty(len(key), dtype=bool)
            first[0] = True
            np.not_equal(key[1:], key[:-1], out=first[1:])
            if not first.all():
                group = np.cumsum(first) - 1
                merged = np.zeros(int(group[-1]) + 1, dtype=np.uint32)
                np.bitwise_or.at(merged, group, words)
                row_ids, idx, words = row_ids[first], idx[first], merged
        offsets = np.zeros(n_stored + 1, dtype=np.int64)
        np.add.at(offsets, row_ids + 1, 1)
        np.cumsum(offsets, out=offsets)
        return cls(n_words, idx.astype(np.int32), words.astype(np.uint32), offsets)

    def _slice(self, i: int) -> slice:
        return slice(int(self.offsets[i]), int(self.offsets[i + 1]))

    def row(self, i: int) -> np.ndarray:
        out = np.zeros(self.n_words, dtype=np.uint32)
        sl = self._slice(i)
        out[self.idx[sl]] = self.words[sl]
        return out

    def materialize(self, indices) -> np.ndarray:
        out = np.zeros((len(indices), self.n_words), dtype=np.uint32)
        for j, i in enumerate(indices):
            sl = self._slice(int(i))
            out[j, self.idx[sl]] = self.words[sl]
        return out

    def or_rows(self, indices) -> np.ndarray:
        out = np.zeros(self.n_words, dtype=np.uint32)
        for i in indices:
            sl = self._slice(int(i))
            np.bitwise_or.at(out, self.idx[sl], self.words[sl])
        return out

    def popcounts(self) -> np.ndarray:
        per_word = np.bitwise_count(self.words).astype(np.int64)
        return np.add.reduceat(
            np.concatenate([per_word, [0]]),
            np.minimum(self.offsets[:-1], len(per_word)),
        ) * (np.diff(self.offsets) > 0)

    def masked_popcounts(self, filter_words: np.ndarray) -> np.ndarray:
        per_word = np.bitwise_count(self.words & filter_words[self.idx]).astype(np.int64)
        return np.add.reduceat(
            np.concatenate([per_word, [0]]),
            np.minimum(self.offsets[:-1], len(per_word)),
        ) * (np.diff(self.offsets) > 0)

    def word_column(self, word: int) -> np.ndarray:
        """uint32[ns]: the given packed word of every stored row."""
        hits = np.nonzero(self.idx == word)[0]
        rows = np.searchsorted(self.offsets, hits, side="right") - 1
        out = np.zeros(self.n_stored, dtype=np.uint32)
        out[rows] = self.words[hits]
        return out

    def replace_row(self, i: int, dense_row: np.ndarray) -> "CsrRowStore":
        """Splice a row's entries with the non-zero words of `dense_row`."""
        nz = np.nonzero(dense_row)[0].astype(np.int32)
        sl = self._slice(i)
        idx = np.concatenate([self.idx[: sl.start], nz, self.idx[sl.stop :]])
        words = np.concatenate(
            [self.words[: sl.start], dense_row[nz], self.words[sl.stop :]]
        )
        delta = len(nz) - (sl.stop - sl.start)
        offsets = self.offsets.copy()
        offsets[i + 1 :] += delta
        return CsrRowStore(self.n_words, idx, words, offsets)

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.offsets)

    def row_words(self, i: int):
        sl = self._slice(i)
        return self.idx[sl], self.words[sl]

    def gather_rows_csr(self, indices):
        indices = np.asarray(indices, dtype=np.int64)
        lengths = np.diff(self.offsets)[indices]
        if len(indices) == self.n_stored and (np.diff(indices) == 1).all() \
                and (len(indices) == 0 or indices[0] == 0):
            return self.idx, self.words, lengths  # identity: whole store
        gather = _segment_gather_indices(self.offsets, indices, lengths)
        return self.idx[gather], self.words[gather], lengths

    def nbytes(self) -> int:
        return int(self.idx.nbytes + self.words.nbytes + self.offsets.nbytes)

    def reorder(self, order: np.ndarray) -> "CsrRowStore":
        lengths = np.diff(self.offsets)[order]
        new_offsets = np.zeros(len(order) + 1, dtype=np.int64)
        np.cumsum(lengths, out=new_offsets[1:])
        gather = _segment_gather_indices(self.offsets, order, lengths)
        return CsrRowStore(self.n_words, self.idx[gather], self.words[gather],
                           new_offsets)


def _segment_gather_indices(offsets, order, lengths):
    """Flat indices that pull each reordered row's entries in sequence."""
    total = int(lengths.sum())
    out = np.empty(total, dtype=np.int64)
    pos = 0
    for i, length in zip(order, lengths):
        sl = slice(int(offsets[i]), int(offsets[i]) + int(length))
        out[pos : pos + int(length)] = np.arange(sl.start, sl.stop)
        pos += int(length)
    return out


def _chunked(rows: np.ndarray, filter_words) -> np.ndarray:
    counts = np.empty(rows.shape[0], dtype=np.int64)
    chunk = max(1, (64 << 20) // max(1, rows.shape[1] * 4))
    for lo in range(0, rows.shape[0], chunk):
        block = rows[lo : lo + chunk]
        if filter_words is not None:
            block = block & filter_words
        counts[lo : lo + chunk] = np.bitwise_count(block).sum(axis=-1, dtype=np.int64)
    return counts
