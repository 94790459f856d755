"""Compact packed-u32 bitplane index for one sequence segment.

This replaces the reference's per-position Roaring bitmap maps
(src/silo/storage/sequence_store.cpp, src/silo/storage/position.cpp) with a
TPU-native *compact row* layout — the host-side twin of the device bank in
ops/device_engine.py:

- Logically the index is dense ``[S, L, W]``: S = alphabet size, L =
  reference length, W = ceil(sequence_count/32) packed words over sequence
  ids; bit ``i`` of word ``w`` = sequence ``w*32+i`` has symbol ``s`` at
  position ``p``.
- Physically only *stored rows* exist: (symbol, position) pairs that have
  any bit set AND are not the per-position majority symbol. The majority
  row is implicit (every sequence has exactly one symbol per position, so
  majority = full & ~OR(stored siblings)); empty rows are implicit zeros.
  This is the analog of the reference's deleted-most-numerous-bitmap
  optimization (position.cpp:101-127).
- Stored rows live in a RowStore (storage/rowstore.py): dense [ns, W] for
  small corpora, CSR-of-words above CSR_MIN_WORDS — mutation rows touch a
  tiny fraction of the packed words at millions-of-sequences scale, so CSR
  is what takes one host/chip to 10M+ sequences.

Sequences ingested as NULL are all-missing: the reference skips them in
fillIndexes but marks every position in their missing-symbol bitmap
(sequence_store.cpp:160-170); here a null row simply has the missing symbol
at every position, preserving the one-symbol-per-position invariant the
implicit-majority reconstruction relies on.

Streaming build: the builder allocates rows lazily (implicit majority =
the reference symbol, so the dense reference rows are never materialized)
and re-picks the true per-position majority at finish() — host memory stays
proportional to the *compact* size throughout ingest.
"""

from __future__ import annotations

import numpy as np

from ..common.symbols import Alphabet
from ..ops import bitset
from .rowstore import CSR_MIN_WORDS, CsrRowStore, DenseRowStore

_ROW_CHUNK = 1024  # growth granularity for the dense builder's row store


class SegmentIndex:
    """Compact segment index.

    Attributes (all read-only after construction):
      majority    uint8[L]   per-position implicit symbol
      sym_ids     int32[ns]  stored-row symbols (pos-major order)
      pos_ids     int32[ns]  stored-row positions (ascending)
      store       RowStore   stored-row packed words (dense or CSR)
      counts      int64[ns]  popcount per stored row
      row_map     int32[S, L]  -1 = empty, -2 = majority, else row index
      pos_offsets int64[L+1] CSR offsets: rows at position p are
                  store rows [pos_offsets[p]:pos_offsets[p+1]]
    """

    def __init__(self, alphabet: Alphabet, reference_ids: np.ndarray, n_rows: int,
                 majority: np.ndarray, sym_ids: np.ndarray, pos_ids: np.ndarray,
                 store, counts: np.ndarray | None = None):
        self.alphabet = alphabet
        self.reference_ids = reference_ids
        self.length = len(reference_ids)
        self.n_rows = n_rows
        self.n_words = bitset.words_for(n_rows)
        if isinstance(store, np.ndarray):
            store = DenseRowStore(store)
        assert store.n_stored == len(sym_ids), (store.n_stored, len(sym_ids))
        assert store.n_words == self.n_words, (store.n_words, self.n_words)
        # enforce pos-major order (contiguous per-position slices)
        if len(pos_ids) and not (np.diff(pos_ids) >= 0).all():
            order = np.lexsort((sym_ids, pos_ids))
            sym_ids, pos_ids = sym_ids[order], pos_ids[order]
            store = store.reorder(order)
            if counts is not None:
                counts = counts[order]
        self.majority = majority.astype(np.uint8)
        self.sym_ids = sym_ids.astype(np.int32)
        self.pos_ids = pos_ids.astype(np.int32)
        self.store = store
        if counts is None:
            counts = store.popcounts()
        self.counts = counts.astype(np.int64)
        self.row_map = np.full((alphabet.count, self.length), -1, dtype=np.int32)
        self.row_map[self.majority, np.arange(self.length)] = -2
        self.row_map[self.sym_ids, self.pos_ids] = np.arange(len(sym_ids), dtype=np.int32)
        self.pos_offsets = np.zeros(self.length + 1, dtype=np.int64)
        np.add.at(self.pos_offsets, self.pos_ids + 1, 1)
        np.cumsum(self.pos_offsets, out=self.pos_offsets)
        self.full = bitset.full_mask(n_rows)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_dense(cls, alphabet: Alphabet, reference_ids: np.ndarray, n_rows: int,
                   planes: np.ndarray) -> "SegmentIndex":
        """Compact a dense [S, L, W] plane tensor (legacy snapshots, tests)."""
        set_bits = np.bitwise_count(planes).sum(axis=-1, dtype=np.int64)  # [S, L]
        majority = np.argmax(set_bits, axis=0).astype(np.uint8)
        present = set_bits > 0
        present[majority, np.arange(planes.shape[1])] = False
        sym_ids, pos_ids = np.nonzero(present)
        order = np.lexsort((sym_ids, pos_ids))
        sym_ids, pos_ids = sym_ids[order], pos_ids[order]
        rows = np.ascontiguousarray(planes[sym_ids, pos_ids])
        return cls(alphabet, reference_ids, n_rows, majority,
                   sym_ids, pos_ids, DenseRowStore(rows),
                   counts=set_bits[sym_ids, pos_ids])

    # -- row access --------------------------------------------------------

    def stored_at(self, position: int) -> np.ndarray:
        return np.arange(int(self.pos_offsets[position]),
                         int(self.pos_offsets[position + 1]))

    def plane(self, symbol_id: int, position: int) -> np.ndarray:
        """The packed words of one (symbol, position) row. Stored rows may
        be returned as views (callers must not mutate); implicit rows are
        reconstructed fresh."""
        idx = int(self.row_map[symbol_id, position])
        if idx >= 0:
            return self.store.row(idx)
        if idx == -1:
            return np.zeros(self.n_words, dtype=np.uint32)
        members = self.stored_at(position)
        if len(members) == 0:
            return self.full.copy()
        return self.full & ~self.store.or_rows(members)

    def set_bits_matrix(self) -> np.ndarray:
        """Dense [S, L] matrix of per-row popcounts (majority reconstructed
        as n_rows - sum(stored at position))."""
        out = np.zeros((self.alphabet.count, self.length), dtype=np.int64)
        out[self.sym_ids, self.pos_ids] = self.counts
        per_pos = np.zeros(self.length, dtype=np.int64)
        np.add.at(per_pos, self.pos_ids, self.counts)
        out[self.majority, np.arange(self.length)] = self.n_rows - per_pos
        return out

    def mutation_counts(self, filter_words: np.ndarray) -> np.ndarray:
        """[S, L] popcount(plane & filter) — the host-path Mutations
        reduction (reference mutations.cpp; device twin in
        ops/device_engine.mutation_counts)."""
        out = np.zeros((self.alphabet.count, self.length), dtype=np.int64)
        filter_total = bitset.popcount(filter_words)
        stored = self.store.masked_popcounts(filter_words)
        out[self.sym_ids, self.pos_ids] = stored
        per_pos = np.zeros(self.length, dtype=np.int64)
        np.add.at(per_pos, self.pos_ids, stored)
        out[self.majority, np.arange(self.length)] = filter_total - per_pos
        return out

    # -- introspection -----------------------------------------------------

    def plane_nbytes(self) -> int:
        """Bytes of ONE logical dense plane row-set [L, W] — the /info
        dense-analog unit (see storage/database.py)."""
        return self.length * self.n_words * 4

    def size_in_bytes(self) -> int:
        """Logical dense size [S, L, W] — /info reports the dense analog so
        numbers stay comparable across physical layouts."""
        return self.alphabet.count * self.plane_nbytes()

    def reconstruct_rows(self, rows: np.ndarray) -> list[str]:
        """Rebuild aligned sequence strings for the given sequence ids
        (FastaAligned action): start from the per-position majority symbol,
        override from stored rows containing the sequence's bit. Sequences
        sharing a packed word share one store scan."""
        out_by_request = {}
        chars = np.array([ord(c) for c in self.alphabet.chars], dtype=np.uint8)
        rows = np.asarray(rows, dtype=np.int64)
        for word in np.unique(rows >> 5):
            members = rows[(rows >> 5) == word]
            column = self.store.word_column(int(word))  # uint32[ns]
            for row in members:
                bit = int(row) & 31
                hits = np.nonzero((column >> np.uint32(bit)) & np.uint32(1))[0]
                sym = self.majority.copy()
                sym[self.pos_ids[hits]] = self.sym_ids[hits]
                out_by_request[int(row)] = bytes(chars[sym]).decode("ascii")
        return [out_by_request[int(r)] for r in rows]


class SegmentIndexBuilder:
    """Streaming builder: accumulates genome batches directly into compact
    rows. During the stream the implicit majority is the *reference* symbol
    (known up front, overwhelmingly the true majority for aligned viral
    data); rows for any other (symbol, position) are allocated on first
    appearance. finish() re-picks the exact per-position majority and swaps
    rows where the reference lost (e.g. fixed mutations), so the final
    index is as small as a two-pass build — but peak host memory stays
    ~compact-sized throughout.

    Large corpora (W >= CSR_MIN_WORDS, i.e. 256k+ sequences) accumulate
    COO-of-words chunks per batch and finish into a CsrRowStore; small ones
    scatter directly into dense [ns, W] rows."""

    def __init__(self, alphabet: Alphabet, reference_ids: np.ndarray, n_rows: int,
                 force_csr: bool | None = None):
        self.alphabet = alphabet
        self.reference_ids = np.asarray(reference_ids, dtype=np.uint8)
        self.length = len(reference_ids)
        self.n_rows = n_rows
        self.n_words = bitset.words_for(n_rows)
        self.use_csr = (self.n_words >= CSR_MIN_WORDS if force_csr is None
                        else force_csr)
        self.row_map = np.full((alphabet.count, self.length), -1, dtype=np.int32)
        self.row_map[self.reference_ids, np.arange(self.length)] = -2
        self.rows = np.zeros((0, 0 if self.use_csr else self.n_words), dtype=np.uint32)
        self.sym_ids: list[int] = []
        self.pos_ids: list[int] = []
        self._coo: list[tuple] = []  # csr mode: (row_ids, word_idx, words) chunks
        self._n_stored = 0
        self._row = 0

    def _ensure_capacity(self, needed: int):
        cap = self.rows.shape[0]
        if needed <= cap:
            return
        new_cap = max(needed, cap + (cap >> 1), _ROW_CHUNK)
        grown = np.zeros((new_cap, self.rows.shape[1]), dtype=np.uint32)
        grown[: self._n_stored] = self.rows[: self._n_stored]
        self.rows = grown

    def _allocate_rows(self, ids: np.ndarray):
        """Allocate stored rows for (symbol, position) pairs appearing in
        this batch that aren't mapped yet."""
        from .. import native

        present = native.presence(ids, self.alphabet.count)
        if present is None:
            present = np.zeros(self.alphabet.count * self.length, dtype=bool)
            flat = ids.astype(np.int64) * self.length + np.arange(
                self.length, dtype=np.int64
            )
            present[flat.ravel()] = True
            present = present.reshape(self.alphabet.count, self.length)
        else:
            present = present.reshape(self.alphabet.count, self.length).astype(bool)
        new = present & (self.row_map == -1)
        if not new.any():
            return
        new_syms, new_positions = np.nonzero(new)
        n_new = len(new_syms)
        if not self.use_csr:
            self._ensure_capacity(self._n_stored + n_new)
        self.row_map[new_syms, new_positions] = self._n_stored + np.arange(
            n_new, dtype=np.int32
        )
        self.sym_ids.extend(new_syms.tolist())
        self.pos_ids.extend(new_positions.tolist())
        self._n_stored += n_new

    def _scatter(self, ids: np.ndarray, target: np.ndarray, row_offset: int):
        """Scatter one batch into `target` rows (native or numpy)."""
        from .. import native

        if native.pack_batch_compact(ids, target, self.row_map, row_offset):
            return
        batch = ids.shape[0]
        n_words = target.shape[1]
        row_idx = self.row_map[ids, np.arange(self.length, dtype=np.intp)]
        seq_ids = row_offset + np.arange(batch, dtype=np.int64)[:, None]
        words = seq_ids >> 5
        bits = (np.uint32(1) << (seq_ids & 31).astype(np.uint32))
        stored = row_idx >= 0
        flat = row_idx.astype(np.int64) * n_words + words
        np.bitwise_or.at(
            target.reshape(-1), flat[stored],
            np.broadcast_to(bits, flat.shape)[stored],
        )

    def add_batch(self, genomes: list[str | None]):
        """Add a batch of genomes (row-aligned with metadata order)."""
        batch = len(genomes)
        if batch == 0:
            return
        start = self._row
        # null rows are all-missing (see module docstring); the ids scratch
        # is reused across batches (a fresh 30 MB np.full per batch costs
        # ~1.3 ms of page faults)
        scratch = getattr(self, "_ids_scratch", None)
        if scratch is None or scratch.shape[0] < batch:
            scratch = self._ids_scratch = np.empty(
                (batch, self.length), dtype=np.uint8)
        ids = scratch[:batch]
        ids.fill(self.alphabet.missing_id)
        for i, genome in enumerate(genomes):
            if genome is None:
                continue
            if len(genome) != self.length:
                raise ValueError(
                    f"Sequence length {len(genome)} does not match reference "
                    f"length {self.length}"
                )
            raw = genome if isinstance(genome, bytes) else genome.encode("ascii")
            self.alphabet.ids_into(raw, ids[i])
        self._allocate_rows(ids)
        if self.use_csr:
            # scatter into a word-window scratch, then keep only the
            # non-zero words as a COO chunk
            word_lo = start >> 5
            span = bitset.words_for(start + batch) - word_lo
            scratch = np.zeros((self._n_stored, span), dtype=np.uint32)
            self._scatter(ids, scratch, start - (word_lo << 5))
            rnz, wnz = np.nonzero(scratch)
            self._coo.append((
                rnz.astype(np.int32),
                (wnz + word_lo).astype(np.int32),
                scratch[rnz, wnz],
            ))
        else:
            self._scatter(ids, self.rows, start)
        self._row += batch

    def finish(self) -> SegmentIndex:
        assert self._row == self.n_rows, (self._row, self.n_rows)
        ns = self._n_stored
        sym_ids = np.asarray(self.sym_ids, dtype=np.int32)
        pos_ids = np.asarray(self.pos_ids, dtype=np.int32)
        if self.use_csr:
            if self._coo:
                row_ids = np.concatenate([c[0] for c in self._coo])
                word_idx = np.concatenate([c[1] for c in self._coo])
                words = np.concatenate([c[2] for c in self._coo])
            else:
                row_ids = np.zeros(0, dtype=np.int32)
                word_idx = np.zeros(0, dtype=np.int32)
                words = np.zeros(0, dtype=np.uint32)
            self._coo.clear()
            store = CsrRowStore.from_coo(self.n_words, ns, row_ids, word_idx, words)
        else:
            store = DenseRowStore(self.rows[:ns])
        counts = store.popcounts()
        majority = self.reference_ids.copy()
        # Re-pick the true majority where a stored row beats the implicit
        # reference row (exact, per position).
        per_pos = np.zeros(self.length, dtype=np.int64)
        np.add.at(per_pos, pos_ids, counts)
        implicit = self.n_rows - per_pos  # [L]
        best = np.zeros(self.length, dtype=np.int64)
        np.maximum.at(best, pos_ids, counts)
        full = bitset.full_mask(self.n_rows)
        swaps = np.nonzero(best > implicit)[0]
        for pos in swaps:
            members = np.nonzero(pos_ids == pos)[0]
            winner = members[np.argmax(counts[members])]
            # old implicit (reference) row, computed before the swap
            ref_row = full & ~store.or_rows(members)
            majority[pos] = sym_ids[winner]
            store = store.replace_row(winner, ref_row)
            sym_ids[winner] = self.reference_ids[pos]
            counts[winner] = implicit[pos]
        # drop rows that became empty in the swap (implicit count was 0)
        keep = counts > 0
        order = np.nonzero(keep)[0][
            np.lexsort((sym_ids[keep], pos_ids[keep]))
        ]
        index = SegmentIndex(
            self.alphabet, self.reference_ids, self.n_rows, majority,
            sym_ids[order], pos_ids[order], store.reorder(order),
            counts=counts[order],
        )
        # release builder memory
        self.rows = np.zeros((0, 0), dtype=np.uint32)
        return index
