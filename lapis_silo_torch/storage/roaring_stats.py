"""CRoaring-exact size model for /info parity.

The reference's observability surface reports *Roaring bitmap* byte sizes and
container statistics with exact values pinned by its e2e suite
(ref: endToEndTests/test/info.test.js — totalSize 26335659, nBitmapsSize 3898,
per-symbol portable sizes, container census). Our physical layout is packed
dense/CSR bitplanes, so we reproduce those numbers with a *model* of the
bitmaps the reference would have built:

- Final bitmap contents (ref: src/silo/storage/sequence_store.cpp,
  src/silo/storage/position.cpp): after `optimizeBitmaps()` every
  (position, symbol) bitmap holds the plain set of row ids whose genome has
  that symbol at that position, EXCEPT (a) the missing symbol N/X, whose
  per-position bitmap is always empty (fillIndexes skips SYMBOL_MISSING,
  sequence_store.cpp:119-124; missing rows live in per-sequence
  missing_symbol_bitmaps), and (b) the per-position max-cardinality symbol
  (first-in-enum-order on ties, only if count > 0), whose bitmap is replaced
  by an empty one (position.cpp deleteMostNumerousBitmap).
- Every bitmap is runOptimize()d (position.cpp getHighestCardinalitySymbol
  runs runOptimize + shrinkToFit over all 16/25 bitmaps), so container types
  are content-determined.

Size accounting mirrors CRoaring 1.0.0 (the reference's pinned dep,
conanfile.py):

- portable size (`roaring_bitmap_portable_size_in_bytes`, the spec at
  https://github.com/RoaringBitmap/RoaringFormatSpec): no-run header
  4 (cookie) + 4 (count) + 4n (descriptive) + 4n (offsets); has-run header
  4 + ceil(n/8) (run flags) + 4n + (4n offsets only when n >= 4); container
  data: array 2*card, bitset 8192, run 2 + 4*n_runs. Empty bitmap = 8.
- non-portable size (`roaring_bitmap_size_in_bytes`, used by
  Position::computeSize via getSizeInBytes(false)):
  1 + min(portable, 4 + 4*cardinality).
- frozen size (`roaring_bitmap_frozen_size_in_bytes`): 4 (header) +
  5n (keys/counts/typecodes) + data (array 2*card, bitset 8192, run
  4*n_runs — no run-count word in the frozen layout).
- statistics (`roaring_bitmap_statistics`): per-type container counts,
  stored-value counts, and bytes (array 2*card, run 2 + 4*n_runs,
  bitset 8192).
- runOptimize conversion rule (containers/convert.c convert_run_optimize):
  a container becomes a run container iff
  2 + 4*n_runs <= min(8192, 2*card); otherwise it is an array
  (card <= 4096) or bitset. (array_container_serialized_size_in_bytes =
  2*card — calibrated against the pinned container census: 2-value
  single-run containers stay arrays, 3-value single-run containers
  convert.)

All of these constants are cross-validated against the reference's pinned
e2e numbers by tests/test_info_parity.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BITSET_SER = 8192  # BITSET_CONTAINER_SIZE_IN_WORDS * 8
ARRAY_SER_EXTRA = 0  # array_container_serialized_size_in_bytes = 2*card
NO_OFFSET_THRESHOLD = 4


@dataclass
class BatchStats:
    """Per-bitmap size/census arrays for a batch of modeled bitmaps."""

    portable: np.ndarray
    nonportable: np.ndarray
    frozen: np.ndarray
    n_array: np.ndarray
    n_run: np.ndarray
    n_bitset: np.ndarray
    v_array: np.ndarray
    v_run: np.ndarray
    v_bitset: np.ndarray
    b_array: np.ndarray
    b_run: np.ndarray
    b_bitset: np.ndarray


def batch_stats(bitmap_ids: np.ndarray, values: np.ndarray, n_bitmaps: int) -> BatchStats:
    """Model a batch of bitmaps given as (bitmap_id, value) pairs sorted by
    (bitmap_id, value). Bitmaps with no pairs are empty bitmaps."""
    bitmap_ids = np.asarray(bitmap_ids, dtype=np.int64)
    values = np.asarray(values, dtype=np.int64)
    m = len(values)

    if m == 0:
        zero = np.zeros(n_bitmaps, dtype=np.int64)
        return BatchStats(
            portable=np.full(n_bitmaps, 8, dtype=np.int64),
            nonportable=np.full(n_bitmaps, 5, dtype=np.int64),
            frozen=np.full(n_bitmaps, 4, dtype=np.int64),
            n_array=zero, n_run=zero.copy(), n_bitset=zero.copy(),
            v_array=zero.copy(), v_run=zero.copy(), v_bitset=zero.copy(),
            b_array=zero.copy(), b_run=zero.copy(), b_bitset=zero.copy(),
        )

    # container = (bitmap, value >> 16) group; pairs arrive sorted
    ckey = bitmap_ids * 65536 + (values >> 16)
    new_c = np.empty(m, dtype=bool)
    new_c[0] = True
    np.not_equal(ckey[1:], ckey[:-1], out=new_c[1:])
    cidx = np.cumsum(new_c) - 1
    c_card = np.bincount(cidx).astype(np.int64)
    run_start = new_c.copy()
    run_start[1:] |= values[1:] != values[:-1] + 1
    c_runs = np.bincount(cidx, weights=run_start).astype(np.int64)
    c_bitmap = bitmap_ids[new_c]
    card_total = np.bincount(bitmap_ids, minlength=n_bitmaps).astype(np.int64)
    return _container_stats(c_bitmap, c_card, c_runs, card_total, n_bitmaps)


def batch_stats_words(bitmap_ids: np.ndarray, word_idx: np.ndarray,
                      words: np.ndarray, n_bitmaps: int) -> BatchStats:
    """batch_stats computed from PACKED u32 words — (bitmap, word_idx, word)
    entries word-sorted and CONTIGUOUS per bitmap (cross-bitmap order is
    free; each bitmap must appear as one run), zero words allowed (they
    contribute nothing). Per-container cardinality is a popcount groupby
    and run counts come from word-level run starts (popcount(w & ~(w<<1)))
    minus merges across ADJACENT words (prev bit 31 set, cur bit 0 set,
    same container) — no per-bit expansion, so the model stays O(nnz
    words) instead of O(set bits)."""
    bitmap_ids = np.asarray(bitmap_ids, dtype=np.int64)
    word_idx = np.asarray(word_idx, dtype=np.int64)
    words = np.ascontiguousarray(words, dtype=np.uint32)
    live = words != 0
    bitmap_ids, word_idx, words = (bitmap_ids[live], word_idx[live],
                                   words[live])
    m = len(words)
    if m == 0:
        return batch_stats(np.zeros(0, np.int64), np.zeros(0, np.int64),
                           n_bitmaps)
    pc = np.bitwise_count(words).astype(np.int64)
    # container = 2**16 values = 2048 words. The bitmap stride must cover
    # the largest container index WITHOUT wrapping int64 (a fixed 1 << 40
    # stride would silently merge containers of bitmaps 2**24 apart on
    # multi-Mbp segments — numpy multiply wraps, no error).
    container = word_idx >> 11
    stride = int(container.max()) + 1
    if int(bitmap_ids.max()) >= (1 << 62) // stride:
        raise OverflowError("size model key space exceeds int64")
    ckey = bitmap_ids * stride + container
    new_c = np.empty(m, dtype=bool)
    new_c[0] = True
    np.not_equal(ckey[1:], ckey[:-1], out=new_c[1:])
    cidx = np.cumsum(new_c) - 1
    c_card = np.bincount(cidx, weights=pc).astype(np.int64)
    # run starts inside each word; a bit0 run-start merges into the
    # previous word's run when that word is container-adjacent and ends
    # with bit 31 set
    word_runs = np.bitwise_count(words & ~(words << np.uint32(1))).astype(
        np.int64)
    adj = np.zeros(m, dtype=bool)
    adj[1:] = (~new_c[1:] & (word_idx[1:] == word_idx[:-1] + 1)
               & ((words[:-1] >> np.uint32(31)) & np.uint32(1)).astype(bool)
               & (words[1:] & np.uint32(1)).astype(bool))
    c_runs = (np.bincount(cidx, weights=word_runs).astype(np.int64)
              - np.bincount(cidx, weights=adj).astype(np.int64))
    c_bitmap = bitmap_ids[new_c]
    card_total = np.bincount(bitmap_ids, weights=pc,
                             minlength=n_bitmaps).astype(np.int64)
    return _container_stats(c_bitmap, c_card, c_runs, card_total, n_bitmaps)


def _container_stats(c_bitmap, c_card, c_runs, card_total,
                     n_bitmaps: int) -> BatchStats:
    def agg(container_bitmap, weights):
        out = np.zeros(n_bitmaps, dtype=np.int64)
        np.add.at(out, container_bitmap, weights)
        return out

    run_ser = 2 + 4 * c_runs
    arr_ser = 2 * c_card + ARRAY_SER_EXTRA
    t_run = run_ser <= np.minimum(BITSET_SER, arr_ser)
    t_bitset = ~t_run & (c_card > 4096)
    t_array = ~t_run & ~t_bitset

    # portable container data bytes: array 2c / run 2+4r / bitset 8192
    c_portable = np.where(t_run, 2 + 4 * c_runs,
                          np.where(t_bitset, BITSET_SER, 2 * c_card))
    c_frozen = np.where(t_run, 4 * c_runs,
                        np.where(t_bitset, BITSET_SER, 2 * c_card))

    n_array = agg(c_bitmap, t_array.astype(np.int64))
    n_run = agg(c_bitmap, t_run.astype(np.int64))
    n_bitset = agg(c_bitmap, t_bitset.astype(np.int64))
    n_cont = n_array + n_run + n_bitset
    data_bytes = agg(c_bitmap, c_portable)
    frozen_data = agg(c_bitmap, c_frozen)

    has_run = n_run > 0
    header = np.where(
        has_run,
        4 + (n_cont + 7) // 8 + 4 * n_cont
        + np.where(n_cont >= NO_OFFSET_THRESHOLD, 4 * n_cont, 0),
        8 + 8 * n_cont,
    )
    portable = np.where(n_cont == 0, 8, header + data_bytes)
    size_as_array = 4 * card_total + 4
    nonportable = np.minimum(portable, size_as_array) + 1
    frozen = 4 + 5 * n_cont + frozen_data

    return BatchStats(
        portable=portable, nonportable=nonportable, frozen=frozen,
        n_array=n_array, n_run=n_run, n_bitset=n_bitset,
        v_array=agg(c_bitmap, np.where(t_array, c_card, 0)),
        v_run=agg(c_bitmap, np.where(t_run, c_card, 0)),
        v_bitset=agg(c_bitmap, np.where(t_bitset, c_card, 0)),
        b_array=agg(c_bitmap, np.where(t_array, 2 * c_card, 0)),
        b_run=agg(c_bitmap, np.where(t_run, 2 + 4 * c_runs, 0)),
        b_bitset=agg(c_bitmap, np.where(t_bitset, BITSET_SER, 0)),
    )


def _add_stats(a: BatchStats, b: BatchStats) -> BatchStats:
    """Element-wise sum of two BatchStats over DISJOINT bitmap sets.
    Only valid when no bitmap has containers in both: per-bitmap header
    formulas are non-linear in container counts, but an empty bitmap's
    baseline (portable 8 / nonportable 5 / frozen 4) must not double: the
    sum keeps b's value wherever b saw containers, a's otherwise."""
    has_b = (b.n_array + b.n_run + b.n_bitset) > 0
    return BatchStats(
        portable=np.where(has_b, b.portable, a.portable),
        nonportable=np.where(has_b, b.nonportable, a.nonportable),
        frozen=np.where(has_b, b.frozen, a.frozen),
        n_array=a.n_array + b.n_array,
        n_run=a.n_run + b.n_run,
        n_bitset=a.n_bitset + b.n_bitset,
        v_array=a.v_array + b.v_array,
        v_run=a.v_run + b.v_run,
        v_bitset=a.v_bitset + b.v_bitset,
        b_array=a.b_array + b.b_array,
        b_run=a.b_run + b.b_run,
        b_bitset=a.b_bitset + b.b_bitset,
    )


def _decode_ids(words: np.ndarray) -> np.ndarray:
    """Packed u32 words -> sorted set-bit indices."""
    return np.flatnonzero(
        np.unpackbits(np.ascontiguousarray(words).view(np.uint8), bitorder="little")
    )


@dataclass
class SegmentStats:
    """Modeled Roaring stats for one (segment, partition)."""

    per_symbol_portable: np.ndarray  # int64[S]
    total_nonportable: int  # sum over all S*L position bitmaps
    portable_total: int
    frozen_total: int
    census: dict  # the 9 bitmapContainerSizeStatistic fields
    # n_bitset containers per (position) for GAP / missing / other symbols
    bitset_gap: np.ndarray  # int64[L]
    bitset_missing: np.ndarray
    bitset_other: np.ndarray
    missing_nonportable_total: int  # per-sequence missing bitmaps


_POS_CHUNK = 4096

# Snapshot persistence of the size model (storage/snapshot.py): the model is
# content-determined per immutable snapshot, so it is computed ONCE at save
# time and stored — the first live /info (35.7 s at 10M x 32, the watcher's
# pre-live warm-up) becomes a file read at serve time.
_CENSUS_KEYS = (
    "numberOfArrayContainers", "numberOfRunContainers",
    "numberOfBitsetContainers", "numberOfValuesStoredInArrayContainers",
    "numberOfValuesStoredInRunContainers",
    "numberOfValuesStoredInBitsetContainers",
    "totalBitmapSizeArrayContainers", "totalBitmapSizeRunContainers",
    "totalBitmapSizeBitsetContainers",
)


def stats_to_arrays(st: SegmentStats) -> dict:
    """SegmentStats -> flat {field: int64 array} for np.savez."""
    return {
        "per_symbol_portable": st.per_symbol_portable.astype(np.int64),
        "scalars": np.array(
            [st.total_nonportable, st.portable_total, st.frozen_total,
             st.missing_nonportable_total], dtype=np.int64),
        "census": np.array([st.census[k] for k in _CENSUS_KEYS],
                           dtype=np.int64),
        "bitset_gap": st.bitset_gap.astype(np.int64),
        "bitset_missing": st.bitset_missing.astype(np.int64),
        "bitset_other": st.bitset_other.astype(np.int64),
    }


def stats_from_arrays(arrays: dict) -> SegmentStats:
    scalars = arrays["scalars"]
    return SegmentStats(
        per_symbol_portable=np.asarray(arrays["per_symbol_portable"]),
        total_nonportable=int(scalars[0]),
        portable_total=int(scalars[1]),
        frozen_total=int(scalars[2]),
        census={k: int(v) for k, v in zip(_CENSUS_KEYS, arrays["census"])},
        bitset_gap=np.asarray(arrays["bitset_gap"]),
        bitset_missing=np.asarray(arrays["bitset_missing"]),
        bitset_other=np.asarray(arrays["bitset_other"]),
        missing_nonportable_total=int(scalars[3]),
    )


def segment_stats(seg) -> SegmentStats:
    """Model the reference's bitmaps for one SegmentIndex partition."""
    alphabet = seg.alphabet
    S, L = alphabet.count, seg.length
    missing_id = alphabet.missing_id

    # Reference per-position cardinalities: ours, minus the missing plane
    # (SYMBOL_MISSING ids never enter position bitmaps).
    ref_counts = seg.set_bits_matrix()
    ref_counts[missing_id] = 0
    # deleted = max-cardinality symbol, first-in-enum-order tie-break,
    # only when count > 0 (position.cpp getHighestCardinalitySymbol).
    deleted = np.argmax(ref_counts, axis=0).astype(np.int64)
    deleted[ref_counts[deleted, np.arange(L)] == 0] = -1

    majority = seg.majority.astype(np.int64)
    # Stored (non-missing, non-deleted) rows feed the WORD-level model —
    # O(nnz words), not O(set bits): unpacking every stored row to bits
    # measured 72 s at 65k x 30k and would be hours at 10M. Position
    # chunks own DISJOINT bitmaps (bitmap = sym*L + pos), so each chunk's
    # stats accumulate element-wise — peak memory is one chunk's entries,
    # not the whole stream (~15 GB of int64 ids at 10M). No sort anywhere:
    # batch_stats_words only needs each bitmap contiguous (one CSR run).
    stats = batch_stats_words(np.zeros(0, np.int64), np.zeros(0, np.int64),
                              np.zeros(0, np.uint32), S * L)
    miss_rows: list[np.ndarray] = []
    miss_pos: list[np.ndarray] = []

    for p0 in range(0, L, _POS_CHUNK):
        p1 = min(p0 + _POS_CHUNK, L)
        i0, i1 = int(seg.pos_offsets[p0]), int(seg.pos_offsets[p1])
        idx = np.arange(i0, i1)
        syms = seg.sym_ids[i0:i1].astype(np.int64)
        poss = seg.pos_ids[i0:i1].astype(np.int64)
        wl_bitmap: list[np.ndarray] = []
        wl_widx: list[np.ndarray] = []
        wl_words: list[np.ndarray] = []

        stored_is_missing = syms == missing_id
        keep = ~stored_is_missing & (syms != deleted[poss])
        if keep.any():
            widx, words, lengths = seg.store.gather_rows_csr(idx[keep])
            wl_bitmap.append(np.repeat(syms[keep] * L + poss[keep], lengths))
            wl_widx.append(widx.astype(np.int64))
            wl_words.append(words)
        if stored_is_missing.any():
            rows = seg.store.materialize(idx[stored_is_missing])
            flat = np.unpackbits(np.ascontiguousarray(rows).view(np.uint8),
                                 bitorder="little").reshape(len(rows), -1)
            r_idx, ids = np.nonzero(flat)
            miss_rows.append(ids)
            miss_pos.append(poss[stored_is_missing][r_idx])

        # implicit-majority rows (rare on the reference path: the reference
        # deletes exactly the majority unless ties/missing skew the pick)
        for p in range(p0, p1):
            maj = int(majority[p])
            if maj == int(deleted[p]):
                continue
            plane = seg.plane(maj, p)
            widx = np.flatnonzero(plane).astype(np.int64)
            if len(widx) == 0:
                continue
            if maj == missing_id:
                ids = _decode_ids(plane)
                miss_rows.append(ids)
                miss_pos.append(np.full(len(ids), p, dtype=np.int64))
            else:
                wl_bitmap.append(np.full(len(widx), maj * L + p,
                                         dtype=np.int64))
                wl_widx.append(widx)
                wl_words.append(plane[widx])

        if wl_bitmap:
            chunk = batch_stats_words(
                np.concatenate(wl_bitmap), np.concatenate(wl_widx),
                np.concatenate(wl_words), S * L)
            stats = _add_stats(stats, chunk)

    per_symbol_portable = stats.portable.reshape(S, L).sum(axis=1)
    n_bitset_sl = stats.n_bitset.reshape(S, L)
    other_mask = np.ones(S, dtype=bool)
    other_mask[missing_id] = False
    gap_id = alphabet.char_to_id.get("-")
    if gap_id is not None:
        other_mask[gap_id] = False
        bitset_gap = n_bitset_sl[gap_id].copy()
    else:
        bitset_gap = np.zeros(L, dtype=np.int64)
    census = {
        "numberOfArrayContainers": int(stats.n_array.sum()),
        "numberOfRunContainers": int(stats.n_run.sum()),
        "numberOfBitsetContainers": int(stats.n_bitset.sum()),
        "numberOfValuesStoredInArrayContainers": int(stats.v_array.sum()),
        "numberOfValuesStoredInRunContainers": int(stats.v_run.sum()),
        "numberOfValuesStoredInBitsetContainers": int(stats.v_bitset.sum()),
        "totalBitmapSizeArrayContainers": int(stats.b_array.sum()),
        "totalBitmapSizeRunContainers": int(stats.b_run.sum()),
        "totalBitmapSizeBitsetContainers": int(stats.b_bitset.sum()),
    }

    # per-sequence missing bitmaps (values = positions, one bitmap per row)
    if miss_rows:
        mr = np.concatenate(miss_rows)
        mp = np.concatenate(miss_pos)
        order = np.lexsort((mp, mr))
        mr, mp = mr[order], mp[order]
    else:
        mr = mp = np.zeros(0, dtype=np.int64)
    miss_stats = batch_stats(mr, mp, seg.n_rows)

    return SegmentStats(
        per_symbol_portable=per_symbol_portable,
        total_nonportable=int(stats.nonportable.sum()),
        portable_total=int(stats.portable.sum()),
        frozen_total=int(stats.frozen.sum()),
        census=census,
        bitset_gap=bitset_gap,
        bitset_missing=n_bitset_sl[missing_id].copy(),
        bitset_other=n_bitset_sl[other_mask].sum(axis=0),
        missing_nonportable_total=int(miss_stats.nonportable.sum()),
    )
