"""Plain reductions over device-resident words.

Counterparts of ``_popcount_words_jit``, ``_group_counts_jit``,
``_mutation_counts_jit`` and ``_sparse_mutation_counts_jit`` in
``lapis_silo_tpu/ops/reductions.py``, and of the fused nonzero-word
extraction of ``lapis_silo_tpu/ops/vm.py:505-514``. They are the plain
versions of the port's kernels: ``popcount_words`` and ``compact_nonzero``
of K11 and K10 (``csrc/compact.cu``), ``group_counts``,
``mutation_counts`` and ``sparse_counts`` of the group-by and Mutations
kernels (``csrc/group_counts.cu``, ``csrc/mutation_counts.cu``,
``csrc/sparse_counts.cu``): ``ops/kernels.py`` calls them for tensors on the
CPU, and the tests and ``chip_smoke.py`` hold the kernels against them.
``dense_pieces`` builds ``mutation_counts``' table of row pieces (each
partition's own words in a word window);
``sparse_segments``, ``segment_blocks``, ``entry_chunks`` and
``clip_segments`` build ``sparse_counts``' work list: the stream's non-empty
(row, partition) segments, cut into the kernel's blocks and split over word
shards by entries, as ``_sparse_mutation_counts_sharded_jit`` splits them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .words import popcount

# words per slice of the plain Mutations reduction: bounds its int64
# temporaries to a few hundred MB whatever the bank's size
_SLICE_WORDS = 1 << 24


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Total population count of a word tensor (0-d int64, on its device)."""
    return popcount(words).sum()


def compact_nonzero(words: torch.Tensor, cap: int, offset: int = 0
                    ) -> torch.Tensor:
    """The non-zero words of `words` [n] (a word shard whose first word is
    global word `offset`) as one int32 block [1 + 2 cap] on their device:
    the count of non-zero words, then the global indices of the first `cap`
    of them, ascending, then their words; slots past the count hold index
    `offset` and its word (the reference's fill value 0; word 0 for an
    empty shard). Fixed-size: a prefix sum of `words != 0` and a scatter."""
    device = words.device
    nonzero = words != 0
    rank = torch.cumsum(nonzero, 0) - 1  # rank among the non-zero words
    # a word's slot: its rank if among the first `cap`, else the trash
    # slot `cap`
    slot = torch.where(nonzero & (rank < cap), rank, cap)
    local = torch.zeros(cap + 1, dtype=torch.int64, device=device)
    local.scatter_(0, slot, torch.arange(words.shape[0], device=device))
    local = local[:cap]
    block = torch.empty(1 + 2 * cap, dtype=torch.int32, device=device)
    block[0] = nonzero.sum()
    block[1:1 + cap] = local + offset
    block[1 + cap:] = words[local] if words.shape[0] else 0
    return block


def group_counts(words: torch.Tensor, codes: torch.Tensor, w_off: int,
                 part_words: int, n_partitions: int,
                 n_groups: int) -> torch.Tensor:
    """counts[p, g] = the number of set bits b of words[w] (the window of
    global words [w_off, w_off + n), partition p owning the global words
    [p * part_words, (p + 1) * part_words)) with min(codes[w*32 + b],
    n_groups - 1) == g, for words [n] and codes [n * 32] of an integer
    type (the engine's uint8, int16 or int32); negative codes count
    nowhere. The per-bit segment sum of _group_counts_jit
    (lapis_silo_tpu/ops/reductions.py:23-40) over a window; every shift is
    masked (the words are u32 held as int32). int32 [P, n_groups]."""
    device = words.device
    n = words.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=device)
    bits = ((words.to(torch.int64)[:, None] >> shifts) & 1).reshape(-1)
    part = torch.div(w_off + torch.arange(n, device=device), part_words,
                     rounding_mode="floor").repeat_interleave(32)
    codes = codes.to(torch.int64)
    keep = (bits != 0) & (codes >= 0)
    segment = part * n_groups + codes.clamp(max=n_groups - 1)
    out = torch.zeros(n_partitions * n_groups, dtype=torch.int64,
                      device=device)
    out.index_add_(0, segment[keep], bits[keep])
    return out.view(n_partitions, n_groups).to(torch.int32)


def dense_pieces(part_words: int, own_words, w_lo: int, w_hi: int,
                 max_words: int) -> np.ndarray:
    """The pieces of the Mutations reduction's row (``mutation_counts``) in
    a word window [w_lo, w_hi) of the flat axis, partition p owning the
    words [p * part_words, (p + 1) * part_words) of which its genomes fill
    the first own_words[p]: each partition's own words clipped to the
    window, cut into pieces of at most `max_words`, in the window's
    coordinates. A partition that straddles two windows has pieces in
    both; one outside the window, or with no own words in it, has none.
    int64 [n, 2] of (lo, hi)."""
    out = []
    for p, own in enumerate(own_words):
        lo = max(p * part_words, w_lo)
        hi = min(p * part_words + min(int(own), part_words), w_hi)
        out.extend((a - w_lo, min(a + max_words, hi) - w_lo)
                   for a in range(lo, hi, max_words))
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)


def mutation_counts(bank: torch.Tensor, filters: torch.Tensor, start: int,
                    n_seg_rows: int, pieces, max_words: int) -> torch.Tensor:
    """counts[r] = sum, over the pieces (lo, hi) of `pieces` (int [n, 2],
    each clipped to [0, PW) and to `max_words` words from lo) where
    filters[lo:hi] has a set bit, of sum_w popcount(bank[start + r, w] &
    filters[w]) over w in [lo, hi); counts[n_seg_rows] = the sum of hi - lo
    over those pieces, the words of each row read. Over pieces that cover
    the flat word axis (partitions folded into words) this is the row's
    count against the whole filter; no rows read no words. int32
    [n_seg_rows + 1]."""
    pw = bank.shape[1]
    out = torch.zeros(n_seg_rows + 1, dtype=torch.int64, device=bank.device)
    if not n_seg_rows:
        return out.to(torch.int32)
    for lo, hi in torch.as_tensor(pieces).reshape(-1, 2).tolist():
        lo = min(max(lo, 0), pw)
        hi = min(max(hi, lo), pw, lo + max_words)
        part = filters[lo:hi]
        if not bool((part != 0).any()):
            continue
        out[n_seg_rows] += hi - lo
        step = max(1, _SLICE_WORDS // max(hi - lo, 1))
        for a in range(0, n_seg_rows, step):
            b = min(a + step, n_seg_rows)
            rows = bank[start + a:start + b, lo:hi]
            out[a:b] += popcount(rows & part[None, :]).sum(dim=1)
    return out.to(torch.int32)


def boundary_sums(vals: torch.Tensor, starts: torch.Tensor,
                  lens: torch.Tensor) -> torch.Tensor:
    """Sums of the contiguous segments [start, start + len) of `vals` (a
    flat per-entry stream), clipped to the stream: an exclusive int64 prefix
    sum and a gather at both boundaries (the reference's _boundary_sums,
    lapis_silo_tpu/ops/reductions.py:44-56). int64 is exact with no
    wraparound, where the reference relies on uint32 wrapping; empty and
    negative-length segments sum to 0. int64 [S]."""
    n = vals.shape[0]
    prefix = torch.zeros(n + 1, dtype=torch.int64, device=vals.device)
    torch.cumsum(vals.to(torch.int64), 0, out=prefix[1:])
    starts = starts.to(torch.int64)
    lo = starts.clamp(0, n)
    hi = (starts + lens.to(torch.int64)).clamp(0, n)
    return torch.where(hi > lo, prefix[hi] - prefix[lo], 0)


def sparse_counts(idx: torch.Tensor, words: torch.Tensor,
                  filters: torch.Tensor, rows: torch.Tensor,
                  starts: torch.Tensor, blocks: torch.Tensor,
                  part_words: int, row_base: int,
                  n_rows: int) -> torch.Tensor:
    """The sparse-tier Mutations reduction of one alphabet's rows over the
    CSR stream (idx, words [E] int32): for each block (partition p, first,
    end) of `blocks` [B, 3] whose partition the filter reaches (a set bit in
    filters[p * part_words : (p + 1) * part_words]), each listed segment s
    in [first, end) adds popcount(words[e] & filters[idx[e]]) over its
    entries [starts[s], starts[s + 1]) to out[rows[s] - row_base] (rows
    [S], starts [S + 1]; segments past S are none). Entries outside the
    stream or with a word index outside the filter count 0, rows outside
    [row_base, row_base + n_rows) nowhere. out[n_rows] is the
    number of entries in the reached blocks' segments: what the kernel
    reads. Partition by partition this is the sum of
    _sparse_mutation_counts_jit (lapis_silo_tpu/ops/reductions.py:59-78)
    over the alphabet's rows; a partition the filter leaves empty adds 0
    there too. int32 [n_rows + 1]: a row's count is at most the sequence
    count."""
    device = idx.device
    pw, n = filters.shape[0], idx.shape[0]
    out = torch.zeros(n_rows + 1, dtype=torch.int64, device=device)
    blocks = blocks.to(torch.int64).reshape(-1, 3)
    # the partitions with a set filter bit (the last may be ragged)
    n_parts = max(1, -(-pw // part_words))
    padded = torch.zeros(n_parts * part_words, dtype=filters.dtype,
                         device=device)
    padded[:pw] = filters
    reaches = (padded.view(n_parts, part_words) != 0).any(dim=1)
    part = blocks[:, 0]
    known = (part >= 0) & (part < n_parts)
    live = blocks[known & reaches[part.clamp(0, n_parts - 1)]]
    first = live[:, 1].clamp(0, rows.shape[0])
    counts = (live[:, 2].clamp(max=rows.shape[0]) - first).clamp(min=0)
    seg = (torch.repeat_interleave(first, counts)
           + torch.arange(int(counts.sum()), device=device)
           - torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts))
    if not seg.numel():
        return out.to(torch.int32)
    seg_starts = starts.to(torch.int64)
    lo = seg_starts[seg].clamp(0, n)
    hi = seg_starts[seg + 1].clamp(0, n)
    inside = (idx >= 0) & (idx < pw)
    gathered = filters[idx.clamp(0, max(pw - 1, 0)).to(torch.int64)]
    vals = popcount(words & gathered) * inside
    sums = boundary_sums(vals, lo, hi - lo)
    row = rows.to(torch.int64)[seg] - row_base
    mine = (row >= 0) & (row < n_rows)
    out.index_add_(0, row[mine], sums[mine])
    out[n_rows] = (hi - lo).clamp(min=0).sum()
    return out.to(torch.int32)


def _ranks(counts: np.ndarray) -> np.ndarray:
    """0, 1, ..., counts[i] - 1 for each i in turn: each element's rank in
    its group of np.repeat(..., counts)."""
    return np.arange(int(counts.sum())) - np.repeat(np.cumsum(counts)
                                                    - counts, counts)


class SparseSegments(NamedTuple):
    """The non-empty (row, partition) segments of a partition-major CSR
    stream, in stream order, each cut into pieces of at most a given number
    of entries: piece s is row rows[s]'s entries [starts[s], starts[s + 1])
    in one partition (starts has one entry more, the end of the last
    piece). Alphabet a's pieces in partition p are [offsets[p, a],
    offsets[p, a + 1]). int64 arrays."""

    rows: np.ndarray
    starts: np.ndarray
    offsets: np.ndarray


def sparse_segments(starts_pp: np.ndarray, lens_pp: np.ndarray, row_bounds,
                    max_entries: int) -> SparseSegments:
    """The segment list of a stream with per-(row, partition) bounds
    (starts_pp, lens_pp [L, P]) written partition-major, each partition's
    rows in id order, as the engine writes it: alphabet a owns the rows
    [row_bounds[a], row_bounds[a + 1]), ascending bounds from 0 to L; each
    segment cut into pieces of at most `max_entries`. ValueError where the
    non-empty segments do not follow one another in that order without a
    gap."""
    starts_pp = np.asarray(starts_pp, dtype=np.int64)
    lens_pp = np.asarray(lens_pp, dtype=np.int64)
    n_rows, n_parts = lens_pp.shape
    row_bounds = np.asarray(row_bounds, dtype=np.int64)
    if (row_bounds[0] != 0 or row_bounds[-1] != n_rows
            or (np.diff(row_bounds) < 0).any()):
        raise ValueError(f"row bounds {row_bounds.tolist()} do not cut "
                         f"[0, {n_rows})")
    part, rows = np.nonzero(lens_pp.T > 0)  # partition-major, rows ascending
    seg_starts = starts_pp[rows, part]
    ends = seg_starts + lens_pp[rows, part]
    if (seg_starts[1:] != ends[:-1]).any():
        raise ValueError("the stream's segments are not partition-major "
                         "in row order without gaps")
    n_pieces = -(-(ends - seg_starts) // max_entries)
    part, rows = np.repeat(part, n_pieces), np.repeat(rows, n_pieces)
    piece_starts = (np.repeat(seg_starts, n_pieces)
                    + _ranks(n_pieces) * max_entries)
    keys = part * n_rows + rows
    offsets = np.searchsorted(keys, (np.arange(n_parts)[:, None] * n_rows
                                     + row_bounds[None, :]))
    return SparseSegments(rows, np.append(piece_starts, ends[-1:] if len(ends)
                                          else [0]), offsets)


def segment_blocks(offsets: np.ndarray, alphabet: int,
                   per_block: int) -> np.ndarray:
    """The blocks of sparse_counts' grid for one alphabet: its segments in
    each partition (offsets [P, A + 1], SparseSegments.offsets) cut into
    runs of at most `per_block`, as (partition, first, end) rows. int64
    [B, 3]."""
    first = offsets[:, alphabet].astype(np.int64)
    count = offsets[:, alphabet + 1] - first
    n_blocks = -(-count // per_block)
    part = np.repeat(np.arange(len(first)), n_blocks)
    lo = first[part] + _ranks(n_blocks) * per_block
    hi = np.minimum(lo + per_block, first[part] + count[part])
    return np.stack([part, lo, hi], axis=1)


def entry_chunks(n_entries: int, n_chunks: int) -> list[tuple[int, int]]:
    """`n_chunks` contiguous entry ranges [lo, hi) covering [0, n_entries),
    as even as integers allow. The entry split of
    lapis_silo_tpu/ops/reductions.py:99-146 without its padding: the port's
    stream is unpadded and clip_segments handles any split."""
    edges = [n_entries * c // n_chunks for c in range(n_chunks + 1)]
    return list(zip(edges[:-1], edges[1:]))


def clip_segments(segments: SparseSegments, lo: int,
                  hi: int) -> SparseSegments:
    """The segments that hold entries of the entry chunk [lo, hi), in the
    chunk's own coordinates (reductions.py:134-137): a segment across the
    chunk's edge keeps the part inside it, and the offsets count from the
    chunk's first segment."""
    starts = segments.starts
    first = int(np.searchsorted(starts[1:], lo, "right"))
    last = max(first, int(np.searchsorted(starts[:-1], hi, "left")))
    return SparseSegments(
        segments.rows[first:last],
        np.clip(starts[first:last + 1] - lo, 0, hi - lo),
        np.clip(segments.offsets - first, 0, last - first))
