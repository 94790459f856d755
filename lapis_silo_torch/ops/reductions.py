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
``entry_chunks`` and ``clip_bounds`` split the sparse-tier stream's entries
over word shards, as ``_sparse_mutation_counts_sharded_jit`` does.
"""

from __future__ import annotations

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


def mutation_counts(bank: torch.Tensor, filters: torch.Tensor, start: int,
                    n_seg_rows: int) -> torch.Tensor:
    """counts[r] = sum_w popcount(bank[start + r, w] & filters[w]) over the
    flat global word axis (partitions folded into words): int32[n_seg_rows]."""
    step = max(1, _SLICE_WORDS // max(bank.shape[1], 1))
    out = torch.empty(n_seg_rows, dtype=torch.int32, device=bank.device)
    for lo in range(0, n_seg_rows, step):
        hi = min(lo + step, n_seg_rows)
        rows = bank[start + lo : start + hi]
        out[lo:hi] = popcount(rows & filters[None, :]).sum(dim=1).to(torch.int32)
    return out


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
                  filters: torch.Tensor, starts: torch.Tensor,
                  lens: torch.Tensor) -> torch.Tensor:
    """counts[l] = sum over leaf l's segments (starts/lens [L, P], one per
    partition) of popcount(words[e] & filters[idx[e]]): the sparse-tier
    Mutations reduction over the CSR stream (idx, words [E] int32), as
    _sparse_mutation_counts_jit (lapis_silo_tpu/ops/reductions.py:59-78)
    computes it. Entries whose word index lies outside the filter count 0.
    int32 [L]: a leaf's count is at most the sequence count."""
    pw = filters.shape[0]
    inside = (idx >= 0) & (idx < pw)
    gathered = filters[idx.clamp(0, max(pw - 1, 0)).to(torch.int64)]
    vals = popcount(words & gathered) * inside
    per_segment = boundary_sums(vals, starts.reshape(-1), lens.reshape(-1))
    return per_segment.reshape(starts.shape).sum(dim=1).to(torch.int32)


def entry_chunks(n_entries: int, n_chunks: int) -> list[tuple[int, int]]:
    """`n_chunks` contiguous entry ranges [lo, hi) covering [0, n_entries),
    as even as integers allow. The entry split of
    lapis_silo_tpu/ops/reductions.py:99-146 without its padding: the port's
    stream is unpadded and clip_bounds handles any split."""
    edges = [n_entries * c // n_chunks for c in range(n_chunks + 1)]
    return list(zip(edges[:-1], edges[1:]))


def clip_bounds(starts: np.ndarray, lens: np.ndarray, lo: int,
                hi: int) -> tuple[np.ndarray, np.ndarray]:
    """Stream segments (start, len) clipped to the entry chunk [lo, hi), in
    the chunk's own coordinates (reductions.py:134-137): the part of each
    segment inside the chunk, empty where there is none. int64 arrays of
    the bounds' shape."""
    starts = np.asarray(starts, dtype=np.int64)
    ends = starts + np.asarray(lens, dtype=np.int64)
    local_lo = np.clip(starts - lo, 0, hi - lo)
    local_hi = np.clip(ends - lo, 0, hi - lo)
    return local_lo, np.maximum(local_hi - local_lo, 0)
