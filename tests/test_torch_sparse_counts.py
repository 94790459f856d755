"""K3, the sparse-tier Mutations reduction (``csrc/sparse_counts.cu``), and
its work list (``ops/reductions.py``: the stream's non-empty (row,
partition) segments in stream order, cut into the kernel's blocks and
clipped to entry chunks), against the per-(row, partition) bounds form it
replaced: the counts of an alphabet's rows are their counts over every
partition, since a partition whose filter words are all zero adds 0, and
the entries read are those of the alphabet's rows in the partitions the
filter reaches. Exact: every value is an integer. The kernel is held to its
plain version on the card (marked `cuda`); nothing here imports JAX, so
``python3 -m pytest --noconftest tests/test_torch_sparse_counts.py -m cuda``
runs on a machine without it. The plain version against the JAX package's
forms is in ``tests/test_torch_sparse.py``."""

import numpy as np
import pytest
import torch

from lapis_silo_torch.ops import kernels, reductions


def _t(array):
    return torch.from_numpy(np.ascontiguousarray(array).view(np.int32))


def _stream(rng, lens, part_words):
    """A partition-major stream for the segment lengths lens [L, P]:
    segment (row, p) holds sorted unique global word indices inside
    partition p's window. Returns (idx int32 [E], words uint32 [E], starts
    int64 [L, P])."""
    n_rows, n_parts = lens.shape
    counts = lens.T.reshape(-1)
    idx = np.concatenate([np.zeros(0, np.int64)] + [
        np.sort(rng.choice(part_words, size=n, replace=False))
        + p * part_words
        for p, n in zip(np.repeat(np.arange(n_parts), n_rows), counts) if n])
    words = rng.integers(1, 2**32, size=len(idx), dtype=np.uint32)
    starts = np.zeros(n_rows * n_parts, dtype=np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    return idx.astype(np.int32), words, starts.reshape(n_parts, n_rows).T


def _bounds_form(idx, words, filters, starts, lens):
    """The Mutations counts of every leaf over its [L, P] segments, by the
    definition: int64 [L]."""
    vals = np.bitwise_count(words & filters[idx]).astype(np.int64)
    prefix = np.concatenate([[0], np.cumsum(vals)])
    return (prefix[starts + lens] - prefix[starts]).sum(axis=1)


def _k3(idx, words, filters, segments, alphabet, row_bounds, part_words,
        per_block=kernels.SPARSE_SEGMENTS_PER_BLOCK, device="cpu"):
    """K3 (the plain version for CPU tensors) over one alphabet of a segment
    list, its grid cut into blocks of `per_block` segments: int32
    [n_rows + 1] on the CPU, the last the entries read."""
    blocks = reductions.segment_blocks(segments.offsets, alphabet, per_block)
    base, end = row_bounds[alphabet], row_bounds[alphabet + 1]
    args = [_t(a) for a in (idx, words, filters, segments.rows.astype(
        np.int32), segments.starts.astype(np.int32), blocks.astype(np.int32))]
    return kernels.sparse_counts(*(a.to(device) for a in args), part_words,
                                 base, end - base).cpu()


def _reached(filters, n_parts):
    return filters.reshape(n_parts, -1).any(axis=1)


def _filter_case(rng, case, n_parts, part_words):
    """A filter [P * part_words] that is random, zero in about half the
    partitions, set in one partition only, or zero everywhere."""
    filters = rng.integers(0, 2**32, size=(n_parts, part_words),
                           dtype=np.uint32)
    if case == "half":
        filters[rng.permutation(n_parts)[: n_parts // 2]] = 0
    elif case == "one":
        keep = rng.integers(n_parts)
        filters[np.arange(n_parts) != keep] = 0
        filters[keep, : part_words - 1] = 0  # its last word alone
    elif case == "none":
        filters[:] = 0
    return filters.reshape(-1)


@pytest.mark.parametrize("max_entries", [2, kernels.SPARSE_PIECE_ENTRIES])
@pytest.mark.parametrize("per_block", [1, 3, kernels.SPARSE_SEGMENTS_PER_BLOCK])
@pytest.mark.parametrize("case", ["random", "half", "one", "none"])
@pytest.mark.parametrize("n_chunks", [1, 2, 3, 4])
def test_plain_sparse_counts_equals_the_bounds_form(n_chunks, case,
                                                    per_block, max_entries):
    """The segment-list K3 against the [L, P] form it replaces, on random
    partition-major streams cut into three alphabets (one of them without
    rows), segments cut into pieces, the stream split into 1-4 entry
    chunks whose clipped segment lists are summed: each alphabet's counts
    are its rows' counts over all partitions, and the entries read are
    those of its rows in the partitions where the filter has a set bit."""
    rng = np.random.default_rng(n_chunks * 10 + len(case))
    n_leaves, n_parts, part_words = 50, 6, 96
    lens = rng.integers(0, 10, size=(n_leaves, n_parts))
    lens[:, 2] = 0
    lens[0, 0] = lens[49, 5] = 0
    idx, words, starts = _stream(rng, lens, part_words)
    filters = _filter_case(rng, case, n_parts, part_words)
    row_bounds = [0, 20, 20, n_leaves]
    segments = reductions.sparse_segments(starts, lens, row_bounds,
                                          max_entries)
    assert len(segments.rows) == int((-(-lens // max_entries)).sum())
    want = _bounds_form(idx, words, filters, starts, lens)
    reached = _reached(filters, n_parts)
    for alphabet in range(3):
        base, end = row_bounds[alphabet], row_bounds[alphabet + 1]
        got = sum(
            _k3(idx[lo:hi], words[lo:hi], filters,
                reductions.clip_segments(segments, lo, hi), alphabet,
                row_bounds, part_words, per_block).to(torch.int64)
            for lo, hi in reductions.entry_chunks(len(idx), n_chunks))
        assert got[:-1].tolist() == want[base:end].tolist()
        assert int(got[-1]) == int(lens[base:end, reached].sum())


def test_segment_list_and_blocks_follow_the_stream():
    """The segment list is the stream's non-empty segments in stream order,
    with the alphabet ranges per partition, and a segment longer than the
    pieces' size its pieces in order; the blocks cut each (partition,
    alphabet) range into runs of at most per_block; a stream whose segments
    leave a gap or come out of partition-major row order is refused."""
    rng = np.random.default_rng(12)
    lens = rng.integers(0, 6, size=(9, 3))
    lens[4, 1] = 0
    idx, words, starts = _stream(rng, lens, 64)
    segments = reductions.sparse_segments(starts, lens, [0, 4, 9], 5)
    flat_rows = np.tile(np.arange(9), 3)
    live = lens.T.reshape(-1) > 0
    assert segments.rows.tolist() == flat_rows[live].tolist()
    assert segments.starts[-1] == len(idx)
    np.testing.assert_array_equal(np.diff(segments.starts),
                                  lens.T.reshape(-1)[live])
    for p in range(3):
        for a, (lo, hi) in enumerate(((0, 4), (4, 9))):
            first, end = segments.offsets[p, a], segments.offsets[p, a + 1]
            assert (segments.rows[first:end] >= lo).all()
            assert (segments.rows[first:end] < hi).all()
            assert end - first == int((lens[lo:hi, p] > 0).sum())
    blocks = reductions.segment_blocks(segments.offsets, 1, 2)
    assert (blocks[:, 2] - blocks[:, 1] <= 2).all()
    assert (blocks[:, 2] > blocks[:, 1]).all()
    assert int((blocks[:, 2] - blocks[:, 1]).sum()) == int(
        (lens[4:] > 0).sum())
    pieces = reductions.sparse_segments(starts, lens, [0, 4, 9], 2)
    assert pieces.rows.tolist() == np.repeat(
        flat_rows[live], -(-lens.T.reshape(-1)[live] // 2)).tolist()
    assert (np.diff(pieces.starts) <= 2).all()
    assert set(pieces.starts.tolist()) >= set(segments.starts.tolist())
    assert (pieces.offsets[:, -1] - pieces.offsets[:, 0]).tolist() == (
        -(-lens // 2)).sum(axis=0).tolist()
    gap = starts.copy()
    gap[gap > 0] += 1
    with pytest.raises(ValueError):
        reductions.sparse_segments(gap, lens, [0, 4, 9], 5)
    with pytest.raises(ValueError):  # leaf-major, not partition-major
        reductions.sparse_segments(starts[::-1], lens[::-1], [0, 4, 9], 5)
    with pytest.raises(ValueError):
        reductions.sparse_segments(starts, lens, [0, 10], 5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "half", "one", "none"])
def test_sparse_counts_kernel_matches_plain_at_lineage_shapes(cuda_device,
                                                              case):
    """K3 against its plain version at the lineage cell's shapes: 29
    partitions of 1,000 words, two alphabets of rows whose segments hold
    about 4.5 entries, a partition without entries, filters that reach all,
    about half, one or none of the partitions; the entries-read slot
    included, and the stream split into 3 entry chunks."""
    rng = np.random.default_rng(29)
    n_parts, part_words, n_rows = 29, 1000, 6000
    lens = rng.poisson(1.5, size=(n_rows, n_parts)) * rng.integers(
        0, 2, size=(n_rows, n_parts))
    lens[:, 7] = 0
    idx, words, starts = _stream(rng, lens, part_words)
    filters = _filter_case(rng, case, n_parts, part_words)
    row_bounds = [0, 2400, n_rows]
    segments = kernels.sparse_segments(starts, lens, row_bounds)
    want = _bounds_form(idx, words, filters, starts, lens)
    reached = _reached(filters, n_parts)
    for alphabet in (0, 1):
        base, end = row_bounds[alphabet], row_bounds[alphabet + 1]
        got = _k3(idx, words, filters, segments, alphabet, row_bounds,
                  part_words, device=cuda_device)
        assert torch.equal(got, _k3(idx, words, filters, segments, alphabet,
                                    row_bounds, part_words))
        assert got[:-1].tolist() == want[base:end].tolist()
        assert int(got[-1]) == int(lens[base:end, reached].sum())
        chunked = [(*(t.to(cuda_device) for t in (
            _t(idx[lo:hi]), _t(words[lo:hi]))), *(
                _t(a.astype(np.int32)).to(cuda_device) for a in (
                    chunk.rows, chunk.starts,
                    kernels.sparse_blocks(chunk, alphabet))))
            for lo, hi in reductions.entry_chunks(len(idx), 3)
            for chunk in [reductions.clip_segments(segments, lo, hi)]]
        assert torch.equal(kernels.sparse_counts_chunked(
            chunked, [_t(filters).to(cuda_device)] * 3, part_words, base,
            end - base).cpu(), got)
