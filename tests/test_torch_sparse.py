"""The port's sparse-tier kernels against the JAX package's: the plain
versions of densify_rows, densify_rows_into_pool and sparse_counts (run by
the wrappers for CPU tensors) must equal the Mosaic kernels in interpret
mode and the XLA forms, exactly: every value is an integer or a word, so the
tolerance is equality. The reference takes the stream in its combined,
block-interleaved and padded layout; the port takes the same entries as two
flat arrays. The CUDA kernels are held to the plain versions on the card
(marked `cuda`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapis_silo_tpu.ops import pallas_kernels as pk
from lapis_silo_tpu.ops import reductions as ref_reductions
from lapis_silo_tpu.ops import vm as ref_vm
from lapis_silo_torch.ops import kernels, reductions
from tests.test_torch_sparse_counts import _bounds_form, _filter_case, _k3


def _stream(rng, n_leaves, n_parts, part_words, max_len, empty=()):
    """A partition-major stream like the engine's: segment (leaf, p) holds
    sorted unique global word indices inside partition p's window. Returns
    (idx int32 [E], words uint32 [E], starts, lens int32 [K, P])."""
    lens = rng.integers(0, max_len + 1, size=(n_leaves, n_parts))
    lens = np.minimum(lens, part_words)
    for leaf, part in empty:
        lens[leaf, part] = 0
    starts = np.zeros((n_leaves, n_parts), dtype=np.int64)
    idx, words = [], []
    pos = 0
    for part in range(n_parts):
        for leaf in range(n_leaves):
            n = int(lens[leaf, part])
            starts[leaf, part] = pos
            idx.append(np.sort(rng.choice(part_words, size=n, replace=False))
                       + part * part_words)
            words.append(rng.integers(1, 2**32, size=n, dtype=np.uint32))
            pos += n
    return (np.concatenate(idx).astype(np.int32), np.concatenate(words),
            starts.astype(np.int32), lens.astype(np.int32))


def _combined(idx, words, multiple):
    """The reference's combined stream, padded to a `multiple` of entries
    with zero words past the live ones."""
    n = -(-max(len(idx), 1) // multiple) * multiple
    pad_idx = np.zeros(n, np.int32)
    pad_words = np.zeros(n, np.uint32)
    pad_idx[: len(idx)] = idx
    pad_words[: len(words)] = words
    return jnp.asarray(pk.combine_stream(pad_idx, pad_words))


def _t(array):
    return torch.from_numpy(np.ascontiguousarray(array).view(np.int32))


def _densify_window_pad(n_entries):
    """The Mosaic densify kernel's over-read pad (DENSIFY_WINDOW)."""
    return -(-(n_entries + pk.DENSIFY_WINDOW) // pk.COMBINE_BLOCK) * pk.COMBINE_BLOCK


@pytest.mark.parametrize("n_leaves,n_parts,part_words", [
    (5, 3, 512), (1, 1, 256), (7, 2, 640)])
def test_plain_densify_matches_reference_forms(n_leaves, n_parts, part_words):
    """Plain K4 against the XLA densify (vm._densify_one) and the Mosaic
    kernel densify_rows in interpret mode, with empty segments."""
    rng = np.random.default_rng(n_leaves * 100 + n_parts)
    idx, words, starts, lens = _stream(rng, n_leaves, n_parts, part_words,
                                       300, empty=[(0, 0)])
    pw = n_parts * part_words
    got = kernels.densify_rows(_t(idx), _t(words), _t(starts), _t(lens), pw)
    assert got.dtype == torch.int32 and got.shape == (n_leaves, pw)
    got = got.numpy().view(np.uint32)
    comb = _combined(idx, words, pk.COMBINE_BLOCK)
    flat_starts, flat_lens = jnp.asarray(starts.reshape(-1)), jnp.asarray(
        lens.reshape(-1))
    xla = np.asarray(jax.jit(lambda *a: ref_vm._densify_one(
        n_leaves, 1 << 13, pw, n_parts, *a))(comb, flat_starts, flat_lens))
    np.testing.assert_array_equal(got, xla)
    mosaic = np.asarray(pk.densify_rows(
        _combined(idx, words, _densify_window_pad(len(idx))), flat_starts,
        flat_lens, n_leaves, pw, interpret=True))
    np.testing.assert_array_equal(got, mosaic)
    # and against the definition
    want = np.zeros((n_leaves, pw), np.uint32)
    for leaf in range(n_leaves):
        for part in range(n_parts):
            s, n = starts[leaf, part], lens[leaf, part]
            want[leaf, idx[s:s + n]] = words[s:s + n]
    np.testing.assert_array_equal(got, want)


def test_plain_densify_into_pool_matches_mosaic_interpreted():
    """Plain K5 against densify_rows_into_pool in interpret mode: the slot
    rows (the scratch row C among them) are replaced, every other row of a
    pool full of old words stays as it was."""
    rng = np.random.default_rng(5)
    n_leaves, n_parts, part_words, n_slots = 4, 2, 384, 9
    idx, words, starts, lens = _stream(rng, n_leaves, n_parts, part_words,
                                       200, empty=[(2, 1)])
    pw = n_parts * part_words
    pool = rng.integers(0, 2**32, size=(n_slots + 1, pw), dtype=np.uint32)
    slots = np.array([7, n_slots, 0, 3], np.int32)
    got = _t(pool.copy())
    kernels.densify_rows_into_pool(got, _t(idx), _t(words), _t(starts),
                                   _t(lens), slots.tolist())
    want = np.asarray(pk.densify_rows_into_pool(
        jnp.asarray(pool.reshape(n_slots + 1, pw // 128, 128)),
        _combined(idx, words, _densify_window_pad(len(idx))),
        jnp.asarray(starts.reshape(-1)), jnp.asarray(lens.reshape(-1)),
        jnp.asarray(slots), n_leaves, pw, interpret=True))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.reshape(n_slots + 1, pw))
    untouched = sorted(set(range(n_slots + 1)) - set(slots.tolist()))
    np.testing.assert_array_equal(got.numpy().view(np.uint32)[untouched],
                                  pool[untouched])


@pytest.mark.parametrize("case", ["random", "half", "one"])
def test_plain_sparse_counts_matches_reference_forms(monkeypatch, case):
    """Plain K3, over both alphabets of the rows, against
    _sparse_mutation_counts_jit (XLA gather) and
    _sparse_mutation_counts_pallas_jit, whose per-entry values come from the
    Mosaic kernel sparse_filter_popcount in interpret mode over a stream
    padded to SPARSE_CHUNK: the partitions K3 skips add nothing there."""
    monkeypatch.setenv("SILO_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(9)
    n_leaves, n_parts, part_words = 40, 4, 512
    idx, words, starts, lens = _stream(rng, n_leaves, n_parts, part_words,
                                       120, empty=[(3, 1), (39, 3)])
    filters = _filter_case(rng, case, n_parts, part_words)
    row_bounds = [0, 17, n_leaves]
    segments = kernels.sparse_segments(starts, lens, row_bounds)
    parts = [_k3(idx, words, filters, segments, a, row_bounds, part_words)
             for a in (0, 1)]
    for got, (lo, hi) in zip(parts, ((0, 17), (17, n_leaves))):
        assert got.dtype == torch.int32 and got.shape == (hi - lo + 1,)
    got = torch.cat([part[:-1] for part in parts])
    comb = _combined(idx, words, pk.SPARSE_CHUNK)
    args = (jnp.asarray(filters), jnp.asarray(starts.reshape(-1)),
            jnp.asarray(lens.reshape(-1)), n_parts)
    xla = np.asarray(ref_reductions._sparse_mutation_counts_jit(comb, *args))
    mosaic = np.asarray(ref_reductions._sparse_mutation_counts_pallas_jit(
        comb, *args))
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(got.numpy(), mosaic)
    assert got.tolist() == _bounds_form(idx, words, filters, starts,
                                        lens).tolist()


def test_boundary_sums_exact_where_the_reference_wraps():
    """Values near 2^31: the reference's uint32 cumsum wraps many times
    over and stays exact by modular differences; the port's int64 prefix
    sum gives the same segment sums without wrapping (ROADMAP Queue 3
    item 3)."""
    rng = np.random.default_rng(31)
    vals = rng.integers(2**31 - 4096, 2**31, size=4000, dtype=np.int64)
    lens = rng.integers(0, 3, size=1500)  # a segment sums to < 2^32
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    starts[-5:] = 4000 - 2  # overlapping tail segments
    lens[-5:] = [2, 1, 0, 2, 1]
    got = reductions.boundary_sums(torch.from_numpy(vals),
                                   torch.from_numpy(starts),
                                   torch.from_numpy(lens))
    want = np.asarray(ref_reductions._boundary_sums(
        jnp.asarray(vals.astype(np.uint32)), jnp.asarray(starts),
        jnp.asarray(lens)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(got.max()) > 2**32 - 2**14  # sums past int32 stay exact
    assert got.tolist() == [int(vals[s:s + n].sum())
                            for s, n in zip(starts, lens)]


def test_sparse_wrappers_count_plain_runs_and_check_inputs():
    rng = np.random.default_rng(2)
    idx, words, starts, lens = _stream(rng, 3, 2, 128, 20)
    args = (_t(idx), _t(words), _t(starts), _t(lens))
    pool = torch.zeros((5, 256), dtype=torch.int32)
    before = [(k.launches, k.plain_launches) for k in (
        kernels.SPARSE_COUNTS, kernels.DENSIFY_ROWS, kernels.DENSIFY_INTO_POOL)]
    segments = kernels.sparse_segments(starts, lens, [0, 3])
    work = [_t(a.astype(np.int32)) for a in (
        segments.rows, segments.starts,
        reductions.segment_blocks(segments.offsets, 0, 4))]
    kernels.sparse_counts(args[0], args[1], torch.zeros(256, dtype=torch.int32),
                          *work, 128, 0, 3)
    kernels.densify_rows(*args, 256)
    kernels.densify_rows_into_pool(pool, *args, [4, 0, 2])
    after = [(k.launches, k.plain_launches) for k in (
        kernels.SPARSE_COUNTS, kernels.DENSIFY_ROWS, kernels.DENSIFY_INTO_POOL)]
    assert after == [(n, p + 1) for n, p in before]
    for slots in ([0, 0, 1], [0, 1, 5], [-1, 0, 1], [0, 1]):
        with pytest.raises(ValueError):
            kernels.densify_rows_into_pool(pool, *args, slots)
    with pytest.raises(ValueError):
        kernels.densify_rows(args[0], args[1][:-1].clone(), *args[2:], 256)
    with pytest.raises(ValueError):
        kernels.densify_rows(*args[:3], args[3][:, :1].contiguous(), 256)
    filters = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError):  # starts without the end of the last
        kernels.sparse_counts(args[0], args[1], filters, work[0],
                              work[1][:-1].clone(), work[2], 128, 0, 3)
    with pytest.raises(ValueError):
        kernels.sparse_counts(args[0], args[1], filters, *work[:2],
                              work[2][:, :2].contiguous(), 128, 0, 3)
    with pytest.raises(ValueError):
        kernels.sparse_counts(args[0], args[1], filters, *work, 0, 0, 3)


def test_densify_into_pool_takes_slots_on_the_pool_device():
    """Slots already on the pool's device (an int32 tensor, as the engine
    passes them after its once-per-chunk check) give the pool the host-list
    call gives; host slots that are not ints raise."""
    rng = np.random.default_rng(4)
    idx, words, starts, lens = _stream(rng, 6, 3, 200, 60, empty=[(2, 1)])
    args = (_t(idx), _t(words), _t(starts), _t(lens))
    old = _t(rng.integers(0, 2**32, size=(9, 400), dtype=np.uint32))
    slots = [8, 0, 5, 2, 7, 3]
    want, got = old.clone(), old.clone()
    kernels.densify_rows_into_pool(want, *args, slots, 100)
    before = kernels.DENSIFY_INTO_POOL.plain_launches
    kernels.densify_rows_into_pool(got, *args, torch.tensor(
        slots, dtype=torch.int32), 100)
    assert kernels.DENSIFY_INTO_POOL.plain_launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got[[1, 4, 6]], old[[1, 4, 6]])
    with pytest.raises(ValueError):
        kernels.densify_rows_into_pool(got, *args, np.array(slots, float))
    with pytest.raises(ValueError):  # a device slot tensor of the wrong shape
        kernels.densify_rows_into_pool(got, *args, torch.tensor(
            slots[:-1], dtype=torch.int32))


def test_densify_inputs_are_one_block():
    """The per-launch inputs of a densify (bounds, and K5's slots) come from
    one int32 block: starts and lens [K, P] and the slots [K], contiguous
    views, equal to the host values."""
    rng = np.random.default_rng(6)
    bounds = rng.integers(0, 2**31 - 1, size=(2, 5, 3))
    slots = np.array([4, 0, 9, 2, 7], np.int32)
    starts, lens, dev_slots = kernels.densify_inputs(bounds, slots,
                                                     torch.device("cpu"))
    assert starts.untyped_storage().data_ptr() == \
        dev_slots.untyped_storage().data_ptr()
    for got, want in ((starts, bounds[0]), (lens, bounds[1]),
                      (dev_slots, slots)):
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    starts, lens = kernels.densify_inputs(bounds, None, torch.device("cpu"))
    np.testing.assert_array_equal(lens.numpy(), bounds[1])
    np.testing.assert_array_equal(kernels.check_slots(slots.tolist(), 5, 10),
                                  slots)


def test_plain_versions_skip_entries_outside_row_and_stream():
    """A bad stream cannot write outside the row or read past the stream:
    indices outside [0, pw) and segments past the stream's end are
    skipped by the plain versions, as by the kernels."""
    idx = torch.tensor([0, 5, 300, -1, 7], dtype=torch.int32)
    words = torch.tensor([1, 2, 4, 8, 16], dtype=torch.int32)
    starts = torch.tensor([[0], [3]], dtype=torch.int32)
    lens = torch.tensor([[3], [9]], dtype=torch.int32)
    rows = kernels.densify_rows(idx, words, starts, lens, 8)
    assert rows[0].tolist() == [1, 0, 0, 0, 0, 2, 0, 0]
    assert rows[1].tolist() == [0, 0, 0, 0, 0, 0, 0, 16]
    filters = torch.full((8,), -1, dtype=torch.int32)
    rows = torch.tensor([0, 1], dtype=torch.int32)
    seg_starts = torch.tensor([0, 3, 12], dtype=torch.int32)
    blocks = torch.tensor([[0, 0, 2]], dtype=torch.int32)
    # the second segment runs past the stream: 2 of its 9 entries are read
    assert kernels.sparse_counts(idx, words, filters, rows, seg_starts,
                                 blocks, 8, 0, 2).tolist() == [2, 1, 5]
    # a row outside the alphabet's range counts nowhere
    assert kernels.sparse_counts(idx, words, filters, rows, seg_starts,
                                 blocks, 8, 1, 1).tolist() == [1, 5]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_leaves,n_parts,part_words,max_len", [
    (1, 1, 131, 150), (33, 4, 2045, 150), (300, 8, 512, 150),
    # densify's tiles of 4,096 words: a PW that is a multiple of neither
    # the tile nor 4; segments longer than a tile; all of a leaf's entries
    # in one tile; a segment over three tiles (leaf 0's is empty)
    (5, 3, 2045, 2000), (7, 2, 10007, 9000), (40, 1, 4000, 3000),
    (2, 1, 13000, 12000)])
def test_sparse_kernels_match_plain_on_card(cuda_device, n_leaves, n_parts,
                                            part_words, max_len):
    """K3, K4 and K5 against their plain versions: K = 1, ragged PWs (not a
    multiple of 4 or 128), empty segments, pool slots that include the
    scratch row C, windows that start mid-partition and at an odd offset,
    and K5's slots as host ints and as a tensor on the card."""
    rng = np.random.default_rng(n_leaves)
    idx, words, starts, lens = _stream(rng, n_leaves, n_parts, part_words,
                                       max_len, empty=[(0, 0)])
    pw = n_parts * part_words
    cpu = [_t(a) for a in (idx, words, starts, lens)]
    dev = [a.to(cuda_device) for a in cpu]
    filters = rng.integers(0, 2**32, size=pw, dtype=np.uint32)
    row_bounds = [0, n_leaves // 2, n_leaves]
    segments = kernels.sparse_segments(starts, lens, row_bounds)
    for alphabet in (0, 1):
        assert torch.equal(
            _k3(idx, words, filters, segments, alphabet, row_bounds,
                part_words, device=cuda_device),
            _k3(idx, words, filters, segments, alphabet, row_bounds,
                part_words))
    filters = _t(filters)
    # the scratch row C = n_leaves + 2 first, then distinct others
    slots = np.concatenate([[n_leaves + 2],
                            rng.permutation(n_leaves + 2)[: n_leaves - 1]])
    for window, w_off in ((pw, 0), (pw // 3, part_words // 2),
                          (pw // 2 + 1, pw // 3 + 1)):
        assert torch.equal(kernels.densify_rows(*dev, window, w_off).cpu(),
                           kernels.densify_rows(*cpu, window, w_off))
        pool = _t(rng.integers(0, 2**32, size=(n_leaves + 3, window),
                               dtype=np.uint32))
        want = pool.clone()
        kernels.densify_rows_into_pool(want, *cpu, slots.tolist(), w_off)
        for card_slots in (slots.tolist(), torch.from_numpy(
                slots.astype(np.int32)).to(cuda_device)):
            pool_dev = pool.to(cuda_device)
            kernels.densify_rows_into_pool(pool_dev, *dev, card_slots, w_off)
            torch.cuda.synchronize()
            assert torch.equal(pool_dev.cpu(), want)
