"""K2, the dense-bank Mutations reduction (``csrc/mutation_counts.cu``), and
its table of row pieces (``ops/reductions.py`` ``dense_pieces``: each
partition's own words in a shard's word window): the table covers every
partition's own words once over the shards, and the reduction over it
equals the JAX package's ``mutation_counts_banked`` over the whole flat
row, since the filter is zero in the padding and a partition whose filter
words are all zero adds 0; the words read are those of the pieces the
filter reaches. Exact: every value is an integer. The kernel is held to its
plain version on the card (marked `cuda`); JAX is imported only by the
test that needs it, so ``python3 -m pytest --noconftest
tests/test_torch_dense_counts.py -m cuda`` runs on a machine without it."""

import numpy as np
import pytest
import torch

from lapis_silo_torch.ops import kernels, reductions


def _t(array):
    return torch.from_numpy(np.ascontiguousarray(array).view(np.int32))


def _split(array, n):
    return [_t(part) for part in np.split(array, n, axis=-1)]


def _tables(part_words, own, n_shards, max_words=kernels.K2_PIECE_WORDS):
    local = len(own) * part_words // n_shards
    return [reductions.dense_pieces(part_words, own, d * local,
                                    (d + 1) * local, max_words)
            for d in range(n_shards)]


def _own_mask(part_words, own):
    """Which words of the flat row are some partition's own."""
    mask = np.zeros((len(own), part_words), dtype=bool)
    for p, n in enumerate(own):
        mask[p, :n] = True
    return mask.reshape(-1)


def _filter(rng, case, part_words, own):
    """A filter [P * part_words], zero in the padding as the VM leaves it:
    random own words, zero in every other partition, set in one word of
    one partition only, or zero everywhere."""
    n_parts = len(own)
    filt = rng.integers(0, 2**32, size=(n_parts, part_words),
                        dtype=np.uint32)
    if case == "some":
        filt[::2] = 0
    elif case == "one":
        keep = n_parts - 1
        filt[np.arange(n_parts) != keep] = 0
        filt[keep, : own[keep] - 1] = 0
    elif case == "none":
        filt[:] = 0
    filt = filt.reshape(-1)
    filt[~_own_mask(part_words, own)] = 0
    return filt


def _words_read(filt, tables, part_words, own, n_shards):
    """The words of a row the reduction reads: those of the pieces where
    the filter has a set bit, counted with numpy."""
    local = len(own) * part_words // n_shards
    return sum(hi - lo for d, table in enumerate(tables) for lo, hi in table
               if filt[d * local + lo:d * local + hi].any())


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("max_words", [3, 64, kernels.K2_PIECE_WORDS])
def test_the_pieces_cover_each_partitions_own_words_once(n_shards,
                                                         max_words):
    """Uneven partitions (one full, one short, one of a single word, one
    empty) over 1, 2 and 4 word shards, whose windows cut partitions: the
    pieces, in global words, cover every own word once and no padding,
    each inside one partition and one window and at most max_words long."""
    part_words, own = 64, [64, 23, 1, 0, 40, 64, 7, 50]
    local = len(own) * part_words // n_shards
    tables = _tables(part_words, own, n_shards, max_words)
    covered = np.zeros(len(own) * part_words, dtype=np.int64)
    for d, table in enumerate(tables):
        assert table.dtype == np.int64 and table.shape[1] == 2
        for lo, hi in table:
            assert 0 <= lo < hi <= local and hi - lo <= max_words
            g_lo, g_hi = d * local + lo, d * local + hi
            assert g_lo // part_words == (g_hi - 1) // part_words
            covered[g_lo:g_hi] += 1
    np.testing.assert_array_equal(covered, _own_mask(part_words, own))


def test_a_partition_across_a_window_edge_has_pieces_on_both_shards():
    """Partitions of 12 words owning 12, 5 and 9 of them over 4 windows of
    9: partition 0 runs into the second window, partition 2 across the
    third and fourth, partition 1 lies inside the second; the padding of
    partitions 1 and 2 has no piece."""
    tables = _tables(12, [12, 5, 9], 4)
    assert [table.tolist() for table in tables] == [
        [[0, 9]], [[0, 3], [3, 8]], [[6, 9]], [[0, 6]]]
    assert kernels.dense_pieces(12, [12, 5, 9], 0, 36).tolist() == [
        [0, 12], [12, 17], [24, 33]]
    assert kernels.dense_pieces(12, [12, 5, 9], 0, 36).dtype == np.int32


@pytest.mark.parametrize("case", ["all", "some", "one", "none"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_plain_dense_counts_over_the_pieces_equal_the_jax_reference(
        n_shards, case):
    """The plain reduction over each shard's pieces, summed over the
    shards, against the Mosaic kernel mutation_counts_banked in interpret
    mode over the whole flat row: uneven partitions, a filter that reaches
    every partition, some, one word of one, or none, and a row-block
    aligned start as the TPU kernel takes. The words read are the reached
    pieces' words."""
    from lapis_silo_tpu.ops import pallas_kernels as pk

    rng = np.random.default_rng(n_shards * 10 + len(case))
    part_words, own = 256, [256, 101, 37]
    pw = len(own) * part_words
    row_block = pk.ROW_BLOCK
    bank = rng.integers(0, 2**32, size=(4 * row_block, pw), dtype=np.uint32)
    filt = _filter(rng, case, part_words, own)
    start, n_seg = row_block, 2 * row_block
    want = np.asarray(pk.mutation_counts_banked(
        bank, filt, start, n_seg, pw, row_block, 256, False, True))
    tables = _tables(part_words, own, n_shards)
    got = kernels.mutation_counts_sharded(
        _split(bank, n_shards), _split(filt, n_shards), start, n_seg,
        [_t(table.astype(np.int32)) for table in tables])
    assert got.dtype == torch.int32 and got.shape == (n_seg + 1,)
    np.testing.assert_array_equal(got.numpy()[:n_seg], want)
    assert int(got[n_seg]) == _words_read(filt, tables, part_words, own,
                                          n_shards)


def test_plain_dense_counts_leave_out_words_outside_every_piece():
    """Words outside the pieces count nothing, even where the filter has
    bits there; a piece past the row or longer than the kernel's widest
    is clipped as the kernel clips it; no rows read no words."""
    rng = np.random.default_rng(5)
    pw = 3000
    bank = rng.integers(0, 2**32, size=(5, pw), dtype=np.uint32)
    filt = rng.integers(0, 2**32, size=pw, dtype=np.uint32)
    pieces = np.array([[10, 20], [100, 100 + kernels.K2_PIECE_WORDS + 50],
                       [2990, 4000]], dtype=np.int32)
    got = kernels.mutation_counts(_t(bank), _t(filt), 1, 4, _t(pieces))
    kept = np.zeros(pw, dtype=bool)
    kept[10:20] = kept[100:100 + kernels.K2_PIECE_WORDS] = kept[2990:] = True
    want = np.bitwise_count(bank[1:5] & np.where(kept, filt, 0)).sum(axis=1)
    np.testing.assert_array_equal(got.numpy()[:4], want)
    assert int(got[4]) == int(kept.sum())
    empty = kernels.mutation_counts(_t(bank), _t(filt), 2, 0, _t(pieces))
    assert empty.tolist() == [0]


def test_the_engine_holds_each_shards_table_on_its_device():
    """DeviceEngine builds its shards' tables once from the partitions'
    sequence counts and its word windows."""
    from lapis_silo_torch.ops import bitset
    from lapis_silo_torch.ops.device_engine import DeviceEngine
    from lapis_silo_torch.testing import synthetic_database

    db = synthetic_database(3000, 200, n_partitions=3, seed=4)
    cpu = torch.device("cpu")
    engine = DeviceEngine(db, cpu, devices=[cpu] * 4)
    own = [bitset.words_for(n) for n in engine.part_rows]
    assert len(engine._dense_pieces) == 4
    for table, lo in zip(engine._dense_pieces, engine.shards.offsets):
        assert table.dtype == torch.int32 and table.device == cpu
        np.testing.assert_array_equal(table.numpy(), kernels.dense_pieces(
            engine.n_words, own, lo, lo + engine.shards.local_words))


# -- on the card ---------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _misaligned(array, device):
    """`array` on `device` as a view whose first word is one word past a
    16-byte boundary."""
    flat = torch.zeros(array.size + 1, dtype=torch.int32, device=device)
    view = flat[1:].view(array.shape)
    view.copy_(_t(array).to(device))
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all", "some", "one", "none"])
@pytest.mark.parametrize("part_words,own", [
    (1000, [1000, 513, 777, 1, 998]),      # lineage1m's width, 16-byte rows
    (257, [257, 100, 3]),                  # pw % 4 != 0: 4-byte loads
    (4099, [4099, 2050, 4000]),            # pieces cut at the widest
])
@pytest.mark.parametrize("start,n_rows", [(0, 1), (3, 17), (5, 300)])
def test_dense_counts_kernel_matches_plain_on_card(cuda_device, case,
                                                   part_words, own, start,
                                                   n_rows):
    """K2 over the pieces against its plain version on random banks, with
    the words-read slot equal to its count by numpy."""
    rng = np.random.default_rng(part_words + start + len(case))
    pw = len(own) * part_words
    bank = rng.integers(0, 2**32, size=(start + n_rows + 2, pw),
                        dtype=np.uint32)
    filt = _filter(rng, case, part_words, own)
    (table,) = _tables(part_words, own, 1)
    pieces = _t(table.astype(np.int32))
    want = kernels.mutation_counts(_t(bank), _t(filt), start, n_rows, pieces)
    got = kernels.mutation_counts(_t(bank).to(cuda_device),
                                  _t(filt).to(cuda_device), start, n_rows,
                                  pieces.to(cuda_device))
    assert torch.equal(got.cpu(), want)
    assert int(want[n_rows]) == _words_read(filt, [table], part_words, own, 1)
    if case == "none":
        assert not want.any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_dense_counts_kernel_off_16_byte_rows_and_on_shards(cuda_device,
                                                            n_shards):
    """A bank and filter that start one word past a 16-byte boundary take
    the 4-byte loads; the shards' tables split partitions across their
    windows; K8 reads whole rows."""
    rng = np.random.default_rng(n_shards)
    part_words, own = 1000, [1000, 513, 640, 998]
    pw = len(own) * part_words
    bank = rng.integers(0, 2**32, size=(150, pw), dtype=np.uint32)
    filt = _filter(rng, "some", part_words, own)
    (table,) = _tables(part_words, own, 1)
    pieces = _t(table.astype(np.int32))
    want = kernels.mutation_counts(_t(bank), _t(filt), 1, 149, pieces)
    got = kernels.mutation_counts(
        _misaligned(bank, cuda_device), _misaligned(filt, cuda_device), 1,
        149, pieces.to(cuda_device))
    assert torch.equal(got.cpu(), want)
    tables = [_t(t.astype(np.int32)) for t in _tables(part_words, own,
                                                      n_shards)]
    banks, filters = _split(bank, n_shards), _split(filt, n_shards)
    plain = kernels.mutation_counts_sharded(banks, filters, 1, 149, tables)
    card = kernels.mutation_counts_sharded(
        [b.to(cuda_device) for b in banks],
        [f.to(cuda_device) for f in filters], 1, 149,
        [t.to(cuda_device) for t in tables])
    assert torch.equal(card.cpu(), plain)
    assert torch.equal(plain[:149], want[:149])
    rows, row_filt = bank[:37, :2045], filt[:2045]
    assert torch.equal(
        kernels.popcount_rows_and_filter(_t(rows).to(cuda_device),
                                         _t(row_filt).to(cuda_device)).cpu(),
        kernels.popcount_rows_and_filter_plain(_t(rows), _t(row_filt)))
