"""The port's Mutations reduction against the JAX package's: the plain
version (lapis_silo_torch/ops/reductions.py, run by the kernel wrapper for CPU
tensors) must equal the Mosaic kernel mutation_counts_banked in interpret
mode and the XLA form _mutation_counts_jit, exactly (integer counts). The
CUDA kernel is held to the plain version on the card (marked `cuda`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapis_silo_tpu.ops import pallas_kernels as pk
from lapis_silo_tpu.ops import reductions as ref_reductions
from lapis_silo_torch.ops import kernels


def _random(rng, n_rows, pw):
    bank = rng.integers(0, 2**32, size=(n_rows, pw), dtype=np.uint32)
    filters = rng.integers(0, 2**32, size=pw, dtype=np.uint32)
    return bank, filters


def _t(array):
    return torch.from_numpy(np.ascontiguousarray(array).view(np.int32))


def _plain(bank, filters, start, n):
    """The counts of rows [start, start + n) over the whole row; the words
    read slot after them is checked here: every word of a row, where the
    filter has a set bit and there are rows."""
    counts = kernels.mutation_counts(torch.from_numpy(bank.view(np.int32)),
                                     torch.from_numpy(filters.view(np.int32)),
                                     start, n)
    assert counts.dtype == torch.int32 and counts.shape == (n + 1,)
    assert int(counts[n]) == (bank.shape[1] if n and filters.any() else 0)
    return counts.numpy()[:n]


def test_plain_mutation_counts_matches_mosaic_kernel_interpreted():
    """Row-block-aligned start and a multi-block word axis: the shapes the
    TPU kernel takes."""
    rng = np.random.default_rng(1)
    row_block = 8
    bank, filters = _random(rng, 4 * row_block, 3 * 256)
    start, n_seg = row_block, 2 * row_block
    want = np.asarray(pk.mutation_counts_banked(
        bank, filters, start, n_seg, bank.shape[1], row_block, 256, False,
        True))
    np.testing.assert_array_equal(_plain(bank, filters, start, n_seg), want)


@pytest.mark.parametrize("pw,start,n", [(2048, 3, 21), (77, 0, 40), (5, 39, 1),
                                        (300, 7, 0)])
def test_plain_mutation_counts_matches_xla(pw, start, n):
    """Any start, ragged word counts, a one-row and an empty segment."""
    rng = np.random.default_rng(pw + start)
    bank, filters = _random(rng, 40, pw)
    want = np.asarray(ref_reductions._mutation_counts_jit(
        jnp.asarray(bank), jnp.asarray(filters), start, n))
    got = _plain(bank, filters, start, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.bitwise_count(bank[start:start + n] & filters).sum(axis=1))


def test_mutation_counts_wrapper_counts_plain_runs_and_checks_rows():
    rng = np.random.default_rng(3)
    bank, filters = _random(rng, 6, 64)
    before = (kernels.MUTATION_COUNTS.launches,
              kernels.MUTATION_COUNTS.plain_launches)
    _plain(bank, filters, 2, 4)
    assert (kernels.MUTATION_COUNTS.launches,
            kernels.MUTATION_COUNTS.plain_launches) == (before[0], before[1] + 1)
    with pytest.raises(ValueError):
        _plain(bank, filters, 3, 4)
    with pytest.raises(ValueError):
        _plain(bank, filters[:-1].copy(), 0, 1)


def test_plain_popcount_rows_and_filter_matches_mosaic_interpreted():
    """popcount_rows_and_filter (K2 over every row) against the Mosaic
    kernel in interpret mode at its padded block shapes, as
    tests/test_pallas_kernels.py calls it, and on a ragged block the port
    takes unpadded."""
    rng = np.random.default_rng(0)
    rows, filt = _random(rng, 2 * pk.ROW_BLOCK, pk.WORD_BLOCK)
    want = np.asarray(pk.popcount_rows_and_filter(rows, filt, True))
    before = kernels.POPCOUNT_ROWS.plain_launches
    got = kernels.popcount_rows_and_filter(_t(rows), _t(filt))
    assert kernels.POPCOUNT_ROWS.plain_launches == before + 1
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(
        kernels.popcount_rows_and_filter_plain(_t(rows), _t(filt)), got)
    ragged, ragged_filt = rows[:37, :300], filt[:300]
    np.testing.assert_array_equal(
        kernels.popcount_rows_and_filter(_t(ragged), _t(ragged_filt)).numpy(),
        np.bitwise_count(ragged & ragged_filt).sum(axis=1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pw,start", [(2048, 3), (77, 1)])
def test_mutation_counts_kernel_matches_plain_on_card(cuda_device, pw, start):
    rng = np.random.default_rng(pw)
    bank, filters = _random(rng, 300, pw)
    b = torch.from_numpy(bank.view(np.int32))
    f = torch.from_numpy(filters.view(np.int32))
    want = kernels.mutation_counts(b, f, start, 290)
    got = kernels.mutation_counts(b.to(cuda_device), f.to(cuda_device), start,
                                  290)
    assert torch.equal(got.cpu(), want) and int(want[290]) == pw


@pytest.mark.cuda
def test_popcount_rows_and_filter_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(4)
    rows, filt = _random(rng, 301, 2045)
    want = kernels.popcount_rows_and_filter_plain(_t(rows), _t(filt))
    got = kernels.popcount_rows_and_filter(_t(rows).to(cuda_device),
                                           _t(filt).to(cuda_device))
    assert torch.equal(got.cpu(), want)
