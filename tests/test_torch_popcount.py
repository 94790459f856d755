"""The port's word popcount (K11's wrapper, ``kernels.popcount_words_sharded``)
against the JAX package's ``_popcount_words_jit``.

Seeded numpy words, with 0, 0xFFFFFFFF and words with bit 31 set among them,
go whole through ``_popcount_words_jit`` on JAX's CPU and, split into uneven
shards (an empty one and views that start inside a 16-byte quad included),
through the port's wrapper on torch's CPU, where its plain version runs: the
totals must be equal. The routes that count a filter (``count_async``,
``DeviceFilter.popcount``, ``ShardedQueryStep``) take the total from the VM
launch that writes it (``kernels.vm_filter_sharded``), not from the
wrapper. Every value is an integer: the
tolerance is equality. The kernel against its plain version on the card is
marked `cuda`."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapis_silo_tpu.ops.reductions import _popcount_words_jit
from lapis_silo_torch.ops import kernels
from lapis_silo_torch.ops.device_engine import DeviceEngine
from lapis_silo_torch.parallel.mesh import ShardedQueryStep
from lapis_silo_torch.query.engine import Query
from lapis_silo_torch.testing import synthetic_database

CPU = torch.device("cpu")
TILE = 4 * kernels.COMPACT_TILE_QUADS  # words of a K11 CTA
# shard widths: one shard, uneven ones with an empty shard, ones that cross
# a CTA's words
SPLITS = [[1000], [3, 0, 250, 17, 1], [TILE - 1, TILE + 2, 5],
          [1, 2 * TILE + 3]]


def _words(rng, n):
    """n seeded uint32 words: random ones, zeros, all-ones and bit 31."""
    words = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    words[rng.random(n) < 0.3] = 0
    words[rng.random(n) < 0.1] = 0xFFFFFFFF
    words[rng.random(n) < 0.1] = 0x80000000
    return words


def _shards(words, widths, head, devices=None):
    """Views of `words` split at `widths`, each `head` words into its own
    storage (on devices[d], the CPU by default)."""
    parts, lo = [], 0
    for d, n in enumerate(widths):
        storage = np.zeros(n + head, dtype=np.uint32)
        storage[head:] = words[lo:lo + n]
        storage = torch.from_numpy(storage.view(np.int32))
        if devices is not None:
            storage = storage.to(devices[d])
        parts.append(storage[head:])
        lo += n
    return parts


@pytest.mark.parametrize("head", [0, 1, 3])
@pytest.mark.parametrize("split", range(len(SPLITS)))
def test_popcount_words_sharded_matches_jax(split, head):
    widths = SPLITS[split]
    rng = np.random.default_rng(split * 4 + head)
    words = _words(rng, sum(widths))
    want = int(_popcount_words_jit(jnp.asarray(words)))
    got = kernels.popcount_words_sharded(_shards(words, widths, head))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want
    single = kernels.popcount_words(torch.from_numpy(words.view(np.int32)))
    assert int(single) == want


def test_popcount_words_extremes():
    """All-zero and all-one words, and no words."""
    for n, fill, want in ((0, 0, 0), (77, 0, 0), (77, 0xFFFFFFFF, 77 * 32),
                          (5, 0x80000000, 5)):
        words = np.full(n, fill, dtype=np.uint32)
        assert int(_popcount_words_jit(jnp.asarray(words))) == want
        got = kernels.popcount_words_sharded(
            [torch.from_numpy(words.view(np.int32))])
        assert int(got) == want


@pytest.fixture(scope="module")
def engine():
    db = synthetic_database(n_rows=2048, length=256, n_partitions=3, seed=9)
    return DeviceEngine(db, CPU, devices=[CPU] * 4)


def _filter(position):
    return Query(json.dumps({
        "action": {"type": "Aggregated"},
        "filterExpression": {"type": "HasNucleotideMutation",
                             "position": position}})).filter


def test_routes_reach_the_wrapper(engine):
    """count_async, DeviceFilter.popcount and ShardedQueryStep take the
    filter's total from the VM launch that writes it
    (kernels.vm_filter_sharded: on the CPU one plain VM run over the 4
    shards), the same totals as the host's popcount of the words; none
    reaches K11's wrapper."""
    flt = _filter(100)
    host = sum(int(np.unpackbits(w.view(np.uint8)).sum())
               for w in engine.evaluate(flt))
    kernels.reset_counts()
    total = engine.count_async(flt)
    assert total.dtype == torch.int64 and int(total) == host
    kernels.reset_counts()
    assert engine.device_filter(flt).popcount() == host
    code, _n, banks, dyns, _rows, fulls, _regs, _seg = engine.kernel_inputs(
        engine._prepare_program(engine.lower(flt)[0]))
    step = ShardedQueryStep(engine.shards.devices, engine.n_flat_words)
    assert kernels.VM_RUN_SHARDED.plain_launches == 1
    kernels.reset_counts()
    words, count, _muts = step(np.ascontiguousarray(code.numpy()), banks,
                               dyns, fulls, 0)
    assert count.dtype == torch.int32 and int(count) == host
    assert kernels.VM_RUN_SHARDED.plain_launches == 1
    assert (kernels.POPCOUNT_WORDS.launches,
            kernels.POPCOUNT_WORDS.plain_launches) == (0, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_popcount_kernel_on_card(cuda_device):
    """K11 against its plain version on the card for every split and head,
    on one card and round-robin over the visible cards; one launch per
    card; a 0-d int64 on the first shard's device."""
    n_cards = torch.cuda.device_count()
    for split, widths in enumerate(SPLITS):
        for head in (0, 1, 3):
            rng = np.random.default_rng(split * 4 + head)
            words = _words(rng, sum(widths))
            for cards in ([cuda_device] * len(widths),
                          [torch.device("cuda", d % n_cards)
                           for d in range(len(widths))]):
                on = _shards(words, widths, head, cards)
                kernels.reset_counts()
                got = kernels.popcount_words_sharded(on)
                assert kernels.POPCOUNT_WORDS.launches == len(set(cards))
                assert got.dtype == torch.int64 and got.device == on[0].device
                want = kernels.popcount_words_sharded_plain(on)
                assert int(got) == int(want), (split, head)
