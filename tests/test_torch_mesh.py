"""The port's ShardedQueryStep and dry run against the JAX package's.

``lapis_silo_torch.parallel.mesh.ShardedQueryStep`` on four CPU shards
(``[cpu] * 4``) and the JAX package's ``ShardedQueryStep`` on a mesh of
four of the 8 virtual CPU devices (tests/conftest.py) take the same
wire-format programs, bank, dyn rows and full masks (numpy, from the port's
lowering of a seeded corpus): the words, the count and the 64 segment
counts are equal, the segment start included where it clamps, and each
refusal carries the reference's message. ``dryrun_multichip`` passes on
``[cpu] * 4``. Every value is an integer or a word: the tolerance is
equality. The same on the card is marked `cuda`."""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from lapis_silo_tpu.parallel.mesh import ShardedQueryStep as RefStep
from lapis_silo_tpu.parallel.mesh import make_mesh
from lapis_silo_torch.ops import kernels, vm
from lapis_silo_torch.ops.device_engine import DeviceEngine
from lapis_silo_torch.ops.words import to_host
from lapis_silo_torch.parallel.dryrun import dryrun_multichip
from lapis_silo_torch.parallel.mesh import ShardedQueryStep
from lapis_silo_torch.parallel.shards import gather_words, split_words
from lapis_silo_torch.query.engine import Query
from lapis_silo_torch.testing import sample_count_queries, synthetic_database

CPU = torch.device("cpu")
N_SHARDS = 4
# 2,048 sequences in 3 partitions: 22 words per partition, padded to 24 on
# 4 shards, whose 18-word windows straddle partition edges
CORPUS = dict(n_rows=2048, length=256, n_partitions=3)


@pytest.fixture(scope="module")
def inputs():
    """(bank, full, [(code, dyn)] per query) as uint32/int32 numpy arrays:
    the bank and full mask of a 4-shard engine over the corpus, and each
    sampled query's padded program with its dyn rows on the flat axis."""
    db = synthetic_database(**CORPUS)
    engine = DeviceEngine(db, CPU, devices=[CPU] * N_SHARDS)
    bank = to_host(gather_words(engine.banks, CPU))
    full = to_host(gather_words(engine.fulls, CPU))
    programs = []
    for query in sample_count_queries(db, 8, seed=3):
        program = engine.lower(Query(query).filter)[0]
        n = len(program.opcodes)
        bucket = next(b for b in vm._LEN_BUCKETS if b >= n)
        code = vm.pack_code_array(bucket, program.opcodes, program.operands,
                                  program.regspec)
        dyn = np.zeros((max(1, len(program.dyn_rows)), bank.shape[1]),
                       dtype=np.uint32)
        for di, rows in enumerate(program.dyn_rows):
            for pi, row in enumerate(rows):
                start = pi * engine.n_words
                dyn[di, start: start + len(row)] = row
        programs.append((code, dyn))
    return bank, full, programs


@functools.cache
def _ref_step(n_rows, n_dyn, n_words, program_len):
    """The JAX step for these shapes (one compile for every call)."""
    return RefStep(make_mesh(jax.devices()[:N_SHARDS]), 1, n_rows, n_dyn,
                   n_words, program_len)


def _ref(code, bank, dyn, full, seg_slice):
    step = _ref_step(bank.shape[0], dyn.shape[0], bank.shape[1],
                     code.shape[1])
    words, count, muts = step(code, bank, dyn, full, seg_slice)
    return np.asarray(words), int(count), np.asarray(muts)


def _port(code, bank, dyn, full, seg_slice, devices):
    step = ShardedQueryStep(devices, bank.shape[1])
    devices = step.layout.devices
    words, count, muts = step(code, split_words(bank, devices),
                              split_words(dyn, devices),
                              split_words(full, devices), seg_slice)
    assert count.dtype == muts.dtype == torch.int32
    assert count.device == muts.device == step.layout.devices[0]
    return (to_host(gather_words(words, CPU)), int(count),
            muts.cpu().numpy())


@pytest.mark.parametrize("seg_slice", ["zero", "middle", "last", "past_end",
                                       "negative"])
def test_step_equals_the_jax_step(inputs, seg_slice):
    """Words, count and segment counts equal for every sampled program; the
    segment start wraps once where negative and clamps into [0, R-64], as
    jax.lax.dynamic_slice takes it."""
    bank, full, programs = inputs
    n_rows = bank.shape[0]
    start = {"zero": 0, "middle": n_rows // 2, "last": n_rows - 64,
             "past_end": n_rows + 100, "negative": -5}[seg_slice]
    for code, dyn in programs:
        want_words, want_count, want_muts = _ref(code, bank, dyn, full, start)
        got_words, got_count, got_muts = _port(code, bank, dyn, full, start,
                                               [CPU] * N_SHARDS)
        np.testing.assert_array_equal(got_words, want_words)
        assert got_count == want_count
        np.testing.assert_array_equal(got_muts, want_muts)
        # against a direct host popcount of the words
        assert got_count == int(np.unpackbits(got_words.view(np.uint8)).sum())
        clamped = min(max(start + n_rows * (start < 0), 0), n_rows - 64)
        segment = bank[clamped: clamped + 64] & got_words[None, :]
        np.testing.assert_array_equal(
            got_muts, np.unpackbits(segment.view(np.uint8), axis=1).sum(axis=1))


def test_step_runs_the_sharded_kernels_plain_on_the_cpu(inputs):
    bank, full, programs = inputs
    code, dyn = programs[0]
    before = (kernels.VM_RUN_SHARDED.plain_launches,
              kernels.MUTATION_COUNTS_SHARDED.plain_launches)
    _port(code, bank, dyn, full, 0, [CPU] * N_SHARDS)
    assert (kernels.VM_RUN_SHARDED.plain_launches,
            kernels.MUTATION_COUNTS_SHARDED.plain_launches) == (
                before[0] + 1, before[1] + 1)


def _refusal(fn) -> tuple[type, str]:
    with pytest.raises(Exception) as info:
        fn()
    return info.type, str(info.value)


def test_refuses_fewer_than_64_rows(inputs):
    bank, full, programs = inputs
    code, dyn = programs[0]
    small = np.ascontiguousarray(bank[:32])
    want = _refusal(lambda: _ref(code, small, dyn, full, 0))
    got = _refusal(lambda: _port(code, small, dyn, full, 0, [CPU] * N_SHARDS))
    assert got == want == (TypeError, want[1])


def test_refuses_words_not_a_multiple_of_the_shards():
    mesh = make_mesh(jax.devices()[:N_SHARDS])
    want = _refusal(lambda: RefStep(mesh, 1, 64, 1, 66, 16))
    got = _refusal(lambda: ShardedQueryStep([CPU] * N_SHARDS, 66))
    assert got == want == (ValueError, want[1])


def test_refuses_a_sparse_tier_program(inputs):
    """A program reading a B_SPARSE row: the JAX step asserts, the port
    raises ValueError, both with the reference's message."""
    bank, full, programs = inputs
    _code, dyn = programs[0]
    program = vm._Program()
    program.load(0, vm.B_SPARSE, 0)
    code = vm.pack_code_array(16, program.opcodes, program.operands,
                              program.regspec)
    want_type, want = _refusal(lambda: _ref(code, bank, dyn, full, 0))
    got_type, got = _refusal(
        lambda: _port(code, bank, dyn, full, 0, [CPU] * N_SHARDS))
    assert want_type is AssertionError and got_type is ValueError
    assert got == want == "ShardedQueryStep cannot execute sparse-tier programs"


def test_dryrun_multichip_on_four_cpu_shards():
    report = dryrun_multichip([CPU] * N_SHARDS)
    assert report["n_sparse"] > 0 and report["pool_hits"] > 0
    assert report["counts"] == 16 + report["n_sparse"]
    for name in ("vm_run_sharded", "mutation_counts", "sparse_counts",
                 "densify_rows_into_pool"):
        assert report["launches"][name][1] > 0, name
    json.dumps(report)  # plain values only


@pytest.mark.cuda
def test_step_on_the_card_equals_the_plain_versions(inputs):
    """The step on four shards of the first card: the words, count and
    segment counts equal the CPU step's (the plain versions), and K1 and
    K2 launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bank, full, programs = inputs
    card = torch.device("cuda", 0)
    kernels.reset_counts()
    for code, dyn in programs:
        for start in (0, bank.shape[0] - 64, bank.shape[0] + 100):
            got = _port(code, bank, dyn, full, start, [card] * N_SHARDS)
            want = _port(code, bank, dyn, full, start, [CPU] * N_SHARDS)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
            np.testing.assert_array_equal(got[2], want[2])
    assert kernels.VM_RUN.launches > 0 and kernels.MUTATION_COUNTS.launches > 0


@pytest.mark.cuda
def test_dryrun_multichip_on_four_card_shards():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n_cards = torch.cuda.device_count()
    report = dryrun_multichip([torch.device("cuda", d % n_cards)
                               for d in range(N_SHARDS)])
    assert not any(plain for _runs, plain in report["launches"].values())
