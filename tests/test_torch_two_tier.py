"""The port's two-tier bank (CSR sparse tier and hot-leaf pool) against the
JAX package's engine with the tier forced on, and against the host oracle.
On the CPU the JAX engine has no pool (its pool needs the TPU's 3-D bank),
so the port's pooled results are held to the reference's poolless ones, and
its resident state through state_from_reference. Each package serves its own
corpus from the same seed and parses the queries itself. Every result is an
integer or an exact bitset: the tolerance is equality."""

import concurrent.futures
import json
import sys

import jax
import numpy as np
import pytest
import torch

import lapis_silo_torch
from lapis_silo_tpu import testing as ref_testing
from lapis_silo_tpu.ops import device_engine as ref_de
from lapis_silo_tpu.query.engine import Query as RefQuery
from lapis_silo_torch.ops import device_engine, kernels
from lapis_silo_torch.ops.device_engine import (
    DeviceEngine, build_state, state_from_reference,
)
from lapis_silo_torch.ops.vm import ProgramTooLarge
from lapis_silo_torch.query import ast
from lapis_silo_torch.query.engine import Query, QueryEngine
from lapis_silo_torch.query.ir import HostEvaluator
from lapis_silo_torch.testing import (
    hot_count_queries, sample_count_queries, synthetic_database,
)

CPU = torch.device("cpu")
# 1,000 sequences per partition over 4,000 positions: about 6 mutated
# sequences per (symbol, position) row, so nearly every row is word-sparse
CORPUS = dict(n_rows=3000, length=4000, n_partitions=3, seed=21)


@pytest.fixture(scope="module")
def corpus():
    return synthetic_database(**CORPUS)


@pytest.fixture(scope="module")
def ref_engine():
    engine = ref_de.DeviceEngine(ref_testing.synthetic_database(**CORPUS),
                                 devices=jax.devices()[:1],
                                 sparse_min_words=1)
    assert engine.n_sparse > 0 and engine.pool_slots == 0
    return engine


def _filters(queries):
    return [Query(q).filter for q in queries]


def _ref_filters(queries):
    return [RefQuery(q).filter for q in queries]


def _host_count(db, filter_expr):
    return sum(int(np.bitwise_count(_host_words(db, filter_expr, pi)).sum())
               for pi in range(len(db.partitions)))


def _host_words(db, filter_expr, pi):
    node = filter_expr.compile(db, db.partitions[pi], ast.NONE)
    return HostEvaluator(db.partitions[pi].sequence_count).evaluate(node)


def _leafy_filters(engine, positions, need):
    """HasNucleotideMutation filters whose programs carry sparse leaves,
    until their leaves together exceed `need`."""
    out, total = [], 0
    for pos in positions:
        f = Query(json.dumps({"filterExpression": {
            "type": "HasNucleotideMutation", "position": pos},
            "action": {"type": "Aggregated"}})).filter
        leaves = engine.lower(f)[0].sparse_leaves
        if leaves:
            out.append(f)
            total += len(leaves)
        if total > need:
            break
    assert total > need, "corpus too uniform"
    return out


def test_state_from_reference_equals_own_build(corpus, ref_engine):
    """Stream (de-interleaved and trimmed), bounds, row counts and every
    segment_meta field, the sparse ones included."""
    converted = state_from_reference(
        np.asarray(ref_engine.bank), np.asarray(ref_engine.full_masks),
        ref_engine.segment_meta, CPU, np.asarray(ref_engine.sparse_stream[0]),
        ref_engine.sparse_starts_pp, ref_engine.sparse_lengths_pp)
    own = build_state(corpus, CPU, sparse_min_words=1)
    for name in ("banks", "fulls"):
        (got,), (want,) = getattr(own, name), getattr(converted, name)
        assert torch.equal(got, want), name
    for name in ("sparse_idx", "sparse_words"):
        assert torch.equal(getattr(own, name), getattr(converted, name)), name
    assert own.sparse_idx.shape[0] == int(ref_engine.sparse_lengths.sum())
    for name in ("sparse_starts_pp", "sparse_lengths_pp"):
        np.testing.assert_array_equal(getattr(own, name),
                                      getattr(converted, name), err_msg=name)
    assert own.segment_meta.keys() == converted.segment_meta.keys()
    for key, want in converted.segment_meta.items():
        got = own.segment_meta[key]
        assert got.keys() == want.keys()
        for name, value in want.items():
            np.testing.assert_array_equal(got[name], value, err_msg=name)
    engine = DeviceEngine(corpus, CPU, state=converted)
    assert engine.n_sparse == ref_engine.n_sparse
    assert engine.n_rows == ref_engine.n_rows
    np.testing.assert_array_equal(engine._sparse_row_counts,
                                  ref_engine._sparse_row_counts)
    np.testing.assert_array_equal(engine._dense_row_counts,
                                  ref_engine._dense_row_counts)
    assert engine.max_sparse_k == ref_engine.max_sparse_k
    assert engine._pool_update_k_cap == ref_engine._pool_update_k_cap


def test_lowered_programs_equal_reference(corpus, ref_engine):
    """Code, dyn rows and sparse leaves of lowered programs, B_SPARSE
    leaves and majority reconstruction over sparse siblings included."""
    port = DeviceEngine(corpus, CPU, sparse_min_words=1)
    n_sparse_programs = 0
    for q in sample_count_queries(corpus, 48, seed=4):
        want, want_regs = ref_engine.lower(RefQuery(q).filter)
        got, got_regs = port.lower(Query(q).filter)
        assert (got.opcodes, got.operands, got.regspec, got.sparse_leaves,
                got.max_regs, got_regs) == (
            want.opcodes, want.operands, want.regspec, want.sparse_leaves,
            want.max_regs, want_regs)
        assert len(got.dyn_rows) == len(want.dyn_rows)
        n_sparse_programs += bool(got.sparse_leaves)
    assert n_sparse_programs > 20


@pytest.mark.parametrize("route", ["pooled", "poolless", "no_pool"])
def test_every_output_kind_matches_on_each_route(corpus, ref_engine, route,
                                                 monkeypatch):
    """words (evaluate), count (count_async) and multi_count
    (count_programs / count_dispatches) equal the JAX engine and the host
    oracle on the pooled route (small update chunks), the cold-sweep
    poolless route, and an engine without a pool (SILO_LEAF_POOL=0)."""
    if route == "no_pool":
        monkeypatch.setenv("SILO_LEAF_POOL", "0")
    engine = DeviceEngine(corpus, CPU, sparse_min_words=1)
    assert (engine.pool_slots > 0) == (route != "no_pool")
    engine._pool_update_k_cap = 4  # several update chunks per launch
    queries = sample_count_queries(corpus, 40, seed=12)
    filters, ref_filters = _filters(queries), _ref_filters(queries)
    want = ref_engine.count_batch(ref_filters)
    assert want == [_host_count(corpus, f) for f in filters]
    lowered = [engine.lower(f)[0] for f in filters]
    kernels.reset_counts()
    if route == "poolless":
        dispatches = engine.count_dispatches(lowered, force_poolless=True)
        got = engine.count_finish([None] * len(lowered),
                                  list(range(len(lowered))), dispatches)
        assert kernels.DENSIFY_ROWS.plain_launches == len(dispatches)
        assert kernels.DENSIFY_INTO_POOL.plain_launches == 0
    else:
        got = engine.count_programs(lowered)
        pooled = kernels.DENSIFY_INTO_POOL.plain_launches
        assert (pooled > 1) if route == "pooled" else (pooled == 0)
    assert got == want
    for f, ref_f, program in zip(filters[:12], ref_filters, lowered):
        if not program.sparse_leaves:
            continue
        words = engine.evaluate(f)
        for pi, part in enumerate(words):
            np.testing.assert_array_equal(part, _host_words(corpus, f, pi))
        assert int(engine.count_async(f, program)) == ref_engine.count(ref_f)


def test_execute_query_two_tier_matches_jax_engine(monkeypatch):
    """Two corpora from one seed, both engines two-tier by the budget rule
    (SILO_DENSE_BANK_BUDGET_GB; the budget leaves no room for a pool, so
    SILO_LEAF_POOL_GB sets one): counts through the micro-batcher, one at a
    time and from 16 threads, and Mutations (a sparse-leaf filter, so the
    DeviceFilter comes from the pool) give identical result dicts, equal to
    the host oracle."""
    monkeypatch.setenv("SILO_DENSE_BANK_BUDGET_GB", "0.00001")
    monkeypatch.setenv("SILO_LEAF_POOL_GB", "0.01")
    ref_db = ref_testing.synthetic_database(**CORPUS)
    port_db = synthetic_database(**CORPUS)
    engine = lapis_silo_torch.install(port_db, CPU)
    assert engine.n_sparse > 0 and engine.pool_slots > 0
    counts = sample_count_queries(port_db, 48, seed=8)
    muts = [json.dumps({"action": {"type": "Mutations", "minProportion": p},
                        "filterExpression": f}) for f, p in (
        ({"type": "HasNucleotideMutation", "position": 1201}, 0.0),
        ({"type": "Or", "children": [
            {"type": "HasNucleotideMutation", "position": 77},
            {"type": "IntBetween", "column": "age", "from": 90, "to": 93}]},
         0.05))]
    want = [ref_db.execute_query(q) for q in counts + muts]
    assert ref_db.device_engine.n_sparse > 0
    host = QueryEngine(port_db, use_device=False)
    port_db.device_engine = None
    try:
        assert [host.execute(q) for q in counts + muts] == want
    finally:
        port_db.device_engine = engine
    kernels.reset_counts()
    assert [port_db.execute_query(q) for q in counts + muts] == want
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            got = list(pool.map(port_db.execute_query, counts, timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert got == want[: len(counts)]
    assert kernels.SPARSE_COUNTS.plain_launches > 0
    assert kernels.DENSIFY_INTO_POOL.plain_launches > 0
    assert engine.pool_hits > 0 and engine.pool_misses > 0
    assert port_db._engine._use_device


def test_small_pool_evicts_and_stays_exact(corpus, monkeypatch):
    """A 64-slot pool (SILO_LEAF_POOL_GB) far smaller than the leaf
    universe: query sets that overflow it evict and refill without ever
    answering wrong."""
    probe = DeviceEngine(corpus, CPU, sparse_min_words=1)
    monkeypatch.setenv("SILO_LEAF_POOL_GB",
                       repr(64 * 4 * probe.n_flat_words / 2**30))
    engine = DeviceEngine(corpus, CPU, sparse_min_words=1)
    assert engine.pool_slots == 64
    rounds = []
    for base in (100, 1500, 3000, 100, 1500):
        rounds.append([Query(json.dumps({"filterExpression": {
            "type": "Or", "children": [
                {"type": "HasNucleotideMutation", "position": base + i * 7 + 1}
                for i in range(j, j + 6)]},
            "action": {"type": "Aggregated"}})).filter for j in range(0, 24, 6)])
    for filters in rounds:
        assert engine.count_batch(filters) == [_host_count(corpus, f)
                                               for f in filters]
    assert engine.pool_misses > engine.pool_slots
    assert len(engine._leaf_slot) <= engine.pool_slots


def test_pool_scan_resistance(corpus, monkeypatch):
    """Segmented LRU (mirrors tests/test_sparse_tier.py:265-314): a cold scan
    that overflows the pool several times does not flush leaves promoted by
    a second touch; the hot re-run misses nothing and stays exact."""
    probe = DeviceEngine(corpus, CPU, sparse_min_words=1)
    monkeypatch.setenv("SILO_LEAF_POOL_GB",
                       repr(64 * 4 * probe.n_flat_words / 2**30))
    engine = DeviceEngine(corpus, CPU, sparse_min_words=1)
    leafy = _leafy_filters(engine, range(1, 4001, 7), 4 * engine.pool_slots)
    hot, scan = leafy[:2], leafy[2:]
    want_hot = [_host_count(corpus, f) for f in hot]
    assert engine.count_batch(hot) == want_hot  # touch 1: probation
    assert engine.count_batch(hot) == want_hot  # touch 2: promoted
    assert set(engine._leaf_slot) & set(engine._protected), "no promotion"
    for i in range(0, len(scan), 8):
        batch = scan[i: i + 8]
        assert engine.count_batch(batch) == [_host_count(corpus, f)
                                             for f in batch]
    misses = engine.pool_misses
    assert engine.count_batch(hot) == want_hot
    assert engine.pool_misses == misses, "scan evicted the protected set"


def test_cold_sweep_bypasses_pool(corpus):
    """Mirrors tests/test_sparse_tier.py:349-398: a batch whose leaf set is
    mostly misses and wider than max_sparse_k rides the poolless densify
    when that takes fewer launches; no pool update runs and the resident
    hot set survives."""
    engine = DeviceEngine(corpus, CPU, sparse_min_words=1)
    hot = [Query(json.dumps({"filterExpression": {"type": "Or", "children": [
        {"type": "HasNucleotideMutation", "position": 3001},
        {"type": "HasNucleotideMutation", "position": 3012}]},
        "action": {"type": "Aggregated"}})).filter]
    assert engine.count_batch(hot) == [_host_count(corpus, hot[0])]
    resident = dict(engine._leaf_slot)
    assert resident, "hot leaves never became resident"
    engine.max_sparse_k = 4        # 5+ distinct cold leaves trip the cap
    engine._pool_update_k_cap = 1  # the pooled route: one launch per miss
    updates = engine.pool_update_dispatches
    cold = [Query(json.dumps({"filterExpression": {"type": "Or", "children": [
        {"type": "HasNucleotideMutation", "position": 200 + i * 17}
        for i in range(12)]}, "action": {"type": "Aggregated"}})).filter]
    assert len(engine.lower(cold[0])[0].sparse_leaves) > engine.max_sparse_k
    kernels.reset_counts()
    assert engine.count_batch(cold) == [_host_count(corpus, cold[0])]
    assert kernels.DENSIFY_ROWS.plain_launches == 1
    assert engine.pool_update_dispatches == updates
    assert dict(engine._leaf_slot) == resident
    assert engine.count_batch(hot) == [_host_count(corpus, hot[0])]


def test_failed_pool_update_drops_the_pool(corpus, monkeypatch):
    """An update that fails leaves no leaf claimed resident: the next
    launch reallocates the pool and answers exactly."""
    engine = DeviceEngine(corpus, CPU, sparse_min_words=1)
    filters = _filters(sample_count_queries(corpus, 16, seed=2))
    want = [_host_count(corpus, f) for f in filters]
    assert engine.count_batch(filters[:8]) == want[:8]
    assert engine._leaf_slot and engine.leaf_pool is not None

    def broken(*_args, **_kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(kernels, "densify_rows_into_pool", broken)
    with pytest.raises(RuntimeError):
        engine.count_batch(filters[8:])
    assert not engine._leaf_slot and engine.leaf_pool is None
    monkeypatch.undo()
    assert engine.count_batch(filters) == want


def test_sparse_caps_refuse_and_split_as_the_reference(corpus, ref_engine):
    """The lowering refuses a program with more sparse leaves than the
    batch cap, and a poolless batch splits at max_sparse_k."""
    engine = DeviceEngine(corpus, CPU, sparse_min_words=1)
    wide = json.dumps({"filterExpression": {"type": "Or", "children": [
        {"type": "HasNucleotideMutation", "position": p}
        for p in range(1, 200, 4)]}, "action": {"type": "Aggregated"}})
    n_leaves = len(engine.lower(Query(wide).filter)[0].sparse_leaves)
    engine.sparse_batch_cap = ref_engine.sparse_batch_cap = n_leaves - 1
    with pytest.raises(ProgramTooLarge):
        engine.lower(Query(wide).filter)
    with pytest.raises(ref_de.ProgramTooLarge):
        ref_engine.lower(RefQuery(wide).filter)
    ref_engine.sparse_batch_cap = ref_engine.max_sparse_k
    filters = _filters(hot_count_queries(corpus, list(range(0, 4000, 9)),
                                         64, seed=3))
    engine.max_sparse_k = 16
    lowered = [engine.lower(f)[0] for f in filters]
    dispatches = engine.count_dispatches(lowered, force_poolless=True)
    assert len(dispatches) > 1
    assert engine.count_finish([None] * len(lowered), list(range(len(lowered))),
                               dispatches) == [_host_count(corpus, f)
                                               for f in filters]


def test_stream_ascends_within_every_segment(corpus):
    """The densify kernels' contract: the synthetic two-tier corpus's stream
    strictly ascends within every (leaf, partition) segment, and the build's
    check (_check_stream) refuses a stream where one segment does not."""
    state = build_state(corpus, CPU, sparse_min_words=1)
    idx = state.sparse_idx.numpy()
    starts, lens = state.sparse_starts_pp, state.sparse_lengths_pp
    n_long = 0
    for start, n in zip(starts.reshape(-1), lens.reshape(-1)):
        assert (np.diff(idx[start:start + n]) > 0).all()
        n_long += n > 1
    assert n_long > 100
    device_engine._check_stream(idx, starts, lens)
    start, n = next((s, n) for s, n in zip(starts.reshape(-1), lens.reshape(-1))
                    if n > 2)
    bad = idx.copy()
    bad[start + 1], bad[start + 2] = bad[start + 2], bad[start + 1]
    with pytest.raises(ValueError):
        device_engine._check_stream(bad, starts, lens)
    repeat = idx.copy()
    repeat[start + 1] = repeat[start]
    with pytest.raises(ValueError):
        device_engine._check_stream(repeat, starts, lens)


def test_stream_segments_stay_in_their_partitions_words(corpus):
    """The sparse-counts kernel's contract, which lets it skip a partition
    whose filter words are all zero: partition p's segments index only its
    own words; the build's check refuses an entry moved to the next
    partition's words."""
    state = build_state(corpus, CPU, sparse_min_words=1)
    idx = state.sparse_idx.numpy()
    starts, lens = state.sparse_starts_pp, state.sparse_lengths_pp
    n_words = state.fulls[0].shape[0] // starts.shape[1]
    device_engine._check_stream(idx, starts, lens, n_words)
    leaf = int(np.flatnonzero(lens[:, 0])[0])
    moved = idx.copy()
    moved[starts[leaf, 0] + lens[leaf, 0] - 1] = n_words
    with pytest.raises(ValueError):
        device_engine._check_stream(moved, starts, lens, n_words)


@pytest.mark.parametrize("route", ["pooled", "poolless"])
def test_launch_refuses_offsets_past_int32(corpus, route, monkeypatch):
    """Stream offsets past the int32 limit (lowered here) make a densify
    launch raise ProgramTooLarge on either route instead of wrapping: no
    densify runs, the pool is dropped, and the host query engine answers."""
    engine = DeviceEngine(corpus, CPU, sparse_min_words=1)
    monkeypatch.setattr(device_engine, "_INT32_MAX", engine._stream_end // 2)
    queries = sample_count_queries(corpus, 24, seed=12)
    lowered = [engine.lower(f)[0] for f in _filters(queries)]
    kernels.reset_counts()
    with pytest.raises(ProgramTooLarge):
        if route == "pooled":
            engine.count_programs(lowered)
        else:
            engine.count_dispatches(lowered, force_poolless=True)
    assert kernels.DENSIFY_INTO_POOL.plain_launches == 0
    assert kernels.DENSIFY_ROWS.plain_launches == 0
    assert engine.leaf_pool is None and not engine._leaf_slot
    # below the limit every launch still runs
    monkeypatch.setattr(device_engine, "_INT32_MAX", engine._stream_end)
    assert engine.count_programs(lowered) == [
        _host_count(corpus, f) for f in _filters(queries)]


def test_build_refuses_a_stream_chunk_past_int32(corpus, monkeypatch):
    """The sparse Mutations kernel takes its chunk's offsets as int32: an
    engine whose stream chunk would pass the limit (lowered here) refuses
    to build rather than wrap; on 3 shards each chunk is a third."""
    n_entries = build_state(corpus, CPU, sparse_min_words=1).sparse_idx.shape[0]
    monkeypatch.setattr(device_engine, "_INT32_MAX", n_entries // 2)
    with pytest.raises(ValueError):
        DeviceEngine(corpus, CPU, sparse_min_words=1)
    engine = DeviceEngine(corpus, CPU, sparse_min_words=1, devices=[CPU] * 3)
    assert max(idx.shape[0] for idx, *_ in engine._sparse_chunks) <= (
        n_entries // 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_tier_engine_on_card_matches_cpu(cuda_device, corpus):
    """The port on the card against the port on the CPU: counts on the
    pooled and poolless routes, filter words, and Mutations."""
    card = DeviceEngine(corpus, cuda_device, sparse_min_words=1)
    cpu = DeviceEngine(corpus, CPU, sparse_min_words=1)
    card._pool_update_k_cap = cpu._pool_update_k_cap = 16
    filters = _filters(sample_count_queries(corpus, 64, seed=5))
    lowered = [cpu.lower(f)[0] for f in filters]
    want = cpu.count_programs(lowered)
    assert card.count_programs(lowered) == want
    dispatches = card.count_dispatches(lowered, force_poolless=True)
    assert card.count_finish([None] * len(lowered), list(range(len(lowered))),
                             dispatches) == want
    for f in filters[:8]:
        for a, b in zip(card.evaluate(f), cpu.evaluate(f)):
            np.testing.assert_array_equal(a, b)
    dev_filter = card.device_filter(filters[1])
    host_filter = cpu.evaluate(filters[1])
    got = card.mutation_counts_many("nuc", ["main"], dev_filter)["main"]
    np.testing.assert_array_equal(
        got, cpu.mutation_counts_many("nuc", ["main"], host_filter)["main"])
