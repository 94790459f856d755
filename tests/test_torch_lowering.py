"""The port's lowering (lapis_silo_torch/ops/lowering.py) against the JAX
package's: for the bench's count queries, the serving mix and random filter
trees over the rich corpus, both give bit-equal wire code arrays, equal dyn
rows and equal register counts (or raise the same host-fallback exception).
A partition-free filter, compiled in one partition, lowers to the program
its compile in every partition gives, without building plane words.
The reference engine runs on one CPU device, where its row layout is the
port's (no mesh padding, no TPU row alignment). Each engine lowers on its own
package's corpus, built from the same seed, and its own parse of the query."""

import json
import os
import random
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from lapis_silo_tpu import testing as ref_testing
from lapis_silo_tpu.ops import device_engine as ref_de
from lapis_silo_tpu.query.engine import Query as RefQuery
from lapis_silo_torch.ops import lowering, vm
from lapis_silo_torch.ops.device_engine import DeviceEngine
from lapis_silo_torch.parallel import dryrun
from lapis_silo_torch.query import ast
from lapis_silo_torch.query.engine import Query
from lapis_silo_torch.query.errors import QueryParseError
from lapis_silo_torch.storage.segment import SegmentIndex
from lapis_silo_torch.testing import (
    hot_count_queries, sample_count_queries, synthetic_database,
)

from .test_fuzz_filters import random_filter


def _engines(**corpus):
    return (ref_de.DeviceEngine(ref_testing.synthetic_database(**corpus),
                                devices=jax.devices()[:1]),
            DeviceEngine(synthetic_database(**corpus), torch.device("cpu")))


@pytest.fixture(scope="module")
def lean():
    return _engines(n_rows=2000, length=400, n_partitions=3, seed=4)


@pytest.fixture(scope="module")
def rich():
    return _engines(n_rows=999, length=333, n_partitions=3, seed=7, rich=True)


def _assert_same_lowering(engines, query_json: str) -> bool:
    """True when both lowered the query's filter, False when both fell
    back."""
    ref, port = engines
    try:
        want, want_regs = ref.lower(RefQuery(query_json).filter)
    except (ref_de.ProgramTooLarge, ref_de.StructureMismatch) as ex:
        with pytest.raises(getattr(vm, type(ex).__name__)):
            port.lower(Query(query_json).filter)
        return False
    got, got_regs = port.lower(Query(query_json).filter)
    assert got_regs == want_regs == got.max_regs == want.max_regs
    bucket = vm._LEN_BUCKETS[-1]
    np.testing.assert_array_equal(
        vm.pack_code_array(bucket, got.opcodes, got.operands, got.regspec),
        ref_de.pack_code_array(bucket, want.opcodes, want.operands,
                               want.regspec))
    assert len(got.dyn_rows) == len(want.dyn_rows)
    for got_rows, want_rows in zip(got.dyn_rows, want.dyn_rows):
        for g, w in zip(got_rows, want_rows, strict=True):
            np.testing.assert_array_equal(g, w)
    assert got.sparse_leaves == want.sparse_leaves == []
    return True


def test_row_layout_matches_reference(lean):
    ref, port = lean
    assert port.n_words == ref.n_words and port.n_rows == ref.n_rows
    for key, meta in ref.segment_meta.items():
        np.testing.assert_array_equal(port.segment_meta[key]["row_map"],
                                      meta["row_map"])


def test_sample_count_queries_lower_identically(lean):
    db = lean[1].db
    for query in sample_count_queries(db, 64, seed=3):
        assert _assert_same_lowering(lean, query)


def test_hot_count_queries_lower_identically(lean):
    db = lean[1].db
    positions = np.arange(0, 400, 7)
    for query in hot_count_queries(db, positions, 48, seed=5):
        assert _assert_same_lowering(lean, query)


def test_rich_filter_trees_lower_identically(rich):
    db = rich[1].db
    rng = random.Random(9)
    lowered = 0
    for _ in range(120):
        query = json.dumps({"filterExpression": random_filter(rng, db),
                            "action": {"type": "Aggregated"}})
        lowered += _assert_same_lowering(rich, query)
    assert lowered >= 90


# -- one compile for a partition-free filter ----------------------------------

def _per_partition(engine, filter_expr):
    """The per-partition lowering, whatever the filter: every partition's
    uniform compile, then one program from all the IRs."""
    with engine._lower_lock:
        irs = lowering._compile(engine.db, filter_expr, engine.db.partitions)
    return lowering._program(engine, irs)


def _outcome(lower, filter_expr):
    try:
        return lower(filter_expr)
    except Exception as ex:  # noqa: BLE001 — compared by type and text
        return ex


def _assert_same_outcome(got, want):
    if isinstance(want, Exception):
        assert type(got) is type(want) and str(got) == str(want), (got, want)
        return
    (got, got_regs), (want, want_regs) = got, want
    assert got_regs == want_regs and got.max_regs == want.max_regs
    assert got.opcodes == want.opcodes
    assert got.operands == want.operands
    assert got.regspec == want.regspec
    assert got.sparse_leaves == want.sparse_leaves
    assert got.reads_first == want.reads_first and got.writes == want.writes
    assert len(got.dyn_rows) == len(want.dyn_rows)
    for got_rows, want_rows in zip(got.dyn_rows, want.dyn_rows):
        for g, w in zip(got_rows, want_rows, strict=True):
            np.testing.assert_array_equal(g, w)


def _free_trees(db, n: int, seed: int) -> list[str]:
    """`n` random filter trees built from partition-free types only."""
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        query = json.dumps({"filterExpression": random_filter(rng, db),
                            "action": {"type": "Aggregated"}})
        if ast.partition_free(Query(query).filter):
            out.append(query)
    return out


def _partition_free_queries(db) -> list[str]:
    return (sample_count_queries(db, 32, seed=3)
            + hot_count_queries(db, np.arange(0, db.partitions[0]
                                              .nuc_sequences["main"].length, 7),
                                24, seed=5)
            + _free_trees(db, 60, seed=11))


@pytest.fixture(scope="module")
def two_tier():
    """A corpus of word-sparse rows with the sparse tier on: static leaves
    load as B_SPARSE operands as well as bank rows."""
    engine = DeviceEngine(synthetic_database(n_rows=3000, length=4000,
                                             n_partitions=3, seed=21),
                          torch.device("cpu"), sparse_min_words=1)
    assert engine.n_sparse > 0
    return engine


@pytest.mark.parametrize("corpus", ["lean", "rich", "two_tier"])
def test_partition_free_filters_lower_once_to_the_same_program(corpus, request):
    port = request.getfixturevalue(corpus)
    port = port if isinstance(port, DeviceEngine) else port[1]
    queries = _partition_free_queries(port.db)
    lowered = 0
    for query in queries:
        filter_expr = Query(query).filter
        before = (port.lowered_once, port.lowered_per_partition)
        got = _outcome(port.lower, filter_expr)
        _assert_same_outcome(got, _outcome(
            lambda f: _per_partition(port, f), filter_expr))
        if not isinstance(got, Exception):
            lowered += 1
            assert (port.lowered_once, port.lowered_per_partition) == (
                before[0] + 1, before[1])
    assert lowered >= len(queries) - 6


@pytest.mark.parametrize("leaf", ["string", "date", "int"])
def test_metadata_filters_lower_per_partition(rich, leaf):
    port = rich[1]
    rng = random.Random(13)
    for _ in range(20):
        query = json.dumps({
            "filterExpression": random_filter(rng, port.db, force_leaf=leaf),
            "action": {"type": "Aggregated"}})
        filter_expr = Query(query).filter
        assert not ast.partition_free(filter_expr)
        before = (port.lowered_once, port.lowered_per_partition)
        got = _outcome(port.lower, filter_expr)
        _assert_same_outcome(got, _outcome(
            lambda f: _per_partition(port, f), filter_expr))
        if not isinstance(got, Exception):
            assert (port.lowered_once, port.lowered_per_partition) == (
                before[0], before[1] + 1)


def test_partition_free_lowering_builds_no_plane_words(rich, monkeypatch):
    port = rich[1]
    calls = []
    plane = SegmentIndex.plane

    def counted(self, symbol_id, position):
        calls.append((symbol_id, position))
        return plane(self, symbol_id, position)

    monkeypatch.setattr(SegmentIndex, "plane", counted)
    for query in _partition_free_queries(port.db):
        _outcome(port.lower, Query(query).filter)
    assert calls == []


def test_dry_run_oracle_reads_the_words_it_compiles(lean):
    """The dry run's oracle compiles in uniform mode and evaluates the
    planes' words on the host: its counts stay the host path's."""
    db = lean[1].db
    for query in _partition_free_queries(db)[::3]:
        want = db.execute_query(query)["queryResult"][0]["count"]
        assert dryrun._oracle_count(db, Query(query).filter) == want


BAD_FILTERS = [
    ({"type": "NucleotideEquals", "position": 10_000, "symbol": "A"},
     QueryParseError),
    ({"type": "NucleotideEquals", "sequenceName": "nowhere", "position": 3,
      "symbol": "A"}, QueryParseError),
    ({"type": "HasNucleotideMutation", "position": 0}, IndexError),
]


@pytest.mark.parametrize("body,kind", BAD_FILTERS)
def test_partition_free_errors_keep_type_and_text(lean, body, kind):
    port = lean[1]
    filter_expr = Query(json.dumps({"filterExpression": body,
                                    "action": {"type": "Aggregated"}})).filter
    assert ast.partition_free(filter_expr)
    want = _outcome(lambda f: _per_partition(port, f), filter_expr)
    assert type(want) is kind
    _assert_same_outcome(_outcome(port.lower, filter_expr), want)


def test_coalesced_error_fails_only_its_caller(lean):
    """One batch holds a filter that fails to compile and good ones: the
    bad caller gets the per-partition path's error, its batch-mates their
    counts."""
    port = lean[1]
    db = port.db
    good = sample_count_queries(db, 6, seed=21)
    want = [db.execute_query(q)["queryResult"][0]["count"] for q in good]
    filters = [Query(q).filter for q in good]
    bad = Query(json.dumps({"filterExpression": BAD_FILTERS[0][0],
                            "action": {"type": "Aggregated"}})).filter
    bad_error = _outcome(lambda f: _per_partition(port, f), bad)
    filters.insert(3, bad)

    gate, entered = threading.Event(), threading.Event()
    launched = []
    count_programs = port.count_programs

    def held(programs, *args, **kwargs):
        launched.append(len(programs))
        if len(launched) == 1:  # the warm-up batch holds the dispatcher
            entered.set()
            gate.wait(timeout=30)
        return count_programs(programs, *args, **kwargs)

    port.count_programs = held
    results = [None] * len(filters)

    def call(i, filter_expr):
        results[i] = _outcome(port.count_coalesced, filter_expr)

    try:
        warm = threading.Thread(target=call, args=(0, filters[0]))
        warm.start()
        assert entered.wait(timeout=30)
        threads = [threading.Thread(target=call, args=(i, f))
                   for i, f in enumerate(filters)]
        for thread in threads:
            thread.start()
        deadline = time.monotonic() + 30
        while (len(port._batcher._queue) < len(filters)
               and time.monotonic() < deadline):
            time.sleep(0.005)
        gate.set()
        for thread in [warm] + threads:
            thread.join(timeout=60)
    finally:
        gate.set()
        del port.count_programs
    assert launched[1] == len(filters) - 1  # one batch, the bad one left out
    _assert_same_outcome(results.pop(3), bad_error)
    assert results == want


def test_lowering_counters_lose_no_update_under_threads(lean):
    """Threads lowering at once (more than the cores, a short switch
    interval) leave each counter at the number of lowerings."""
    port = lean[1]
    db = port.db
    free = [Query(q).filter for q in sample_count_queries(db, 8, seed=31)]
    metadata = Query(json.dumps({
        "filterExpression": {"type": "And", "children": [
            {"type": "IntBetween", "column": "age", "from": 20, "to": 70},
            {"type": "HasNucleotideMutation", "position": 17}]},
        "action": {"type": "Aggregated"}})).filter
    n_threads, rounds = 3 * (os.cpu_count() or 1) + 2, 6
    before = (port.lowered_once, port.lowered_per_partition)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(rounds):
                for f in free:
                    port.lower(f)
                port.lower(metadata)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=120)
            assert not thread.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert (port.lowered_once - before[0],
            port.lowered_per_partition - before[1]) == (
        n_threads * rounds * len(free), n_threads * rounds)
