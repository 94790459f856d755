"""The port's device engine and query engine, end to end on the CPU, against
the JAX package: the same resident state, the same query results through
``db.execute_query``, and the fuzzed device==host check. Each package serves
its own corpus, built by its own ``testing.synthetic_database`` from the same
seed. All results are integers or exact bitsets: the tolerance is
equality."""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import lapis_silo_torch
from lapis_silo_tpu import testing as ref_testing
from lapis_silo_tpu.ops import device_engine as ref_de
from lapis_silo_tpu.ops import vm as ref_vm
from lapis_silo_torch.ops import kernels, vm
from lapis_silo_torch.ops.device_engine import (
    DeviceEngine, build_state, state_from_reference,
)
from lapis_silo_torch.ops.vm import ProgramTooLarge, StructureMismatch
from lapis_silo_torch.query import ast
from lapis_silo_torch.query.engine import Query, QueryEngine
from lapis_silo_torch.query.ir import HostEvaluator
from lapis_silo_torch.testing import sample_count_queries, synthetic_database

from .test_fuzz_filters import ALL_EXPRESSION_TYPES, random_filter

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]


def _mutations_queries(db, n):
    """Selective Mutations queries: one leaf at a mutated (symbol, position)
    each, with and without a minimum proportion, over several segments."""
    rng = np.random.default_rng(11)
    ref = db.reference_genomes.nucleotide_ids["main"]
    out = []
    for i in range(n):
        pos = int(rng.integers(0, len(ref)))
        symbol = "ACGT"[int(ref[pos]) % 4]
        filt = ({"type": "NucleotideEquals", "position": pos + 1,
                 "symbol": symbol} if i % 2 == 0 else
                {"type": "Or", "children": [
                    {"type": "HasNucleotideMutation", "position": pos + 1},
                    {"type": "IntBetween", "column": "age", "from": 90,
                     "to": 99}]})
        out.append(json.dumps({
            "action": {"type": "Mutations", "minProportion": 0.0 if i < 2 else 0.05},
            "filterExpression": filt}))
    return out


@pytest.mark.parametrize("rich", [False, True])
def test_state_from_reference_equals_own_build(rich):
    db = synthetic_database(1500, 300, n_partitions=3, seed=2, rich=rich)
    ref = ref_de.DeviceEngine(
        ref_testing.synthetic_database(1500, 300, n_partitions=3, seed=2,
                                       rich=rich),
        devices=jax.devices()[:1])
    converted = state_from_reference(np.asarray(ref.bank),
                                     np.asarray(ref.full_masks),
                                     ref.segment_meta, CPU)
    own = build_state(db, CPU)
    (own_bank,), (converted_bank,) = own.banks, converted.banks
    assert torch.equal(own_bank, converted_bank)
    (own_full,), (converted_full,) = own.fulls, converted.fulls
    assert torch.equal(own_full, converted_full)
    assert own.segment_meta.keys() == converted.segment_meta.keys()
    for key, want in converted.segment_meta.items():
        got = own.segment_meta[key]
        assert got.keys() == want.keys()
        for name, value in want.items():
            np.testing.assert_array_equal(got[name], value, err_msg=name)
    engine = DeviceEngine(db, CPU, state=converted)
    assert engine.evaluate(Query(sample_count_queries(db, 1)[0]).filter)


def test_slice_end_to_end_matches_jax_engine():
    """Two corpora from one seed: one served by the JAX package's engine,
    one by the port after install(); 64 counts and 4 Mutations queries give
    identical result dicts, and the port's path ran its kernels' wrappers."""
    ref_db = ref_testing.synthetic_database(3000, 600, n_partitions=2, seed=21)
    port_db = synthetic_database(3000, 600, n_partitions=2, seed=21)
    lapis_silo_torch.install(port_db, CPU)
    # a filter past the instruction cap: both engines evaluate it on the
    # host, and Mutations then reduces host bitsets on the device
    wide = json.dumps({
        "action": {"type": "Mutations", "minProportion": 0.0},
        "filterExpression": {"type": "Or", "children": [
            {"type": "HasNucleotideMutation", "position": p}
            for p in range(1, 600)]}})
    queries = (sample_count_queries(port_db, 64, seed=8)
               + _mutations_queries(port_db, 4) + [wide])
    kernels.reset_counts()
    for query in queries:
        assert port_db.execute_query(query) == ref_db.execute_query(query), query
    assert kernels.VM_RUN.plain_launches > 0
    assert kernels.MUTATION_COUNTS.plain_launches > 0
    assert port_db._engine._use_device


def _host_words(db, query):
    out = []
    for partition in db.partitions:
        node = query.filter.compile(db, partition, ast.NONE)
        out.append(HostEvaluator(partition.sequence_count).evaluate(node))
    return out


def test_fuzz_device_vs_host_on_port():
    """tests/test_fuzz_filters.py's random-tree check, run by the port's
    engine: device bitsets equal the host oracle's, batched counts equal
    per-query host counts."""
    db = synthetic_database(999, 333, n_partitions=3, seed=7, rich=True)
    engine = DeviceEngine(db, CPU)
    rng = random.Random(42)
    seen: set = set()
    filters, counts = [], []
    for _ in range(150):
        query = Query(json.dumps({
            "filterExpression": random_filter(rng, db, seen=seen),
            "action": {"type": "Aggregated"}}))
        host = _host_words(db, query)
        try:
            device = engine.evaluate(query.filter)
        except (ProgramTooLarge, StructureMismatch):
            continue
        for a, b in zip(host, device, strict=True):
            np.testing.assert_array_equal(a, b)
        filters.append(query.filter)
        counts.append(sum(int(np.bitwise_count(w).sum()) for w in host))
    assert len(filters) >= 110
    assert not ALL_EXPRESSION_TYPES - seen
    batched = []
    for i in range(0, len(filters), 16):
        batched.extend(engine.count_batch(filters[i: i + 16]))
    assert batched == counts


@pytest.mark.parametrize("max_bucket,n_dyn_leaves", [(64, 0), (None, 300)])
def test_wide_batches_split_and_stay_exact(max_bucket, n_dyn_leaves):
    """A batch past the instruction cap or the dyn-row cap splits into
    several launches; the counts still equal per-query host counts."""
    db = synthetic_database(700, 150, n_partitions=2, seed=13)
    engine = DeviceEngine(db, CPU)
    queries = sample_count_queries(db, 40, seed=6)
    queries += [json.dumps({"action": {"type": "Aggregated"},
                            "filterExpression": {"type": "And", "children": [
                                {"type": "IntBetween", "column": "age",
                                 "from": i % 50, "to": 50 + i % 49},
                                {"type": "HasNucleotideMutation",
                                 "position": 1 + i % 150}]}})
                for i in range(n_dyn_leaves)]
    filters = [Query(q).filter for q in queries]
    lowered = [engine.lower(f)[0] for f in filters]
    dispatches = engine.count_dispatches(lowered, max_bucket=max_bucket)
    assert len(dispatches) > 1
    want = [sum(int(np.bitwise_count(w).sum())
                for w in _host_words(db, Query(q))) for q in queries]
    assert engine.count_finish([None] * len(lowered), list(range(len(lowered))),
                               dispatches) == want


def _xla_whole_program(engine, args, sparse_rows) -> tuple:
    """The reference's XLA interpreter over the whole concatenated program
    of VmArgs `args`, its code NOP-padded to the reference's batch length
    bucket and its dyn and sparse rows zero-padded to fixed counts
    (operands index below them) so that few shapes compile: (reg[0] words,
    counts [4096])."""
    code, n_instr, banks, dyns, rows, fulls, n_regs, _starts = (
        engine.kernel_inputs(args, sparse_rows))
    pw = engine.n_flat_words

    def host(tensor, n_pad=None):
        words = tensor.numpy().view(np.uint32)
        if n_pad is None:
            return words
        out = np.zeros((n_pad, pw), dtype=np.uint32)
        out[: words.shape[0]] = words
        return out

    n_pad = 256 if rows[0].shape[0] <= 256 else 1024
    bank, dyn, sparse = (host(banks[0]), host(dyns[0], 256),
                         host(rows[0], n_pad))
    bucket = next(b for b in ref_vm._BATCH_LEN_BUCKETS if b >= n_instr)
    padded = np.full((2, bucket), ref_vm.WIRE_NOP, dtype=np.int32)
    padded[0] = 0
    padded[:, :n_instr] = code.numpy()
    blob = np.append(padded.reshape(-1), np.int32(n_instr))
    return tuple(np.asarray(ref_vm._interpreter(
        bucket, bank.shape[0], 256, n_pad, pw, output,
        n_regs=n_regs)(blob, bank, dyn, sparse, host(fulls[0])))
        for output in ("words", "multi_count"))


@pytest.mark.parametrize("tier", ["dense", "two_tier"])
def test_batch_segments_match_xla_whole_program(tier, monkeypatch):
    """Fuzzed filters (tests/test_fuzz_filters.py's generator) batched by
    batch_args: every lowered program is self-contained, so each query gets
    a segment of its own, and the segmented plain VM gives the words and
    counts of the reference's XLA interpreter running the whole
    concatenated program serially (two-tier: over the densified rows)."""
    monkeypatch.setenv("SILO_LEAF_POOL", "0")
    db = synthetic_database(999, 333, n_partitions=3, seed=7, rich=True)
    engine = DeviceEngine(db, CPU,
                          sparse_min_words=1 if tier == "two_tier" else None)
    assert (engine.n_sparse > 0) == (tier == "two_tier")
    rng = random.Random(5)
    lowered = []
    while len(lowered) < 96:
        query = Query(json.dumps({"filterExpression": random_filter(rng, db),
                                  "action": {"type": "Aggregated"}}))
        try:
            lowered.append(engine.lower(query.filter)[0])
        except (ProgramTooLarge, StructureMismatch):
            continue
    assert all(program.reads_first == 0 for program in lowered)
    n_sparse = 0
    for i in range(0, len(lowered), 12):
        batch = lowered[i: i + 12]
        args = engine.batch_args(batch)
        assert len(args.seg_starts) == len(batch) + 1
        assert args.seg_starts[-1] == args.n_instr
        rows = (engine._densified(args.sparse_leaves) if args.sparse_leaves
                else None)
        n_sparse += len(args.sparse_leaves)
        want_words, want_counts = _xla_whole_program(engine, args, rows)
        code, n_instr, banks, dyns, sparse, fulls, n_regs, starts = (
            engine.kernel_inputs(args, rows))
        words, counts = kernels.vm_run_plain(code, n_instr, banks[0], dyns[0],
                                             sparse[0], fulls[0], n_regs,
                                             starts)
        np.testing.assert_array_equal(counts.numpy(), want_counts)
        np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                      want_words)
    assert (n_sparse > 0) == (tier == "two_tier")


def test_dependent_program_joins_the_segment_before_it():
    """A batch whose second program reads a register the first one wrote:
    the second joins the first's segment, a third self-contained program
    starts its own, and the counts equal the XLA interpreter's serial run
    (on a fresh register file the second would count 0)."""
    db = synthetic_database(700, 150, n_partitions=2, seed=13)
    engine = DeviceEngine(db, CPU)
    first, second, third = (vm._Program() for _ in range(3))
    first.load(1, vm.B_BANK, 3)
    first.load(0, vm.B_BANK, 5)
    second.alu(vm.M_AND, 0, 1, 1)  # reg[1] from the first program
    third.load(0, vm.B_BANK, 3)
    for program in (first, second, third):
        program.max_regs = 2
    assert [p.reads_first == 0 for p in (first, second, third)] == [
        True, False, True]
    args = engine.batch_args([first, second, third])
    assert args.seg_starts.tolist() == [0, 5, args.n_instr]
    want_words, want_counts = _xla_whole_program(engine, args, None)
    code, n_instr, banks, dyns, rows, fulls, n_regs, starts = (
        engine.kernel_inputs(args))
    words, counts = kernels.vm_run_plain(code, n_instr, banks[0], dyns[0],
                                         rows[0], fulls[0], n_regs, starts)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want_words)
    row3 = int(engine._dense_row_counts[3])
    assert row3 > 0 and counts[:3].tolist() == [
        int(engine._dense_row_counts[5]), row3, row3]
    (got, q), = engine.count_dispatches([first, second, third])
    assert got[:q].tolist() == counts[:3].tolist()


@pytest.mark.parametrize("max_regs_of_last", [2, 1])
def test_dependent_program_merges_back_to_its_writer(max_regs_of_last):
    """A program that reads a register written two programs before it, past
    a self-contained one that does not write it, merges back through both
    segments; so does one that touches a register past its max_regs (its
    reads are not known under the batch's register bucket). The counts equal
    the XLA interpreter's serial run."""
    db = synthetic_database(700, 150, n_partitions=2, seed=13)
    engine = DeviceEngine(db, CPU)
    first, second, third, fourth = (vm._Program() for _ in range(4))
    first.load(2, vm.B_BANK, 3)
    first.load(0, vm.B_BANK, 5)
    second.load(0, vm.B_BANK, 7)
    third.alu(vm.M_OR, 0, 2, 2)  # reg[2] from the first program
    fourth.load(1, vm.B_BANK, 3)
    fourth.alu(vm.M_AND, 0, 1, 1)
    for program in (first, second, third):
        program.max_regs = 3
    fourth.max_regs = max_regs_of_last
    assert [p.reads_first == 0 for p in (first, second, third, fourth)] == [
        True, True, False, max_regs_of_last > 1]
    args = engine.batch_args([first, second, third, fourth])
    # the first three programs take 3 + 2 + 2 instructions with their EMITs
    starts = [0, 7] if max_regs_of_last > 1 else [0]
    assert args.seg_starts.tolist() == starts + [args.n_instr]
    want_words, want_counts = _xla_whole_program(engine, args, None)
    code, n_instr, banks, dyns, rows, fulls, n_regs, seg_starts = (
        engine.kernel_inputs(args))
    words, counts = kernels.vm_run_plain(code, n_instr, banks[0], dyns[0],
                                         rows[0], fulls[0], n_regs, seg_starts)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want_words)
    row3 = int(engine._dense_row_counts[3])
    assert row3 > 0 and counts[:4].tolist() == [
        int(engine._dense_row_counts[5]), int(engine._dense_row_counts[7]),
        row3, row3]


# 1,000 sequences per partition over 4,000 positions: with sparse_min_words=1
# nearly every row is word-sparse (the corpus of tests/test_torch_two_tier.py)
LAUNCH_CORPUS = dict(n_rows=3000, length=4000, n_partitions=3, seed=21)
LAUNCH_FILTERS = [
    {"type": "And", "children": [
        {"type": "HasNucleotideMutation", "position": 11},
        {"type": "HasNucleotideMutation", "position": 23}]},
    {"type": "And", "children": [
        {"type": "IntBetween", "column": "age", "from": 20, "to": 70},
        {"type": "HasNucleotideMutation", "position": 31}]},
    {"type": "And", "children": [
        {"type": "IntBetween", "column": "age", "from": 20, "to": 70},
        {"type": "Not", "child": {"type": "StringEquals", "column": "country",
                                  "value": "Germany"}},
        {"type": "HasNucleotideMutation", "position": 47}]},
    {"type": "Or", "children": [
        {"type": "DateBetween", "column": "date", "from": "2021-01-01",
         "to": "2021-03-01"},
        {"type": "HasNucleotideMutation", "position": 5},
        {"type": "IntBetween", "column": "age", "from": 90, "to": 99}]},
]


@pytest.mark.parametrize("case", ["program", "batch", "pooled"])
def test_launch_packs_code_at_its_length_and_dyn_rows_as_named(
        case, monkeypatch):
    """A launch carries its program at its own length: the code block is
    _round_instr(n) columns wide (n its instructions, a batch's EMITs
    included) and reaches the kernel without a copy, each shard's dyn block
    has one row per dyn row the programs name (one zero row for none), and
    the counts equal the host's. Cases: single programs (_prepare_program),
    a served batch (batch_args) and a batch over the hot-leaf pool of a
    two-tier bank, on two word shards."""
    db = synthetic_database(**LAUNCH_CORPUS)
    engine = DeviceEngine(db, CPU, devices=[CPU, CPU],
                          sparse_min_words=1 if case == "pooled" else None)
    assert len(engine.shards) == 2
    assert (engine.pool_slots > 0) == (case == "pooled")
    queries = [Query(json.dumps({"filterExpression": f, "action": {
        "type": "Aggregated"}})) for f in LAUNCH_FILTERS]
    lowered = [engine.lower(q.filter)[0] for q in queries]
    want = [sum(int(np.bitwise_count(words).sum())
                for words in _host_words(db, q)) for q in queries]
    assert sorted({len(p.dyn_rows) for p in lowered}) == [0, 1, 2]
    assert any(p.sparse_leaves for p in lowered) == (case == "pooled")
    seen = []
    vm_run_sharded = kernels.vm_run_sharded

    def recorded(code, n_instr, banks, dyns, *rest):
        seen.append((tuple(code.shape), n_instr,
                     [dyn.shape[0] for dyn in dyns]))
        return vm_run_sharded(code, n_instr, banks, dyns, *rest)

    monkeypatch.setattr(kernels, "vm_run_sharded", recorded)
    if case == "program":
        launches = [([p], engine._prepare_program(p), len(p.opcodes))
                    for p in lowered]
    else:
        launches = [(lowered, engine.batch_args(lowered),
                     sum(len(p.opcodes) + 1 for p in lowered))]
    got = []
    for programs, args, n in launches:
        named = sum(len(p.dyn_rows) for p in programs)
        assert args.n_instr == vm._round_instr(n)
        assert args.code.shape == (2, args.n_instr)
        assert len(args.dyn_rows) == named
        code, n_instr, _banks, dyns = engine.kernel_inputs(args)[:4]
        assert np.shares_memory(code.numpy(), args.code)
        assert [dyn.shape[0] for dyn in dyns] == [max(1, named)] * 2
        words, counts = engine._run(args)
        assert seen.pop() == ((2, n_instr), n_instr, [max(1, named)] * 2)
        if case == "program":
            got.append(int(np.bitwise_count(
                engine._gather_host(words)).sum()))
        else:
            got.extend(counts[:len(programs)].tolist())
    assert got == want
    if case == "pooled":
        assert engine.pool_hits + engine.pool_misses > 0


def test_concurrent_counts_coalesce_exactly():
    """Many threads through db.execute_query: the micro-batcher coalesces
    them into shared launches and every caller gets its own count."""
    import concurrent.futures
    import threading

    ref_db = ref_testing.synthetic_database(800, 200, n_partitions=2, seed=17)
    db = synthetic_database(800, 200, n_partitions=2, seed=17)
    queries = sample_count_queries(db, 96, seed=9)
    want = [ref_db.execute_query(q) for q in queries]  # the JAX package's engine
    lapis_silo_torch.install(db, CPU)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(24) as pool:
            got = list(pool.map(db.execute_query, queries, timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert got == want
    batcher = db.device_engine._batcher
    assert batcher is not None and batcher._thread.is_alive()
    assert threading.active_count() < 64


def test_two_tier_database_is_served(monkeypatch):
    """A database whose all-dense bank would exceed the budget gets the
    two-tier bank from install() and answers counts and Mutations equal to
    the host oracle."""
    monkeypatch.setenv("SILO_DENSE_BANK_BUDGET_GB", "0.00001")
    monkeypatch.setenv("SILO_LEAF_POOL_GB", "0.01")  # the budget leaves none
    db = synthetic_database(512, 2000, n_partitions=2, seed=1)
    queries = sample_count_queries(db, 24, seed=2) + [json.dumps({
        "action": {"type": "Mutations", "minProportion": 0.0},
        "filterExpression": {"type": "HasNucleotideMutation",
                             "position": 901}})]
    want = [QueryEngine(db, use_device=False).execute(q) for q in queries]
    engine = lapis_silo_torch.install(db, CPU)
    assert engine.n_sparse > 0 and engine.pool_slots > 0
    assert [db.execute_query(q) for q in queries] == want


def test_query_engine_falls_back_only_on_program_limits():
    """ProgramTooLarge answers from the host for that query alone; any other
    device failure reaches the caller and leaves the device path on."""
    db = synthetic_database(600, 200, n_partitions=2, seed=3)
    engine = lapis_silo_torch.install(db, CPU)
    query = sample_count_queries(db, 2, seed=4)[1]
    want = db.execute_query(query)

    def too_large(*_args, **_kwargs):
        raise ProgramTooLarge("test")

    engine.count_coalesced = too_large
    assert db.execute_query(query) == want

    def broken(*_args, **_kwargs):
        raise ImportError("test")

    engine.count_coalesced = broken
    with pytest.raises(ImportError):
        db.execute_query(query)
    assert db._engine._use_device


def test_port_runs_with_jax_blocked():
    """A process where importing jax fails imports the port and answers a
    count and a Mutations query from it, equal to the host oracle."""
    script = """
import sys
sys.modules["jax"] = None
import json, torch
import lapis_silo_torch
from lapis_silo_torch.query.engine import QueryEngine
from lapis_silo_torch.testing import sample_count_queries, synthetic_database
db = synthetic_database(500, 120, n_partitions=2, seed=5)
oracle = QueryEngine(db, use_device=False)
mutations = json.dumps({"action": {"type": "Mutations", "minProportion": 0.0},
                        "filterExpression": {"type": "IntBetween",
                                             "column": "age", "from": 1, "to": 20}})
want = [oracle.execute(q) for q in (sample_count_queries(db, 4)[3], mutations)]
lapis_silo_torch.install(db, torch.device("cpu"))
got = [db.execute_query(q) for q in (sample_count_queries(db, 4)[3], mutations)]
assert got == want, (got, want)
assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")
            if sys.modules[m] is not None]
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    done = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "ok"
