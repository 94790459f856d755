#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU: counts, group-by, Details
and Mutations through the engine, the query step across processes, a
snapshot served over HTTP by one process and by a multi-host slice of
three, and input files ingested by the port into a snapshot that it serves
on the card.

    python3 chip_smoke.py           # every phase, on one card or more
    python3 chip_smoke.py --pod     # phases 8c and 8d alone (four cards)

Phases, one line each or more (the last line is the JSON verdict):
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build the CUDA kernels from lapis_silo_torch/csrc (one nvcc per
     source, all at once; seconds, and the compiler's register report);
  3. each kernel and kernel wrapper against its plain PyTorch version on the
     card, bit-exact (tolerance 0: every value is an integer), on random
     inputs (ragged word counts, empty segments, K = 1 and K at the caps,
     pool slots including the scratch row, densify windows of word shards,
     the VM in one segment and in random segments, also over 4 word shards
     and over 3 of ragged widths,
     the group-count kernel K9 for every code type (uint8, int16, int32)
     at every bucket edge with padding and negative codes, all bits set and
     clear, on one shard, on shard windows, on 3 shards of ragged widths
     round-robin on the cards and on 4 of one card; K10 and K11 on shards
     just under and past whole tiles, views that start inside a 16-byte
     quad, empty shards, at every fill around the cap; the VM with the
     filter's epilogue, vm_filter_sharded, on random programs over one
     shard, 4 of one card and 3 of ragged widths over the cards, its total
     and blocks also against K11 and K10 on its words) and at the
     main paths' shapes (the 512-query batch in its per-query segments, and
     as one segment), with both times there (for the VM also its wrapper's
     wall time per call, host time included) and each kernel's bound, the
     larger of its bytes over the HBM rate and its operations over the peak
     rate (K9, K10 and K11 at phase 5's shapes in its set-up,
     the two-tier shapes in phase 7's, the sharded ones in phase 8a's; K9
     there by date over every sequence, the 6% Details filter and one
     mutation, beside the split of one group-by query: evaluate_device, K9,
     the copy to the host, the host's ordering and decoding; the
     windowed and chunked ones in 8b's; there the densify kernels also take
     their wall time per call through the engine's route, a pool-update
     chunk's included, beside zero_() of a block of the same shape);
  4. the dense main path at the bench default, 65,536 sequences x 29,903
     positions in 1 partition: (a) 64 count queries through
     db.execute_query, one at a time and then from a thread pool so the
     micro-batcher coalesces them, (b) 512 lowered queries through one wide
     count_programs launch, (c) two selective Mutations queries; all equal
     to the host oracle;
  5. at 1,048,576 sequences x 29,903 positions in 4 partitions (a dense bank
     of about 11.8 GB on the card): set-up holds K10 (the compact
     extraction) and K11 (the word popcount), which the engine's routes no
     longer launch, to their plain versions at the engine's shapes, at
     fills 0, 1, cap - 1, cap, cap + 1 and 5 cap, one launch per card, the
     VM launch with the filter's epilogue (its total and compact blocks,
     what the routes take) to the plain versions on its words, compares
     evaluate_compact with evaluate() below and above its cap, times that
     launch against the VM alone and the VM followed by K11 or by K10, and
     K10 and K11 against the torch-op chains they replaced, then times the
     extraction and the bitset copy as whole
     calls on synthetic words from 131,072 to 4,194,304 flat words, the
     host's rebuild apart (K10's extraction, off the main path;
     scripts/torch_fused_ab.py times the VM launch's own against the
     copy, which is where COMPACT_MIN_WORDS is checked), and K9 with
     its plain version for every group-by column list (each list's codes
     held as uint8); then the 64 counts, 8 group-by queries (by date,
     country, date and country, age; K9 launched once per query per card,
     here and in 7, 8a and 8b), two Details through evaluate_compact
     (one VM launch per query per card yields the compact blocks, and no
     K10, here and in 7 and 8a; COMPACT_MIN_WORDS set to 0
     on the engine: the corpus has fewer flat words; one filter under the
     cap, one over), two Mutations queries (one VM launch per query per
     card yields the filter's total, and no K11, in every phase) and
     counts of those filters through count (the same), all equal to the
     host oracle;
  8a. phase 5's corpus and oracle answers on the word-sharded engine: the
     single-device engine freed, install(db, ..., devices=[4 shards]) places
     the shards round-robin on the visible cards (all four on one card when
     there is one; the phase says which), four [89,709, 8,192] banks; the 64
     counts, a 512-query count_programs call, the group-by and Details
     queries and one Mutations query, all equal to the host oracle;
     vm_run_sharded (K6) and mutation_counts_sharded against their plain
     versions at these shapes, with both times, K6's bound and beside it K1
     over all 32,768 words in one launch; K10, K11 and K9 over the 4
     shards in one launch per card;
  8c. on the same shards, lapis_silo_torch.parallel.mesh.ShardedQueryStep:
     one program's words, count (from the VM launch, one per card; no K11)
     and 64 segment counts (the main segment's
     start, and a start past the end, clamped) equal to the plain versions
     on the card and a popcount on the host, its time per call on the card
     and wall; then parallel.dryrun.dryrun_multichip on 4 shards of the
     visible cards (its own corpus, the sparse tier forced: counts cold and
     pool-resident, group-by, Mutations, against the host oracle and a
     one-device engine; K6, K2, K3, K5 launched, no plain version);
  8d. the pod path: phase 5's corpus saved as a snapshot under build/;
     ranks of one torch.distributed process group over the same 4 global
     shards (on one card 2 ranks x 2 shards joined by gloo, since NCCL
     takes one card per rank; on four cards 4 ranks x 1 over NCCL), each
     loading the snapshot and keeping its shards of the port engine's
     bank, run 8c's program at 8c's segment starts: each rank's words
     (by hash), the all-reduced count and 64 segment counts equal 8c's;
     per rank the VM (K6, or K1 with one shard a card) and K2 launched,
     no K10 or K11, no plain version, no JAX module; the step's busy time
     on the card
     (torch.profiler) and wall per call, the all-reduce's wall time
     alone, peak and held device memory; then
     lapis_silo_torch.parallel.distributed_worker as one NCCL rank with 4
     shards on the first card against the numpy oracle;
  9. the slice's path: phase 5's corpus saved with the port's save_database
     under build/, loaded by the port's DatabaseDirectoryWatcher (which
     installs the port's engine on the visible cards and warms it up) and
     served in this process on port 0 by make_server, the Python server and,
     where libsilo_http.so builds (into build/native/), the native server:
     64 counts, the group-by queries, one Details and two Mutations over
     HTTP, every body equal to the host oracle and /info to db.info(); then
     the native fast path answers the counts with no Python routing; the
     save, load and warm-up seconds and p50 per action;
  11. the multi-host slice: phase 5's corpus saved by
     lapis_silo_torch.testing.save_shards as 3 shards under one data
     version (partitions 0-1, a bank of about 5.9 GB, for the coordinator;
     2 and 3, about 2.9 GB each, for two workers) under build/; two
     `python -m lapis_silo_torch.cli --worker` processes and one
     `--coordinator --workerUrls` over them (each through a thin wrapper
     around cli.main that records, before the CLI's os._exit, its launches
     and plain runs since its first committed version, its allocator peak
     and the jax* / lapis_silo_tpu* modules loaded), all on the one card;
     once /info counts the whole corpus, phase 9's queries through the
     coordinator over HTTP, the 64 counts again from 16 threads (the
     batched fan-out), /info and /info?details=true, every body equal to
     the host oracle over the whole corpus; per process the VM, K2 and K9
     launched, no plain version, no JAX module; SIGTERM ends each with exit
     code 0; seconds to the first committed version, p50 per action beside
     phase 9's, device memory per process (nvidia-smi);
  7. the two-tier deployment, 2,097,152 sequences x 29,903 positions in 8
     partitions, whose all-dense bank (about 23.5 GB) exceeds the 12 GiB
     budget, so the engine builds the CSR sparse tier and the hot-leaf pool:
     (a) the 64 counts, cold and then hot, (b) 512 lowered queries through
     count_programs (pooled) and through count_dispatches with
     force_poolless (densified blocks), (c) two Mutations queries, the
     group-by and Details queries; all equal to the host oracle;
  8b. phase 7's corpus on 4 word shards of 16,384 words: the window-local
     densify_rows and densify_rows_into_pool and the chunked sparse_counts
     against their plain versions at these shapes, with both times; then
     cold and hot counts, the pooled and the poolless wide batch, two
     Mutations queries, the group-by and Details queries, all equal to the
     host oracle, through the window-local pool updates and densified blocks
     and the entry-split sparse Mutations;
  10. ingest, the slice's path: lapis_silo_torch.testing.write_ingest_inputs
     writes 65,536 records x 29,903 positions as NDJSON (about 2 GB; a gene,
     unaligned sequences, insertions, null sequences, metadata of every
     type with nulls; partitionBy and dateToSortBy) under build/; the
     NDJSON scanner (libsilo_ndjson.so) is built before the timed ingests,
     and its build time logged apart; the port's
     CLI (python -m lapis_silo_torch.cli --preprocessing, in a subprocess,
     through a thin wrapper around its main that records the NDJSON scanner
     and the loaded modules) ingests it into a snapshot with the native
     scanner and no jax* or lapis_silo_tpu* module; the port's watcher
     loads it onto the visible card and make_server serves it on port 0:
     64 counts, the group-by queries, per-country counts, 8 NucleotideEquals
     counts, one Details, two Mutations, one AminoAcidMutations, one
     Insertions and /info over HTTP, every body equal to the host oracle
     over the same snapshot, and the per-country and NucleotideEquals
     counts also to the writer's own arrays; then the same file through
     --ingestShards 2, whose snapshot gives every body again; ingest,
     save, load+install and warm-up seconds and p50 per action, beside the
     card's name
     and power limit;
  6. assertions: every kernel launched during phases 4, 5, 7, 8, 9, 10 and
     11 (phase 8d's and 11's counts come from their processes) but those
     of OFF_PATH: popcount_rows_and_filter, which no engine path calls, and
     K10 and K11, whose work the VM launch does (none of them launched
     there); no plain version ran there, the VM (K1, or K6 where a card
     holds several shards), K2 and K9 launched in phases 9 and 10 and in
     each process of phase 11, no module of jax* or lapis_silo_tpu* was
     loaded, the device path stayed on.

Each main-path phase runs with the launch counts set to 0 just before it and
read just after; the comparisons between phases are not counted. There is no
CPU path: without a CUDA device the script exits non-zero before phase 2. It
builds its corpora and its host oracle from the port alone
(``lapis_silo_torch.testing``, ``QueryEngine(db, use_device=False)``) and
asserts at the end that no module of ``jax*`` or ``lapis_silo_tpu*`` was
loaded.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import hashlib
import http.client as http_client
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
BENCH = dict(n_rows=65536, length=29903, n_partitions=1)
DEPLOYMENT = dict(n_rows=1048576, length=29903, n_partitions=4)
TWO_TIER = dict(n_rows=2097152, length=29903, n_partitions=8)
INGEST = dict(n_rows=65536, length=29903, seed=0)
N_SHARDS = 4
# kernels that no main-path phase runs: K8 has no engine caller, and the
# routes take K10's and K11's work from the VM launch that writes the
# filter (kernels.vm_filter_sharded)
OFF_PATH = ("popcount_rows_and_filter", "compact_nonzero", "popcount_words")
# the VM's launch counts: K1 where a card holds one shard, K6 several
VM_KERNELS = ("vm_run", "vm_run_sharded")
# JAX and the JAX package: no module of either may be loaded
JAX_MODULES = ("jax", "lapis_silo_tpu")
# the least time of a kernel's work: its bytes over the H100's HBM rate, or
# its operations (integer ALU and popcount, on the CUDA cores) over the
# card's peak outside the tensor cores, 67 T/s (NVIDIA's H100 SXM data
# sheet, float32), whichever is longer, per card the work is spread over
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
REPLACES = {name: f"lapis_silo_tpu/ops/pallas_kernels.py:{line}" for name, line
            in (("vm_run", 526), ("mutation_counts", 150),
                ("sparse_counts", 438), ("densify_rows", 850),
                ("densify_rows_into_pool", 1252), ("vm_run_sharded", 741),
                ("mutation_counts_sharded", 777),
                ("popcount_rows_and_filter", 104))}
# K9's, K10's and K11's references are XLA code, no Pallas kernel: the
# group-by reduction, the interpreter's compact output, the word popcount
REPLACES["group_counts"] = "lapis_silo_tpu/ops/reductions.py:24"
REPLACES["compact_nonzero"] = "lapis_silo_tpu/ops/vm.py:505"
REPLACES["popcount_words"] = "lapis_silo_tpu/ops/reductions.py:19"
# the dashboard group-by queries of phases 5, 7, 8 and 9
GROUP_BYS = (["date"], ["country"], ["date", "country"], ["age"])


def log(phase: str, message: str) -> None:
    print(f"[{phase}] {message}", flush=True)


def nvidia_smi() -> str:
    done = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return done.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events over `reps` calls. The
    calls are queued behind a spin of about 50 ms on the card, so that the
    host's time between launches (argument checks, uploads) does not show
    in a kernel's time while the queue lasts."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int, warmup: int = 1) -> float:
    """Wall time per call of fn() in ms, host time included: `warmup`
    calls, synchronize, `reps` calls, synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def busy_ms(fn, reps: int) -> float:
    """The card's busy time per call of fn() in ms: the kernels and copies
    of `reps` calls as torch.profiler (CUPTI) records them, summed. Unlike
    cuda_ms it leaves out the card's idle gaps, where the host blocks
    (gloo's all-reduce) or another process has the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages())
    assert busy_us > 0, "the profiler saw no device time"
    return busy_us / 1e3 / reps


def bound(n_bytes: float, n_ops: float, n_cards: int = 1) -> tuple:
    """(bound_ms, bound_by) of work that moves `n_bytes` and does `n_ops`
    spread evenly over `n_cards` cards."""
    t_bytes = n_bytes / HBM_BYTES_PER_S / n_cards * 1e3
    t_ops = n_ops / CORE_OPS_PER_S / n_cards * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def vm_work(vm, code, n_instr: int, rows: dict, pw: int,
            segments) -> tuple[int, int]:
    """(bytes, operations) a VM launch needs: each distinct row its
    instructions read (bank, dyn, sparse; clipped as the kernel clips), the
    full mask, the code and segment starts read once; reg[0] words and the
    4,096 counts written once; one ALU operation per instruction and word,
    and a popcount per EMIT and word."""
    code = np.asarray(code)[:, :n_instr]
    specs = code[1].astype(np.int64)
    bsrc = (specs >> vm.WIRE_BSRC_SHIFT) & 0xF
    n_rows = 0
    for src, n in rows.items():
        picked = np.clip(code[0][bsrc == src], 0, n - 1)
        n_rows += np.unique(picked).size
    n_emits = int(((specs >> vm.WIRE_OP_SHIFT) & 0x3 == vm.EMIT_COUNT).sum())
    n_seg = 1 if segments is None else len(segments) - 1
    n_bytes = (4 * pw * (n_rows + 2) + 8 * n_instr + 4 * (n_seg + 1)
               + 4 * vm.MAX_BATCH_QUERIES)
    return n_bytes, (n_instr + n_emits) * pw


def stream_work(starts, lens, n_out_words: int, n_extra: int = 0):
    """(bytes, operations) of a pass over the CSR entries of the segments
    (starts, lens [K, P] host arrays) that writes `n_out_words` int32:
    each entry's index and word read once, the bounds read once, `n_extra`
    more int32 moved; one operation per entry."""
    n_entries = int(np.asarray(lens, dtype=np.int64).sum())
    return (8 * n_entries + 8 * np.asarray(starts).size
            + 4 * (n_out_words + n_extra), n_entries)


def max_abs_err(got, want) -> int:
    """Largest |got - want| over int32-held words/counts, compared as the
    unsigned values they hold (0 means bit-exact)."""
    import torch

    got = got.to(torch.int64) & 0xFFFFFFFF
    want = want.to(torch.int64) & 0xFFFFFFFF
    return int((got - want).abs().max()) if got.numel() else 0


def word_hash(words) -> str:
    """SHA-256 of a word tensor's int32 bytes."""
    return hashlib.sha256(words.cpu().numpy().tobytes()).hexdigest()


class MainPath:
    """Launch counts of the kernels and their plain versions, summed over
    the main-path phases only."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.launches = {k.name: 0 for k in kernels.KERNELS}
        self.plain = {k.name: 0 for k in kernels.KERNELS}

    @contextlib.contextmanager
    def phase(self):
        """Counts set to 0 just before the phase and read just after."""
        self.kernels.reset_counts()
        yield
        for k in self.kernels.KERNELS:
            self.launches[k.name] += k.launches
            self.plain[k.name] += k.plain_launches

    def add(self, launches: dict, plain: dict) -> None:
        """Counts of a main-path run in another process (phase 11's
        hosts), by kernel name."""
        for name in self.launches:
            self.launches[name] += launches[name]
            self.plain[name] += plain[name]


def vm_launched(launches: dict) -> bool:
    """Whether the filter VM ran on the card, by launch counts per kernel
    name: K1 where an engine has one shard per card, K6 (vm_run_sharded)
    where a card holds several."""
    return sum(launches[name] for name in VM_KERNELS) > 0


def vm_launches(kernels) -> int:
    """The VM's launches so far (K1 and K6)."""
    return kernels.VM_RUN.launches + kernels.VM_RUN_SHARDED.launches


def fused_launches(kernels, phase: str, n_cards: int, fn):
    """fn()'s result, asserting that it ran one VM launch per card and no
    standalone K10 or K11: the route's total or blocks came from the VM
    launch that wrote the filter."""
    before = (vm_launches(kernels), kernels.COMPACT_NONZERO.launches,
              kernels.POPCOUNT_WORDS.launches)
    out = fn()
    after = (vm_launches(kernels), kernels.COMPACT_NONZERO.launches,
             kernels.POPCOUNT_WORDS.launches)
    assert (after[0] - before[0], after[1] - before[1],
            after[2] - before[2]) == (n_cards, 0, 0), (phase, before, after)
    return out


def oracle(db, queries: list[str]) -> list[dict]:
    """The host query engine's answers. The device engine is detached while
    it runs: the Mutations action would otherwise reduce on it."""
    from lapis_silo_torch.query.engine import QueryEngine

    device_engine = db.device_engine
    db.device_engine = None
    try:
        host = QueryEngine(db, use_device=False)
        return [host.execute(q) for q in queries]
    finally:
        db.device_engine = device_engine


def mutations_queries(db) -> list[str]:
    """Two selective Mutations filters: one stored mutation, and a mutation
    OR'd with a narrow age band."""
    from lapis_silo_torch.common.symbols import NUCLEOTIDE

    ref = db.reference_genomes.nucleotide_ids["main"]
    pos_a, pos_b = min(21562, len(ref) - 1), min(2400, len(ref) - 1)
    leaf = {"type": "NucleotideEquals", "position": pos_a + 1,
            "symbol": NUCLEOTIDE.chars[int(ref[pos_a]) % 4 + 1]}
    either = {"type": "Or", "children": [
        {"type": "HasNucleotideMutation", "position": pos_b + 1},
        {"type": "And", "children": [
            {"type": "IntBetween", "column": "age", "from": 97, "to": 98},
            {"type": "DateBetween", "column": "date", "from": "2021-03-01",
             "to": "2021-03-02"}]}]}
    return [json.dumps({"action": {"type": "Mutations", "minProportion": p},
                        "filterExpression": f})
            for f, p in ((leaf, 0.05), (either, 0.02))]


def groupby_queries(db) -> list[str]:
    """The dashboard group-by queries (GROUP_BYS), over every sequence and
    over one stored mutation."""
    leaf = json.loads(mutations_queries(db)[0])["filterExpression"]
    return [json.dumps({"action": {"type": "Aggregated", "groupByFields": cols},
                        "filterExpression": f})
            for cols in GROUP_BYS for f in ({"type": "True"}, leaf)]


def details_queries(db) -> list[str]:
    """Two Details queries: one stored mutation (a few hundred sequences,
    under COMPACT_CAP_WORDS non-zero words) and a narrow age band (6% of
    the sequences, spread over most words: over the cap, with a host action
    that stays short)."""
    leaf = json.loads(mutations_queries(db)[0])["filterExpression"]
    wide = {"type": "IntBetween", "column": "age", "from": 40, "to": 45}
    return [json.dumps({"action": {"type": "Details",
                                   "fields": ["key", "age", "date", "country"],
                                   "orderByFields": ["age"], "limit": 20},
                        "filterExpression": f}) for f in (leaf, wide)]


def run_groupby(db, queries: list[str], want: list[dict], phase: str,
                engine) -> None:
    """The group-by queries against the oracle's answers, with K9 launched
    once per query per card of `engine` and its plain version never."""
    from lapis_silo_torch.ops import kernels

    n_cards = len(engine.shards.distinct)
    launches = kernels.GROUP_COUNTS.launches
    plain = kernels.GROUP_COUNTS.plain_launches
    latencies = []
    for query, expected in zip(queries, want):
        t0 = time.perf_counter()
        got = db.execute_query(query)
        latencies.append(time.perf_counter() - t0)
        assert got == expected, query
    n_launched = kernels.GROUP_COUNTS.launches - launches
    assert n_launched == len(queries) * n_cards, (n_launched, n_cards)
    assert kernels.GROUP_COUNTS.plain_launches == plain
    log(phase, f"{len(queries)} group-by queries (by "
        f"{', '.join('+'.join(c) for c in GROUP_BYS)}; every sequence and one "
        f"mutation) equal the host oracle, "
        f"{[len(w['queryResult']) for w in want]} rows; p50 "
        f"{statistics.median(latencies) * 1e3:.3f} ms, max "
        f"{max(latencies) * 1e3:.3f} ms; K9 launched {n_launched} times, "
        f"once per query per card ({n_cards})")


def run_details(db, engine, queries: list[str], want: list[dict],
                phase: str) -> None:
    """Details through evaluate_compact: the corpus has fewer flat words
    than COMPACT_MIN_WORDS, so the engine instance's limit is set to 0 (as
    tests/test_device_engine.py does for the JAX engine) and the phase says
    so; one filter below the cap, one above it."""
    from lapis_silo_torch.ops import kernels
    from lapis_silo_torch.query.engine import Query

    engine.COMPACT_MIN_WORDS = 0
    n_cards = len(engine.shards.distinct)
    for query, expected in zip(queries, want):
        flt = Query(query).filter
        nonzero = sum(int(np.count_nonzero(w)) for w in engine.evaluate(flt))
        t0 = time.perf_counter()
        got = fused_launches(kernels, phase, n_cards,
                             lambda: db.execute_query(query))
        ms = (time.perf_counter() - t0) * 1e3
        assert got == expected, query
        log(phase, f"Details through evaluate_compact (COMPACT_MIN_WORDS set "
            f"to 0 on this engine: {engine.n_flat_words} flat words) equals "
            f"the host oracle; {nonzero} non-zero words, "
            f"{'under' if nonzero <= engine.COMPACT_CAP_WORDS else 'over'} "
            f"the cap of {engine.COMPACT_CAP_WORDS}; one VM launch per card "
            f"({n_cards}) wrote the filter and its compact blocks, no K10; "
            f"{ms:.2f} ms")


def compact_kernels(engine, kernels, torch, db, err: dict, timings: dict,
                    label: str) -> dict:
    """On the engine's shapes: K10 (compact_nonzero_sharded) and K11
    (popcount_words_sharded), each one launch per card over the shards,
    against their plain versions on the words of the two Details filters
    (under and over the cap) and on synthetic words of the engine's shard
    widths at its shards' offsets, with 0, 1, cap - 1, cap, cap + 1 and
    5 cap non-zero words a shard (every word where the shard is narrower);
    evaluate_compact against evaluate() below and above the cap; on the
    filter under the cap, K10's and K11's times on the card beside their
    plain versions' (the torch-op chains the engine ran before) and their
    bounds, and evaluate_compact's wall per call against evaluate()'s.
    Returns the readings; the first engine's go into `timings`."""
    from lapis_silo_torch.query.engine import Query

    engine.COMPACT_MIN_WORDS = 0
    cap = engine.COMPACT_CAP_WORDS
    offsets = engine.shards.offsets
    local = engine.shards.local_words
    n_cards = len(engine.shards.distinct)
    below, above = (Query(q).filter for q in details_queries(db))
    for flt in (below, above):
        for got, want in zip(engine.evaluate_compact(flt),
                             engine.evaluate(flt)):
            assert np.array_equal(got, want), label
    rng = np.random.default_rng(10)
    cases = {"under the cap": engine.evaluate_device(below),
             "over the cap": engine.evaluate_device(above)}
    for fill in (0, 1, cap - 1, cap, cap + 1, 5 * cap):
        parts = []
        for device in engine.shards.devices:
            host = np.zeros(local, dtype=np.uint32)
            hot = rng.choice(local, size=min(fill, local), replace=False)
            host[hot] = rng.integers(1, 1 << 32, size=hot.size,
                                     dtype=np.uint64).astype(np.uint32)
            parts.append(torch.from_numpy(host.view(np.int32)).to(device))
        cases[f"{fill} a shard"] = parts
    for words in cases.values():
        k10 = kernels.COMPACT_NONZERO.launches
        k11 = kernels.POPCOUNT_WORDS.launches
        got = kernels.compact_nonzero_sharded(words, offsets, cap)
        total = kernels.popcount_words_sharded(words)
        assert kernels.COMPACT_NONZERO.launches - k10 == n_cards, label
        assert kernels.POPCOUNT_WORDS.launches - k11 == n_cards, label
        want = kernels.compact_nonzero_sharded_plain(words, offsets, cap)
        err["compact_nonzero"] = max(err["compact_nonzero"], *(
            max_abs_err(g, w) for g, w in zip(got, want)))
        err["popcount_words"] = max(err["popcount_words"], abs(
            int(total) - int(kernels.popcount_words_sharded_plain(words))))
    # the VM launch with the filter's epilogue, as the routes run it, on
    # the two Details filters' programs: its words and counts equal the
    # VM's alone, its total and blocks the plain versions' on its words
    vm_key = "vm_run" if len(engine.shards) == 1 else "vm_run_sharded"
    programs = {}
    for name, flt in (("under the cap", below), ("over the cap", above)):
        inputs = engine.kernel_inputs(engine._prepare_program(
            engine.lower(flt)[0]))
        programs[name] = inputs
        out = kernels.vm_filter_sharded(*inputs[:-1], offsets=offsets,
                                        cap=cap)
        vm_words, vm_counts = kernels.vm_run_sharded(*inputs)
        err[vm_key] = max(
            err[vm_key], *map(max_abs_err, out.words, vm_words),
            max_abs_err(out.counts, vm_counts),
            abs(int(out.total) - int(kernels.popcount_words_sharded_plain(
                out.words))),
            *(max_abs_err(g, w) for g, w in zip(
                out.blocks, kernels.compact_nonzero_sharded_plain(
                    out.words, offsets, cap))))
    inputs = programs["under the cap"]
    fused = {
        "vm_ms": cuda_ms(lambda: kernels.vm_run_sharded(*inputs), reps=50),
        "vm_total_ms": cuda_ms(
            lambda: kernels.vm_filter_sharded(*inputs[:-1]), reps=50),
        "vm_and_k11_ms": cuda_ms(lambda: kernels.popcount_words_sharded(
            kernels.vm_run_sharded(*inputs)[0]), reps=50),
        "vm_compact_ms": cuda_ms(lambda: kernels.vm_filter_sharded(
            *inputs[:-1], offsets=offsets, cap=cap), reps=50),
        "vm_and_k10_ms": cuda_ms(lambda: kernels.compact_nonzero_sharded(
            kernels.vm_run_sharded(*inputs)[0], offsets, cap), reps=50)}
    words = cases["under the cap"]
    pw, n_shards = engine.n_flat_words, len(engine.shards)
    k10 = (cuda_ms(lambda: kernels.compact_nonzero_sharded(words, offsets,
                                                           cap), reps=50),
           cuda_ms(lambda: kernels.compact_nonzero_sharded_plain(
               words, offsets, cap), reps=20),
           4 * pw + 4 * (1 + 2 * cap) * n_shards, 2 * pw, n_cards)
    k11 = (cuda_ms(lambda: kernels.popcount_words_sharded(words), reps=50),
           cuda_ms(lambda: kernels.popcount_words_sharded_plain(words),
                   reps=20),
           4 * pw + 8 * n_cards, 2 * pw, n_cards)
    timings.setdefault("compact_nonzero", k10)
    timings.setdefault("popcount_words", k11)
    compact_wall = wall_ms(lambda: engine.evaluate_compact(below), reps=10)
    full_wall = wall_ms(lambda: engine.evaluate(below), reps=10)
    overflow_wall = wall_ms(lambda: engine.evaluate_compact(above), reps=5)
    sweep = compact_sweep(engine, kernels, torch) if label == "5" else None
    log(f"{label} compact", f"K10 and K11 bit-exact against their plain "
        f"versions ({', '.join(cases)}), one launch per card ({n_cards}); "
        f"evaluate_compact equals evaluate() below and above the cap ({cap}) "
        f"on {n_shards} shard(s) of {local} words; under the cap, on the "
        f"card: K10 {k10[0]:.4f} ms (plain {k10[1]:.4f} ms, bound "
        f"{bound(*k10[2:])[0]:.5f} ms), K11 {k11[0]:.4f} ms (plain "
        f"{k11[1]:.4f} ms, bound {bound(*k11[2:])[0]:.5f} ms); per call "
        f"{compact_wall:.4f} ms against {full_wall:.4f} ms for evaluate() "
        f"(overflow {overflow_wall:.4f} ms); the filter's VM launch on the "
        f"card, ms: alone {fused['vm_ms']:.4f}, with its total "
        f"{fused['vm_total_ms']:.4f} (then K11: {fused['vm_and_k11_ms']:.4f}),"
        f" with its total and compact blocks {fused['vm_compact_ms']:.4f} "
        f"(then K10: {fused['vm_and_k10_ms']:.4f}); its words, counts, "
        f"total and blocks bit-exact; {nvidia_smi()}")
    return {"fused": fused, "k10_ms": k10[0], "k10_plain_ms": k10[1],
            "k10_bound_ms": bound(*k10[2:])[0], "k11_ms": k11[0],
            "k11_plain_ms": k11[1], "k11_bound_ms": bound(*k11[2:])[0],
            "wall": compact_wall, "evaluate_wall": full_wall,
            "overflow_wall": overflow_wall, "words": pw, "sweep": sweep}


def group_work(engine, n_set: int, n_bins: int, code_bytes: int) -> tuple:
    """(bytes, operations, cards) of a K9 launch over the engine's shards:
    the words read once, the code of each of the `n_set` set bits read once
    at `code_bytes`, one [P, G] written per card; a test per word and a bin
    per set bit."""
    n_cards = len(engine.shards.distinct)
    return (4 * engine.n_flat_words + code_bytes * n_set
            + 4 * engine.n_partitions * n_bins * n_cards,
            engine.n_flat_words + n_set, n_cards)


def groupby_kernels(engine, kernels, torch, db, err: dict, timings: dict,
                    label: str) -> dict:
    """On the engine's shapes: K9 (group_counts_sharded, one launch per
    card over the shards' words and codes) against its plain version for
    every column list of GROUP_BYS over every sequence, each list's codes
    held as uint8 (one byte per sequence slot); by date its time on the card
    and the plain version's over every sequence, over the 6% Details filter
    and over the one-mutation filter (the kernel's work follows the set
    bits), each with its bound from 1-byte codes and at int32 codes; then
    the split of one group-by query (by date over every sequence):
    db.execute_query's p50, evaluate_device, K9 (the cards' sum inside),
    the copy to the host, the host's ordering and decoding (group_rows), and
    the rest (parse, lowering, the action's rows and JSON). Returns the
    readings."""
    from lapis_silo_torch.ops import reductions
    from lapis_silo_torch.ops.device_engine import group_rows
    from lapis_silo_torch.query.engine import Query

    offsets = engine.shards.offsets
    for columns in GROUP_BYS:
        codes_on, n_groups, _ = engine.group_codes_for(columns)
        assert {c.dtype for c in codes_on} == {torch.uint8}, columns
        n_bins = next(b for b in engine._GROUP_BUCKETS if b >= n_groups) + 1
        args = (engine.fulls, codes_on, offsets, engine.n_words,
                engine.n_partitions, n_bins)
        err["group_counts"] = max(err["group_counts"], max_abs_err(
            kernels.group_counts_sharded(*args),
            kernels.group_counts_sharded_plain(*args)))
    codes_on, n_groups, decode = engine.group_codes_for(["date"])
    n_bins = next(b for b in engine._GROUP_BUCKETS if b >= n_groups) + 1
    filters = {"every sequence": {"type": "True"},
               "6% Details filter": json.loads(
                   details_queries(db)[1])["filterExpression"],
               "one mutation": json.loads(
                   mutations_queries(db)[0])["filterExpression"]}
    readings = {}
    for name, expr in filters.items():
        words = engine.evaluate_device(Query(json.dumps({
            "action": {"type": "Aggregated"}, "filterExpression": expr}))
            .filter)
        n_set = sum(int(reductions.popcount_words(w)) for w in words)
        args = (words, codes_on, offsets, engine.n_words, engine.n_partitions,
                n_bins)
        err["group_counts"] = max(err["group_counts"], max_abs_err(
            kernels.group_counts_sharded(*args),
            kernels.group_counts_sharded_plain(*args)))
        reading = (
            cuda_ms(lambda: kernels.group_counts_sharded(*args), reps=50),
            cuda_ms(lambda: kernels.group_counts_sharded_plain(*args),
                    reps=2, warmup=1),
            *group_work(engine, n_set, n_bins, 1))
        readings[name] = {
            "set_bits": n_set, "ms": reading[0], "plain_ms": reading[1],
            "wall_ms": wall_ms(lambda: kernels.group_counts_sharded(*args),
                               reps=50),
            "bound_ms": bound(*reading[2:])[0],
            "bound_int32_ms": bound(*group_work(engine, n_set, n_bins, 4))[0]}
        if name == "every sequence":
            # the kernels line reports the first (one-card, one-shard) one
            timings.setdefault("group_counts", reading)
    query = groupby_queries(db)[0]  # by date, every sequence
    want = oracle(db, [query])[0]
    totals = []
    for _ in range(20):
        t0 = time.perf_counter()
        assert db.execute_query(query) == want
        totals.append((time.perf_counter() - t0) * 1e3)
    flt = Query(query).filter
    words = engine.evaluate_device(flt)
    args = (words, codes_on, offsets, engine.n_words, engine.n_partitions,
            n_bins)
    counts = kernels.group_counts_sharded(*args)
    per_part = counts.cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(100):
        group_rows(per_part, n_groups, decode)
    split = {"execute_query_p50": statistics.median(totals),
             "evaluate_device": wall_ms(lambda: engine.evaluate_device(flt),
                                        reps=20),
             "k9": wall_ms(lambda: kernels.group_counts_sharded(*args),
                           reps=20),
             "copy_to_host": wall_ms(lambda: counts.cpu(), reps=20),
             "order_and_decode": (time.perf_counter() - t0) * 10}
    split["rest"] = split["execute_query_p50"] - sum(
        v for k, v in split.items() if k != "execute_query_p50")
    readings["split"] = split
    n_cards = len(engine.shards.distinct)
    log(f"{label} group_counts", f"K9 bit-exact for {len(GROUP_BYS)} column "
        f"lists (uint8 codes, 1 byte per sequence slot) on "
        f"{len(engine.shards)} shard(s), {n_cards} card(s), one launch per "
        f"card; by date (G {n_bins}): " + "; ".join(
            f"{name} ({r['set_bits']} set bits): kernel {r['ms']:.4f} ms "
            f"on the card, {r['wall_ms']:.4f} ms wall per call, plain "
            f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.5f} ms (at "
            f"int32 codes {r['bound_int32_ms']:.5f} ms)"
            for name, r in readings.items() if name != "split"))
    log(f"{label} group-by split", f"by date over every sequence, ms: p50 "
        f"of db.execute_query {split['execute_query_p50']:.4f}; "
        f"evaluate_device {split['evaluate_device']:.4f} wall; K9 "
        f"{split['k9']:.4f} wall (the cards' sum inside); copy to the host "
        f"{split['copy_to_host']:.4f}; ordering and decoding "
        f"{split['order_and_decode']:.4f}; the rest (parse, lowering, rows "
        f"to JSON) {split['rest']:.4f}")
    return readings


def compact_bound(n_words: int, cap: int, n_shards: int = 1) -> tuple:
    """(bound_ms, bound_by) of the compaction of `n_words` flat words over
    `n_shards` shards on one card: each word read once, each shard's block
    of 1 + 2 `cap` int32 written once; a compare and a prefix-sum add per
    word."""
    return bound(4 * n_words + 4 * (1 + 2 * cap) * n_shards, 2 * n_words)


# flat word counts of the compaction sweep: COMPACT_MIN_WORDS (the JAX
# engine's and the port's), the 10,000,000 x 32-partition corpus' flat
# axis, and two larger corpora
SWEEP_WORDS = (131072, 312512, 1048576, 4194304)


def compact_sweep(engine, kernels, torch) -> dict:
    """evaluate()'s bitset copy against the extraction through K10 (off
    the main path, whose VM launch writes the blocks itself; one copy of
    the blocks into pinned memory, the host's rebuild) as whole calls (wall
    time per call, the host's rebuild included) on synthetic flat words on
    the card at SWEEP_WORDS, 400 non-zero words (a selective filter) and
    COMPACT_CAP_WORDS of them (the most the extraction takes); no VM
    launch runs before them. Each
    extraction is checked against the copy. Beside them: K10's card time
    against the torch-op chain it replaced (reductions.compact_nonzero) and
    its bound, K11's against the popcount chain and the words' bytes over
    the HBM rate, and the host's rebuild alone (np.zeros, the scatter and
    the split into partitions). Returns the times and the swept word counts
    at which the extraction is faster at both fills."""
    from lapis_silo_torch.ops import reductions
    from lapis_silo_torch.ops.device_engine import (
        blocks_to_host, rebuild_from_blocks)
    from lapis_silo_torch.ops.words import to_host
    from lapis_silo_torch.parallel.shards import gather_words

    device, cap = engine.device, engine.COMPACT_CAP_WORDS
    rng = np.random.default_rng(5)
    rows = []
    for n in SWEEP_WORDS:
        for n_hot in (400, cap):
            host = np.zeros(n, dtype=np.uint32)
            host[rng.choice(n, size=n_hot, replace=False)] = rng.integers(
                1, 1 << 32, size=n_hot, dtype=np.uint64).astype(np.uint32)
            words = torch.from_numpy(host.view(np.int32)).to(device)
            copy = lambda: to_host(gather_words([words], "cpu"))  # noqa: E731
            extract = lambda: blocks_to_host(  # noqa: E731
                kernels.compact_nonzero_sharded([words], [0], cap), cap, n)
            assert np.array_equal(extract(), host) and np.array_equal(
                copy(), host)
            # copy, extract, extract, copy, twice: the median of each four
            times = {copy: [], extract: []}
            for fn in (copy, extract, extract, copy) * 2:
                times[fn].append(wall_ms(fn, reps=20, warmup=3))
            packed = kernels.compact_nonzero(words, cap).cpu().numpy()[None]
            t0 = time.perf_counter()
            for _ in range(20):
                rebuilt = rebuild_from_blocks(packed, cap, n)
                [part[:-1] for part in rebuilt.reshape(4, -1)]
            rebuild_ms = (time.perf_counter() - t0) * 1e3 / 20
            rows.append({
                "words": n, "nonzero": n_hot,
                "evaluate_ms": statistics.median(times[copy]),
                "compact_ms": statistics.median(times[extract]),
                "rebuild_ms": rebuild_ms,
                "k10_card_ms": cuda_ms(
                    lambda: kernels.compact_nonzero(words, cap), reps=20),
                "chain_card_ms": cuda_ms(
                    lambda: reductions.compact_nonzero(words, cap, 0),
                    reps=20),
                "k10_bound_ms": compact_bound(n, cap)[0],
                "k11_card_ms": cuda_ms(
                    lambda: kernels.popcount_words(words), reps=20),
                "popcount_chain_card_ms": cuda_ms(
                    lambda: reductions.popcount_words(words), reps=20),
                "k11_bound_ms": 4 * n / HBM_BYTES_PER_S * 1e3})
            del words
    wins = [n for n in SWEEP_WORDS
            if all(r["compact_ms"] < r["evaluate_ms"] for r in rows
                   if r["words"] == n)]
    log("5 compact sweep", "whole-call ms (median of 4 alternating "
        "readings), bitset copy (evaluate) against extraction "
        "through K10, per flat words/non-zero words: "
        + "; ".join(f"{r['words']}/{r['nonzero']}: {r['evaluate_ms']:.4f} vs "
                    f"{r['compact_ms']:.4f} (host rebuild "
                    f"{r['rebuild_ms']:.4f}; K10 {r['k10_card_ms']:.4f} on "
                    f"the card, chain {r['chain_card_ms']:.4f}, bound "
                    f"{r['k10_bound_ms']:.5f}; K11 {r['k11_card_ms']:.4f}, "
                    f"chain {r['popcount_chain_card_ms']:.4f}, bound "
                    f"{r['k11_bound_ms']:.5f})"
                    for r in rows)
        + f"; extraction faster at both fills at {wins} words "
        f"(COMPACT_MIN_WORDS {type(engine).COMPACT_MIN_WORDS})")
    return {"rows": rows, "extraction_wins": wins}


def run_counts(db, queries: list[str], want: list[dict], phase: str) -> None:
    """(a): one at a time (latency), then from a thread pool (coalesced)."""
    latencies = []
    for query, expected in zip(queries, want):
        t0 = time.perf_counter()
        got = db.execute_query(query)
        latencies.append(time.perf_counter() - t0)
        assert got == expected, (query, got, expected)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        got = list(pool.map(db.execute_query, queries))
    wall = time.perf_counter() - t0
    assert got == want
    log(phase, f"{len(queries)} counts equal the host oracle; one at a time "
        f"p50 {statistics.median(latencies) * 1e3:.3f} ms, max "
        f"{max(latencies) * 1e3:.3f} ms; from 16 threads {wall * 1e3:.1f} ms "
        f"wall ({len(queries) / wall:.0f} queries/s)")


def run_mutations(db, queries: list[str], want: list[dict], phase: str) -> None:
    """Each Mutations query against the oracle's answer, its filter and the
    filter's total from one VM launch per card of the engine (no K11)."""
    from lapis_silo_torch.ops import kernels

    n_cards = len(db.device_engine.shards.distinct)
    for query, expected in zip(queries, want):
        t0 = time.perf_counter()
        got = fused_launches(kernels, phase, n_cards,
                             lambda: db.execute_query(query))
        ms = (time.perf_counter() - t0) * 1e3
        assert got == expected, query
        log(phase, f"Mutations ({len(got['queryResult'])} rows) equals the "
            f"host oracle; one VM launch per card ({n_cards}) wrote the "
            f"filter and its total, no K11; {ms:.2f} ms")


def run_count_calls(db, engine, queries: list[str], phase: str) -> None:
    """DeviceEngine.count_async (what count runs where the host cannot
    answer) of each query's filter against the host oracle's Aggregated
    count, each from one VM launch per card and no K11."""
    from lapis_silo_torch.ops import kernels
    from lapis_silo_torch.query.engine import Query

    n_cards = len(engine.shards.distinct)
    bodies = [json.dumps({"action": {"type": "Aggregated"},
                          "filterExpression": json.loads(q)[
                              "filterExpression"]}) for q in queries]
    want = [w["queryResult"][0]["count"] for w in oracle(db, bodies)]
    got = [int(fused_launches(
        kernels, phase, n_cards,
        lambda: engine.count_async(Query(body).filter))) for body in bodies]
    assert got == want, (got, want)
    log(phase, f"{len(bodies)} counts through DeviceEngine.count_async equal "
        f"the host oracle ({got}); one VM launch per card ({n_cards}) each, "
        f"no K11")


def random_stream(rng, n_leaves: int, n_parts: int, part_words: int,
                  max_len: int):
    """A partition-major CSR stream as the engine builds it: segment (leaf,
    p) holds sorted unique global word indices inside partition p's window;
    every 7th segment is empty. Returns (idx, words, starts, lens) arrays."""
    lens = np.minimum(rng.integers(0, max_len + 1, size=(n_leaves, n_parts)),
                      part_words)
    lens.reshape(-1)[::7] = 0
    starts = np.zeros((n_leaves, n_parts), dtype=np.int64)
    idx, words, pos = [], [], 0
    for part in range(n_parts):
        for leaf in range(n_leaves):
            n = int(lens[leaf, part])
            starts[leaf, part] = pos
            idx.append(np.sort(rng.choice(part_words, size=n, replace=False))
                       + part * part_words)
            words.append(rng.integers(1, 1 << 32, size=n, dtype=np.uint32))
            pos += n
    return (np.concatenate(idx).astype(np.int32), np.concatenate(words),
            starts.astype(np.int32), lens.astype(np.int32))


def phase3_random(kernels, vm, torch, device) -> dict[str, int]:
    """Every kernel against its plain version on random inputs: for the VM
    every mode and b-source, n_regs 4/8/16/32, clamped operands, the NOP
    tail, out-of-range and repeated EMITs, PW 2,048 and ragged PWs, each
    program as one segment and cut into random segments (empty ones and
    segments of one instruction included), also over 4 word shards and 3
    of ragged widths (K6); for the
    Mutations kernel unaligned segments; for the sparse kernels empty
    segments, ragged PWs, K = 1, K = 1,024 (the two-tier poolless cap), a
    4,096-leaf pool update, with pool slots including the scratch row, and
    densify's tile edges (segments longer than a tile, windows that start
    mid-partition and at an odd offset, a leaf inside one tile).
    Returns the largest error per kernel."""
    rng = np.random.default_rng(0)
    err = {k.name: 0 for k in kernels.KERNELS}

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)

    for n_regs in (4, 8, 16, 32):
        for pw in (2048, 2045):
            bank = rng.integers(0, 1 << 32, size=(64, pw), dtype=np.uint32)
            dyn = rng.integers(0, 1 << 32, size=(3, pw), dtype=np.uint32)
            sparse = rng.integers(0, 1 << 32, size=(2, pw), dtype=np.uint32)
            full = np.full(pw, 0xFFFFFFFF, dtype=np.uint32)
            full[-1] = 0x1F
            n = 301  # rounded up to 304: a NOP tail
            opcodes = rng.choice([vm.ALU] * 6 + [vm.EMIT_COUNT, vm.NOP], size=n)
            operands = rng.integers(-4, 70, size=n)
            emits = opcodes == vm.EMIT_COUNT
            operands[emits] = rng.choice([0, 1, 2, 3, 4095, 4096, -1, -5000],
                                         size=int(emits.sum()))
            regspec = (rng.integers(0, 64, size=n)
                       | (rng.integers(0, 64, size=n) << 8)
                       | (rng.integers(0, 64, size=n) << 16)
                       | (rng.integers(0, 16, size=n) << 24)
                       | (rng.integers(0, 16, size=n) << 28))
            code = vm.pack_code_array(512, opcodes, operands, regspec)
            n_instr = vm._round_instr(n)
            # random cuts, an empty segment and one of one instruction
            cuts = np.sort(np.concatenate([
                rng.integers(0, n_instr + 1, size=n_regs * 2), [5, 5, 6]]))
            for segments in (None, np.concatenate([[0], cuts, [n_instr]])):
                args = (torch.from_numpy(code), n_instr, dev(bank), dev(dyn), dev(sparse),
                        dev(full), n_regs, segments)
                got = kernels.vm_run(*args)
                want = kernels.vm_run_plain(*args)
                for g, w in zip(got, want):
                    err["vm_run"] = max(err["vm_run"], max_abs_err(g, w))
                # the same program over 4 word shards of one card (where
                # PW splits evenly) and over 3 of ragged widths round-robin
                # on the visible cards: K6 once per card
                n_cards = torch.cuda.device_count()
                for n_shards, cards in (
                        ((4, [device] * 4),) if pw % 4 == 0 else ()) + (
                        (3, [torch.device(DEVICE, d % n_cards)
                             for d in range(3)]),):
                    shards = (*args[:2], *([
                        torch.from_numpy(np.ascontiguousarray(part).view(
                            np.int32)).to(card)
                        for part, card in zip(np.array_split(
                            a, n_shards, axis=-1), cards)]
                        for a in (bank, dyn, sparse, full)), n_regs, segments)
                    (got_words, got_counts), (want_words, want_counts) = (
                        kernels.vm_run_sharded(*shards),
                        kernels.vm_run_sharded_plain(*shards))
                    err["vm_run_sharded"] = max(
                        err["vm_run_sharded"],
                        max_abs_err(got_counts, want_counts),
                        *map(max_abs_err, got_words, want_words))
    for pw, start, n_rows in ((2048, 3, 1000), (2045, 1, 999), (77, 0, 1003)):
        bank = dev(rng.integers(0, 1 << 32, size=(1003, pw), dtype=np.uint32))
        filt = dev(rng.integers(0, 1 << 32, size=pw, dtype=np.uint32))
        n_rows = min(n_rows, 1003 - start)
        got = kernels.mutation_counts(bank, filt, start, n_rows)
        want = kernels.mutation_counts_plain(bank, filt, start, n_rows)
        err["mutation_counts"] = max(err["mutation_counts"],
                                     max_abs_err(got, want))
    # the last two are densify's tile edges: segments longer than a tile of
    # 4,096 words, a PW that is no multiple of the tile or of 4; and all of
    # a leaf's entries in one tile
    for n_leaves, n_parts, part_words, n_pool, max_len in (
            (1, 1, 131, 1, 300), (37, 3, 2045, 37, 300),
            (1024, 8, 64, 1500, 12), (4096, 8, 16, 4096, 12),
            (9, 3, 10007, 11, 9000), (64, 1, 4000, 70, 3000)):
        idx, words, starts, lens = (dev(a) for a in random_stream(
            rng, n_leaves, n_parts, part_words, max_len))
        pw = n_parts * part_words
        filt = dev(rng.integers(0, 1 << 32, size=pw, dtype=np.uint32))
        err["sparse_counts"] = max(err["sparse_counts"], max_abs_err(
            kernels.sparse_counts(idx, words, filt, starts, lens),
            kernels.sparse_counts_plain(idx, words, filt, starts, lens)))
        # the whole row, the windows of 3 word shards (their edges fall
        # inside partitions), and one at an odd offset
        for window, w_off in ((pw, 0), *((pw // 3, d * (pw // 3))
                                         for d in range(3)),
                              (pw // 2, pw // 3 + 1)):
            err["densify_rows"] = max(err["densify_rows"], max_abs_err(
                kernels.densify_rows(idx, words, starts, lens, window, w_off),
                kernels.densify_rows_plain(idx, words, starts, lens, window,
                                           w_off)))
        # pool rows [0, n_pool] full of old words; slots: the scratch row
        # n_pool first, then distinct others
        pool = dev(rng.integers(0, 1 << 32, size=(n_pool + 1, pw),
                                dtype=np.uint32))
        slots = np.concatenate([[n_pool], rng.permutation(n_pool)[
            : n_leaves - 1]]).tolist()
        want = pool.clone()
        kernels.densify_rows_into_pool(pool, idx, words, starts, lens, slots)
        kernels.densify_rows_into_pool_plain(want, idx, words, starts, lens,
                                             slots)
        err["densify_rows_into_pool"] = max(err["densify_rows_into_pool"],
                                            max_abs_err(pool, want))
        window = pw // 3  # the pool shard of the middle one of 3 shards
        pool = pool[:, :window].contiguous()
        want = pool.clone()
        kernels.densify_rows_into_pool(pool, idx, words, starts, lens, slots,
                                       window)
        kernels.densify_rows_into_pool_plain(want, idx, words, starts, lens,
                                             slots, window)
        err["densify_rows_into_pool"] = max(err["densify_rows_into_pool"],
                                            max_abs_err(pool, want))
    # K9 for every code type at every bucket edge (its ticket, flush and
    # device-memory forms), with padding and negative codes, words all set
    # and all clear, runs of one code, word counts that are no multiple of
    # a CTA's block: on one shard, on the windows of 3 shards across
    # partition edges (a launch each), and through group_counts_sharded on
    # 3 of ragged widths round-robin on the visible cards and on 4 of one
    # card (a launch per card)
    n_cards = torch.cuda.device_count()
    for dtype in kernels.CODE_DTYPES:
        info = torch.iinfo(dtype)
        for n_groups in (65, 1025, 16385, (1 << 20) + 1):
            for n_parts, part_words in ((1, 1), (3, 1111), (4, 8192)):
                pw = n_parts * part_words
                words = rng.integers(0, 1 << 32, size=pw, dtype=np.uint32)
                words[: pw // 7] = 0xFFFFFFFF
                words[pw // 7: pw // 5] = 0
                codes = rng.integers(max(info.min, -1),
                                     min(info.max, n_groups) + 1, size=32 * pw)
                codes[: 32 * (pw // 9)] = rng.integers(0, 3)
                codes = torch.from_numpy(codes).to(dtype)
                for n_shards in (1, 3):
                    local = pw // n_shards
                    for d in range(n_shards):
                        args = (dev(words[d * local:(d + 1) * local]),
                                codes[32 * d * local:32 * (d + 1) * local
                                      ].to(device),
                                d * local, part_words, n_parts, n_groups)
                        err["group_counts"] = max(
                            err["group_counts"], max_abs_err(
                                kernels.group_counts(*args),
                                kernels.group_counts_plain(*args)))
                for bounds, cards in (
                        ([0, pw // 5, pw // 5 + pw // 3 + 1, pw],
                         [torch.device(DEVICE, d % n_cards) for d in range(3)]),
                        (np.linspace(0, pw, 5).astype(int), [device] * 4)):
                    if np.diff(bounds).min() < 1:
                        continue
                    edges = list(zip(bounds, bounds[1:]))
                    args = ([dev(words[a:b]).to(card)
                             for (a, b), card in zip(edges, cards)],
                            [codes[32 * a:32 * b].to(card)
                             for (a, b), card in zip(edges, cards)],
                            [int(a) for a, _ in edges], part_words, n_parts,
                            n_groups)
                    err["group_counts"] = max(err["group_counts"], max_abs_err(
                        kernels.group_counts_sharded(*args),
                        kernels.group_counts_sharded_plain(*args)))
    # K10 and K11 at tile edges: shards just under and past whole tiles of
    # 4,096 words, views starting 0-3 words into a 16-byte quad, empty
    # shards, every fill around the cap, on one card and round-robin on the
    # visible cards (a launch per card)
    tile = 4 * kernels.COMPACT_TILE_QUADS
    for widths, head, cap in (([tile - 1, 0, 2 * tile + 3, 5], 3, 2),
                              ([tile + 1, tile - 2, 1], 1, 3),
                              ([3 * tile - 1], 2, 40),
                              ([7, tile, 0, tile + 7], 0, 16384)):
        for fill in (0, 1, cap - 1, cap, cap + 1, 5 * cap):
            for cards in ([device] * len(widths),
                          [torch.device(DEVICE, d % n_cards)
                           for d in range(len(widths))]):
                parts = []
                for n, card in zip(widths, cards):
                    host = np.zeros(n + head, dtype=np.uint32)
                    hot = head + rng.choice(n, size=min(fill, n),
                                            replace=False)
                    host[hot] = rng.integers(1, 1 << 32, size=hot.size,
                                             dtype=np.uint64).astype(np.uint32)
                    parts.append(torch.from_numpy(host.view(np.int32)).to(
                        card)[head:])
                offsets = [1000 + sum(widths[:d]) for d in range(len(widths))]
                k10 = kernels.COMPACT_NONZERO.launches
                k11 = kernels.POPCOUNT_WORDS.launches
                got = kernels.compact_nonzero_sharded(parts, offsets, cap)
                total = kernels.popcount_words_sharded(parts)
                assert (kernels.COMPACT_NONZERO.launches - k10,
                        kernels.POPCOUNT_WORDS.launches - k11) == (
                            len(set(cards)),) * 2
                want = kernels.compact_nonzero_sharded_plain(parts, offsets,
                                                             cap)
                err["compact_nonzero"] = max(err["compact_nonzero"], *(
                    max_abs_err(g, w) for g, w in zip(got, want)))
                err["popcount_words"] = max(err["popcount_words"], abs(
                    int(total)
                    - int(kernels.popcount_words_sharded_plain(parts))))
    fused_random(kernels, vm, torch, device, rng, err)
    torch.cuda.synchronize()
    return err


def fused_random(kernels, vm, torch, device, rng, err: dict) -> None:
    """The VM with the filter's epilogue (vm_filter_sharded) on random single
    programs: one shard (K1: its narrow and wide forms for the total, the
    wide form compacting), 4 shards of one card (K6 narrow for the total,
    wide with 16-byte runs compacting; and 4 wide ones for the total) and 3
    of ragged widths round-robin on the visible cards (K6 wide, word runs);
    caps under and over the fill; words, counts, total and blocks against
    its plain version, and its total and blocks against K11 and K10 on its
    words. The largest errors go into `err` under vm_run and
    vm_run_sharded."""
    n_cards = torch.cuda.device_count()
    for splits, cards in (([2045], [device]), ([70000], [device]),
                          ([8192] * 4, [device] * 4),
                          ([180000] * 4, [device] * 4),
                          ([3000, 1, 6000],
                           [torch.device(DEVICE, d % n_cards)
                            for d in range(3)])):
        pw = sum(splits)
        bank = rng.integers(0, 1 << 32, size=(16, pw), dtype=np.uint32)
        bank[:, rng.random(pw) < 0.9] = 0
        full = np.full(pw, 0xFFFFFFFF, dtype=np.uint32)
        full[-1] = 0x1F
        edges = np.cumsum([0] + splits)
        on = [[torch.from_numpy(np.ascontiguousarray(
            a[..., lo:hi]).view(np.int32)).to(card)
            for lo, hi, card in zip(edges, edges[1:], cards)]
            for a in (bank, bank[:3], bank[:2], full)]
        offsets = [int(lo) for lo in edges[:-1]]
        key = "vm_run" if len(splits) == 1 else "vm_run_sharded"
        for n in (5, 301):
            opcodes = rng.choice([vm.ALU] * 6 + [vm.EMIT_COUNT, vm.NOP],
                                 size=n)
            operands = rng.integers(-4, 20, size=n)
            emits = opcodes == vm.EMIT_COUNT
            operands[emits] = rng.choice([0, 1, 4095, 4096, -1],
                                         size=int(emits.sum()))
            regspec = (rng.integers(0, 8, size=n)
                       | (rng.integers(0, 8, size=n) << 8)
                       | (rng.integers(0, 8, size=n) << 16)
                       | (rng.integers(0, 5, size=n) << 24)
                       | (rng.integers(0, 6, size=n) << 28))
            args = (torch.from_numpy(vm.pack_code_array(
                512, opcodes, operands, regspec)), vm._round_instr(n), *on, 8)
            for cap in ((None,) if splits[0] == 180000 else
                        (None, 2, 400, 16384)):
                kw = {} if cap is None else {"offsets": offsets, "cap": cap}
                got = kernels.vm_filter_sharded(*args, **kw)
                want = kernels.vm_filter_sharded_plain(*args, **kw)
                err[key] = max(
                    err[key], *map(max_abs_err, got.words, want.words),
                    max_abs_err(got.counts, want.counts),
                    abs(int(got.total) - int(want.total)),
                    abs(int(got.total) - int(kernels.popcount_words_sharded(
                        got.words))))
                if cap is None:
                    continue
                for g, w, k in zip(got.blocks, want.blocks,
                                   kernels.compact_nonzero_sharded(
                                       got.words, offsets, cap)):
                    err[key] = max(err[key], max_abs_err(g, w),
                                   max_abs_err(g, k))


def two_tier_kernels(engine, kernels, torch, err: dict, label: str) -> dict:
    """The sparse kernels at a two-tier engine's shapes, per word shard
    (one on one device), against their plain versions, with both times:
    sparse_counts over every entry chunk of the stream (the chunked launch
    against the sum of the chunks' plain results), densify_rows for
    max_sparse_k leaves into each shard's window, densify_rows_into_pool for
    one _pool_update_k_cap chunk into each shard's window of a pool-sized
    block (the engine's own pool is left alone). The densify inputs lie on
    the card (bounds and slots uploaded once per device, as the engine
    does), so the queued time is the kernels' device time; the wall time per
    call goes through the engine's route (_densified, and _update_pools,
    the body of _eager_update_chunks), host checks and uploads included.
    Beside them, zero_() of a block of the same [K, PW/D] shape per shard:
    what this card's write path reaches. The shards on one card run one
    after another; a time covers all of them. Returns {kernel: (ms, plain
    ms, bytes, operations)}, the last two for the bound."""
    from lapis_silo_torch.parallel.shards import reduce_sum

    rng = np.random.default_rng(7)
    shards = engine.shards
    pw = engine.n_flat_words
    timings = {}
    filt = rng.integers(0, 1 << 32, size=pw, dtype=np.uint32).view(np.int32)
    filters = [torch.from_numpy(filt).to(d) for d in shards.devices]
    chunks = engine._sparse_chunks

    def plain_chunked():
        return reduce_sum([kernels.sparse_counts_plain(idx, words, f, *bounds)
                           for (idx, words, *bounds), f in zip(chunks, filters)],
                          shards.devices[0])
    err["sparse_counts"] = max(err["sparse_counts"], max_abs_err(
        kernels.sparse_counts_chunked(chunks, filters), plain_chunked()))
    timings["sparse_counts"] = (
        cuda_ms(lambda: kernels.sparse_counts_chunked(chunks, filters),
                reps=20),
        cuda_ms(plain_chunked, reps=2, warmup=1),
        *stream_work(engine.sparse_starts_pp, engine.sparse_lengths_pp,
                     engine.n_sparse, pw))

    def shard_inputs(bounds, slots=None):
        """Per shard: (idx, words, starts, lens[, slots]) on its device."""
        per_device = {d: kernels.densify_inputs(bounds, slots, d)
                      for d in shards.distinct}
        return [(*engine._stream_on[d], *per_device[d])
                for d in shards.devices]

    def zero_ms(n_rows: int) -> float:
        blocks = [torch.empty((n_rows, shards.local_words), dtype=torch.int32,
                              device=d) for d in shards.devices]
        ms = cuda_ms(lambda: [block.zero_() for block in blocks], reps=20)
        del blocks
        return ms

    rows_ids = rng.choice(engine.n_sparse, size=engine.max_sparse_k,
                          replace=False)
    rows_bounds = engine._bounds(rows_ids)
    rows_args = [(*inputs, shards.local_words, w_off) for inputs, w_off in zip(
        shard_inputs(rows_bounds), shards.offsets)]
    for args in rows_args:
        err["densify_rows"] = max(err["densify_rows"], max_abs_err(
            kernels.densify_rows(*args), kernels.densify_rows_plain(*args)))
    timings["densify_rows"] = (
        cuda_ms(lambda: [kernels.densify_rows(*a) for a in rows_args],
                reps=20),
        cuda_ms(lambda: [kernels.densify_rows_plain(*a) for a in rows_args],
                reps=2, warmup=1),
        *stream_work(*rows_bounds, engine.max_sparse_k * pw))
    # warmed with as many calls as are timed: a call stages its inputs in a
    # pinned block, and the host allocator caches as many as are in flight
    rows_wall = wall_ms(lambda: engine._densified(rows_ids), reps=20,
                        warmup=20)
    rows_zero = zero_ms(engine.max_sparse_k)

    k_cap = min(engine._pool_update_k_cap, engine.pool_slots)
    pool_ids = rng.choice(engine.n_sparse, size=k_cap, replace=False)
    pool_bounds = engine._bounds(pool_ids)
    slots = np.concatenate([[engine.pool_slots], rng.permutation(
        engine.pool_slots)[: k_cap - 1]]).astype(np.int32)
    pools = [torch.randint(-2**31, 2**31 - 1,
                           (engine.pool_slots + 1, shards.local_words),
                           dtype=torch.int32, device=d) for d in shards.devices]
    wants = [pool.clone() for pool in pools]
    pool_args = [(pool, *inputs, w_off) for pool, inputs, w_off
                 in zip(pools, shard_inputs(pool_bounds, slots), shards.offsets)]
    want_args = [(want, *args[1:]) for want, args in zip(wants, pool_args)]
    for args, wargs in zip(pool_args, want_args):
        kernels.densify_rows_into_pool(*args)
        kernels.densify_rows_into_pool_plain(*wargs)
        err["densify_rows_into_pool"] = max(err["densify_rows_into_pool"],
                                            max_abs_err(args[0], wargs[0]))
    timings["densify_rows_into_pool"] = (
        cuda_ms(lambda: [kernels.densify_rows_into_pool(*a)
                         for a in pool_args], reps=10),
        cuda_ms(lambda: [kernels.densify_rows_into_pool_plain(*a)
                         for a in want_args], reps=2, warmup=1),
        *stream_work(*pool_bounds, k_cap * pw, k_cap))
    pool_wall = wall_ms(lambda: engine._update_pools(pools, pool_ids, slots),
                        reps=10, warmup=10)
    # the engine's route wrote the same leaves into the same slots
    for pool, want in zip(pools, wants):
        err["densify_rows_into_pool"] = max(err["densify_rows_into_pool"],
                                            max_abs_err(pool, want))
    del pools, wants, pool_args, want_args
    pool_zero = zero_ms(k_cap)
    n_entries = engine.sparse_idx.shape[0]
    log(f"{label} kernels", f"two-tier shapes on {len(shards)} shard(s) of "
        f"{shards.local_words} words bit-exact, max_abs_err "
        f"{ {k: err[k] for k in timings} }; sparse_counts "
        f"{engine.n_sparse} leaves x {engine.n_partitions} segments over "
        f"{n_entries} entries ({8 * n_entries / 1e9:.3f} GB) in "
        f"{len(chunks)} chunk(s): kernel {timings['sparse_counts'][0]:.4f} ms, "
        f"plain {timings['sparse_counts'][1]:.2f} ms; densify_rows "
        f"{engine.max_sparse_k} leaves into each window: kernel "
        f"{timings['densify_rows'][0]:.4f} ms on the card, "
        f"{rows_wall:.4f} ms wall per _densified call, plain "
        f"{timings['densify_rows'][1]:.2f} ms; densify_rows_into_pool "
        f"{k_cap} leaves into {engine.pool_slots + 1} rows of each window: "
        f"kernel {timings['densify_rows_into_pool'][0]:.4f} ms on the card, "
        f"{pool_wall:.4f} ms wall per update chunk (_update_pools: slots "
        f"checked, bounds and slots uploaded once per card, one launch per "
        f"shard), plain {timings['densify_rows_into_pool'][1]:.2f} ms")
    log(f"{label} yardstick", f"zero_() of [{engine.max_sparse_k}, "
        f"{shards.local_words}] per shard {rows_zero:.4f} ms "
        f"({engine.max_sparse_k * pw * 4 / rows_zero / 1e6:.0f} GB/s), of "
        f"[{k_cap}, {shards.local_words}] per shard {pool_zero:.4f} ms "
        f"({k_cap * pw * 4 / pool_zero / 1e6:.0f} GB/s)")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return timings


def phase7(main: MainPath, kernels, torch, device, err: dict,
           timings: dict, groupby: dict) -> dict:
    """The two-tier deployment: set-up, kernel comparisons at its shapes
    (K9's readings into `groupby`), then the main path against the host
    oracle. Returns the corpus (its engine dropped) and the oracle's
    answers for phase 8b."""
    import lapis_silo_torch
    from lapis_silo_torch.testing import sample_count_queries, synthetic_database

    t0 = time.perf_counter()
    db = synthetic_database(**TWO_TIER)
    t_db = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = lapis_silo_torch.install(db, device)
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    n_dense = sum(m["n_stored"] for m in engine.segment_meta.values())
    n_entries = engine.sparse_idx.shape[0] if engine.n_sparse else 0
    log("7 setup", f"two-tier corpus {TWO_TIER}: built in {t_db:.1f} s, "
        f"engine in {t_engine:.1f} s; n_sparse {engine.n_sparse}, dense rows "
        f"{n_dense} (bank {tuple(engine.banks[0].shape)}), stream {n_entries} "
        f"entries ({8 * n_entries / 1e9:.3f} GB), pool_slots "
        f"{engine.pool_slots} ({(engine.pool_slots + 1) * 4 * engine.n_flat_words / 1e9:.2f} GB), "
        f"max_sparse_k {engine.max_sparse_k}, pool update chunk "
        f"{engine._pool_update_k_cap}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    assert engine.n_sparse > 0 and engine.pool_slots > 0, "tier not on"
    timings.update(two_tier_kernels(engine, kernels, torch, err, "7"))
    groupby["7"] = groupby_kernels(engine, kernels, torch, db, err, timings,
                                   "7")

    counts64 = sample_count_queries(db, 64, seed=1)
    wide = sample_count_queries(db, 512, seed=7)
    muts = mutations_queries(db)
    groupby, details = groupby_queries(db), details_queries(db)
    t0 = time.perf_counter()
    want64, want_wide, want_muts = (oracle(db, counts64), oracle(db, wide),
                                    oracle(db, muts))
    want_groupby, want_details = oracle(db, groupby), oracle(db, details)
    log("7 oracle", f"host oracle answered in {time.perf_counter() - t0:.1f} s")
    answers = dict(db=db, counts64=counts64, want64=want64, wide=wide,
                   want_wide=[w["queryResult"][0]["count"] for w in want_wide],
                   muts=muts, want_muts=want_muts, groupby=groupby,
                   want_groupby=want_groupby, details=details,
                   want_details=want_details)
    torch.cuda.reset_peak_memory_stats()  # the comparisons' temporaries
    two_tier_path(main, kernels, engine, answers, ("7a", "7b", "7c"))
    log("7 done", f"peak device memory over 7a-7c "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (stream, pool, "
        f"densified blocks)")
    del engine
    detach(db, torch)
    return answers


def two_tier_path(main: MainPath, kernels, engine, answers: dict,
                  labels: tuple) -> None:
    """The two-tier main path against the host oracle's answers: (a) the 64
    counts cold and then hot, (b) the 512 queries through count_programs
    (pooled) and through count_dispatches with force_poolless (densified
    blocks), (c) the Mutations, group-by and Details queries."""
    from lapis_silo_torch.query.engine import Query

    db, want_wide = answers["db"], answers["want_wide"]
    lowered = [engine.lower(Query(q).filter)[0] for q in answers["wide"]]
    with main.phase():
        for label in ("cold", "hot"):
            hits, misses = engine.pool_hits, engine.pool_misses
            run_counts(db, answers["counts64"], answers["want64"],
                       f"{labels[0]} {label}")
            log(f"{labels[0]} {label}", f"pool hits {engine.pool_hits - hits}, "
                f"misses {engine.pool_misses - misses}")
        launches = kernels.DENSIFY_INTO_POOL.launches
        hits, misses = engine.pool_hits, engine.pool_misses
        t0 = time.perf_counter()
        got = engine.count_programs(lowered)
        wide_s = time.perf_counter() - t0
        assert got == want_wide
        n_updates = kernels.DENSIFY_INTO_POOL.launches - launches
        assert n_updates > 0, "the wide batch did not ride the pool"
        log(f"{labels[1]} pooled", f"{len(lowered)} queries in one "
            f"count_programs call equal the host oracle; {wide_s * 1e3:.2f} ms "
            f"({len(lowered) / wide_s:.0f} queries/s, lowering excluded); "
            f"{n_updates} pool-update launches, pool hits "
            f"{engine.pool_hits - hits}, "
            f"misses {engine.pool_misses - misses}")
        launches = kernels.DENSIFY_ROWS.launches
        t0 = time.perf_counter()
        results = [engine.host_count(p, allow_interpret=False) for p in lowered]
        device_idx = [i for i, r in enumerate(results) if r is None]
        got = engine.count_finish(results, device_idx, engine.count_dispatches(
            [lowered[i] for i in device_idx], force_poolless=True))
        wide_s = time.perf_counter() - t0
        assert got == want_wide
        n_blocks = kernels.DENSIFY_ROWS.launches - launches
        assert n_blocks > 0, "the poolless batch densified nothing"
        log(f"{labels[1]} poolless", f"the same {len(lowered)} through "
            f"count_dispatches(force_poolless=True) equal the host oracle; "
            f"{wide_s * 1e3:.2f} ms ({len(lowered) / wide_s:.0f} queries/s); "
            f"{n_blocks} densified blocks")
        run_mutations(db, answers["muts"], answers["want_muts"],
                      f"{labels[2]} mutations")
        run_groupby(db, answers["groupby"], answers["want_groupby"],
                    f"{labels[2]} group-by", engine)
        run_details(db, engine, answers["details"], answers["want_details"],
                    f"{labels[2]} details")
        run_count_calls(db, engine, answers["muts"] + answers["details"],
                        f"{labels[2]} counts")
        assert db._engine._use_device
        assert kernels.GROUP_COUNTS.launches > 0


def detach(db, torch) -> None:
    """Drop the device engine installed on `db` and free its memory."""
    db.device_engine = None
    with db._engine_lock:
        db._engine = None
    gc.collect()  # the engine and its database reference each other
    torch.cuda.empty_cache()


def peak_memory(torch, cards) -> str:
    """Peak device memory since the last reset, per card."""
    return " / ".join(f"{torch.cuda.max_memory_allocated(card) / 1e9:.2f}"
                      for card in cards) + " GB" + (
        " per card" if len(cards) > 1 else "")


def install_sharded(db, torch, label: str):
    """install() with N_SHARDS word shards placed round-robin on the visible
    cards, and its set-up logged."""
    import lapis_silo_torch

    n_cards = torch.cuda.device_count()
    devices = [torch.device(DEVICE, d % n_cards) for d in range(N_SHARDS)]
    cards = list(dict.fromkeys(devices))
    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)
    t0 = time.perf_counter()
    engine = lapis_silo_torch.install(db, devices[0], devices=devices)
    for card in cards:
        torch.cuda.synchronize(card)
    t_engine = time.perf_counter() - t0
    bank = engine.banks[0]
    log(f"{label} setup", f"{N_SHARDS} word shards on "
        f"{[str(d) for d in devices]}: {len(cards)} card(s), "
        + ("all shards on one card, so no copy crosses cards"
           if len(cards) == 1 else "counts and filters copied across cards")
        + f"; n_words {engine.n_words}, {engine.shards.local_words} words per "
        f"shard; bank {tuple(bank.shape)} per shard "
        f"({bank.numel() * 4 / 1e9:.2f} GB each); n_sparse {engine.n_sparse}, "
        f"pool_slots {engine.pool_slots}; built in {t_engine:.1f} s; peak "
        f"device memory {peak_memory(torch, cards)}")
    return engine


def sharded_kernels(engine, kernels, lowered, mut_query: str, err: dict,
                    timings: dict) -> None:
    """vm_run_sharded (the wide batch's programs, in their segments) and
    mutation_counts_sharded (the main segment against a Mutations filter)
    against their plain versions at the sharded engine's shapes, with both
    times and the work for their bounds (spread over the cards the shards
    lie on); beside K6, K1 over all the shards' words in one launch, the
    same work on one card."""
    import torch

    from lapis_silo_torch.ops import vm
    from lapis_silo_torch.query.engine import Query

    on_device = [p for p in lowered
                 if engine.host_count(p, allow_interpret=False) is None]
    inputs = engine.kernel_inputs(engine.batch_args(on_device))
    code, n_instr, banks, dyns, rows, fulls, n_regs, segments = inputs
    (got_words, got_counts), (want_words, want_counts) = (
        kernels.vm_run_sharded(*inputs), kernels.vm_run_sharded_plain(*inputs))
    err["vm_run_sharded"] = max(err["vm_run_sharded"],
                                max_abs_err(got_counts, want_counts),
                                *map(max_abs_err, got_words, want_words))
    timings["vm_run_sharded"] = (
        cuda_ms(lambda: kernels.vm_run_sharded(*inputs), reps=20),
        cuda_ms(lambda: kernels.vm_run_sharded_plain(*inputs), reps=1,
                warmup=0),
        *vm_work(vm, code, n_instr, {vm.B_BANK: banks[0].shape[0],
                                     vm.B_DYN: dyns[0].shape[0],
                                     vm.B_SPARSE: rows[0].shape[0]},
                 engine.n_flat_words, segments),
        len(engine.shards.distinct))
    filters = engine.device_filter(Query(mut_query).filter).parts
    meta = engine.segment_meta[("nuc", "main")]
    args = (engine.banks, filters, meta["offset"], meta["n_stored"])
    err["mutation_counts_sharded"] = max(
        err["mutation_counts_sharded"], max_abs_err(
            kernels.mutation_counts_sharded(*args),
            kernels.mutation_counts_sharded_plain(*args)))
    n_rows, pw = meta["n_stored"], engine.n_flat_words
    timings["mutation_counts_sharded"] = (
        cuda_ms(lambda: kernels.mutation_counts_sharded(*args), reps=20),
        cuda_ms(lambda: kernels.mutation_counts_sharded_plain(*args), reps=2,
                warmup=1),
        4 * (n_rows * pw + pw + n_rows * len(engine.banks)), 2 * n_rows * pw,
        len(engine.shards.distinct))
    sharded_wall_ms = wall_ms(lambda: kernels.vm_run_sharded(*inputs), reps=20)
    # the yardstick: K1 over all the shards' words in one launch on the first
    # card, the dense deployment's launch
    whole = [torch.cat([part.to(engine.shards.devices[0]) for part in parts],
                       dim=-1) for parts in (banks, dyns, rows, fulls)]
    yard = (code, n_instr, *whole, n_regs, segments)
    yard_words, yard_counts = kernels.vm_run(*yard)
    err["vm_run"] = max(err["vm_run"], max_abs_err(yard_counts, got_counts),
                        max_abs_err(yard_words, torch.cat(
                            [w.to(yard_words.device) for w in got_words])))
    yard_ms = cuda_ms(lambda: kernels.vm_run(*yard), reps=20)
    del whole, yard, yard_words
    torch.cuda.empty_cache()
    k6_bound = bound(*timings["vm_run_sharded"][2:])[0]
    log("8a kernels", f"sharded shapes bit-exact, max_abs_err "
        f"{ {k: err[k] for k in ('vm_run_sharded', 'mutation_counts_sharded')} }; "
        f"vm_run_sharded {len(on_device)} programs, {n_instr} instructions in "
        f"{len(segments) - 1} segments, "
        f"{len(engine.banks)} shards of {engine.shards.local_words} words on "
        f"{len(engine.shards.distinct)} card(s): kernel "
        f"{timings['vm_run_sharded'][0]:.4f} ms (bound {k6_bound:.4f} ms, "
        f"{timings['vm_run_sharded'][2] / 1e6:.2f} MB; the wrapper's wall "
        f"time per call {sharded_wall_ms:.4f} ms; K1 over the "
        f"{engine.n_flat_words} words in one launch {yard_ms:.4f} ms), plain "
        f"{timings['vm_run_sharded'][1]:.1f} ms; mutation_counts_sharded "
        f"{meta['n_stored']} rows x {len(engine.banks)} shards of "
        f"{engine.shards.local_words} words: kernel "
        f"{timings['mutation_counts_sharded'][0]:.4f} ms, plain "
        f"{timings['mutation_counts_sharded'][1]:.2f} ms")


def phase8a(main: MainPath, kernels, torch, db, answers: dict, err: dict,
            timings: dict, groupby: dict) -> tuple[str, dict]:
    """Phase 5's corpus and answers on the sharded engine (the single-device
    engine already dropped), with the sharded kernels, the compaction and
    K9 compared first (K9's readings into `groupby`). Returns phase 8c's
    query and its step's results."""
    from lapis_silo_torch.query.engine import Query
    from lapis_silo_torch.testing import sample_count_queries

    wide = sample_count_queries(db, 512, seed=7)
    want_wide = [w["queryResult"][0]["count"] for w in oracle(db, wide)]
    muts, want_muts = answers["Mutations"]
    engine = install_sharded(db, torch, "8a")
    lowered = [engine.lower(Query(q).filter)[0] for q in wide]
    sharded_kernels(engine, kernels, lowered, muts[0], err, timings)
    compact_kernels(engine, kernels, torch, db, err, timings, "8a")
    groupby["8a"] = groupby_kernels(engine, kernels, torch, db, err, timings,
                                    "8a")
    with main.phase():
        run_counts(db, *answers["counts"], "8a counts")
        run_groupby(db, *answers["group-by"], "8a group-by", engine)
        run_details(db, engine, *answers["Details"], "8a details")
        t0 = time.perf_counter()
        assert engine.count_programs(lowered) == want_wide
        wide_s = time.perf_counter() - t0
        log("8a wide", f"{len(wide)} queries in one count_programs call equal "
            f"the host oracle; {wide_s * 1e3:.2f} ms ({len(wide) / wide_s:.0f} "
            f"queries/s, lowering excluded)")
        run_mutations(db, muts[:1], want_muts[:1], "8a mutations")
        run_count_calls(db, engine, muts + answers["Details"][0], "8a counts")
        assert db._engine._use_device
        assert kernels.VM_RUN_SHARDED.launches > 0
        assert kernels.MUTATION_COUNTS_SHARDED.launches > 0
        assert kernels.GROUP_COUNTS.launches > 0
    step_results = phase8c(main, kernels, torch, engine, lowered[3])
    del engine
    detach(db, torch)
    return wide[3], step_results


def phase8c(main: MainPath, kernels, torch, engine, program) -> dict:
    """ShardedQueryStep over the sharded engine's four [89,709, 8,192]
    banks: one program of the wide batch, its words, count and 64 segment
    counts against the plain versions on the card and a popcount on the
    host, for the main segment's start and a start past the end (clamped);
    its time per call on the card and wall. Then dryrun_multichip on 4
    shards of the visible cards. Returns, per segment start, the step's
    words (a SHA-256 per shard), count and segment counts."""
    from lapis_silo_torch.ops import vm
    from lapis_silo_torch.parallel.dryrun import dryrun_multichip
    from lapis_silo_torch.parallel.mesh import ShardedQueryStep

    code, _n, banks, dyns, _rows, fulls, _regs, _seg = engine.kernel_inputs(
        engine._prepare_program(program))
    code = np.ascontiguousarray(code.numpy())
    step = ShardedQueryStep(engine.shards.devices, engine.n_flat_words)
    n_rows = banks[0].shape[0]
    starts = (engine.segment_meta[("nuc", "main")]["offset"], n_rows + 10)
    with main.phase():
        step(code, banks, dyns, fulls, starts[0])
        assert kernels.VM_RUN_SHARDED.launches == len(engine.shards.distinct)
        assert kernels.VM_RUN.launches == 0
        assert kernels.MUTATION_COUNTS_SHARDED.launches == 1
        # the count comes from the VM launch
        assert kernels.POPCOUNT_WORDS.launches == 0
    results = {}
    for start in starts:
        words, count, muts = step(code, banks, dyns, fulls, start)
        results[start] = {"hashes": [word_hash(w) for w in words],
                          "count": int(count),
                          "mutation_counts": muts.cpu().tolist()}
        plain_words, _emits = kernels.vm_run_sharded_plain(
            torch.from_numpy(code), code.shape[1], banks, dyns,
            step._no_sparse, fulls, vm.MAX_REGS)
        plain_muts = kernels.mutation_counts_sharded_plain(
            banks, plain_words, min(start, n_rows - 64), 64)
        assert all(max_abs_err(a, b) == 0 for a, b in zip(words, plain_words))
        assert max_abs_err(muts, plain_muts) == 0
        host = np.concatenate([w.cpu().numpy() for w in words]).view(np.uint32)
        clamped = min(start, n_rows - 64)
        rows = np.concatenate([b[clamped: clamped + 64].cpu().numpy()
                               for b in banks], axis=1).view(np.uint32)
        assert int(count) == int(np.unpackbits(host.view(np.uint8)).sum())
        assert np.array_equal(muts.cpu().numpy(), np.unpackbits(
            (rows & host[None, :]).view(np.uint8), axis=1).sum(axis=1))
    ms = cuda_ms(lambda: step(code, banks, dyns, fulls, starts[0]), reps=20)
    wall = wall_ms(lambda: step(code, banks, dyns, fulls, starts[0]), reps=20)
    log("8c step", f"ShardedQueryStep over {len(banks)} shards "
        f"{tuple(banks[0].shape)}, a {code.shape[1]}-instruction program, "
        f"segment starts {starts} (the second clamped to {n_rows - 64}): "
        f"words, count {int(count)} (from the VM launch, no K11) and 64 "
        f"segment counts equal the plain versions on the card and a popcount "
        f"on the host; {ms:.4f} ms per "
        f"call on the card, {wall:.4f} ms wall; {nvidia_smi()}")
    n_cards = torch.cuda.device_count()
    devices = [torch.device(DEVICE, d % n_cards) for d in range(N_SHARDS)]
    t0 = time.perf_counter()
    with main.phase():
        report = dryrun_multichip(devices)
    log("8c dryrun", f"dryrun_multichip on {report['devices']}: "
        f"{report['counts']} counts cold and hot (pool {report['pool_slots']} "
        f"slots, {report['pool_hits']} hits, {report['pool_misses']} misses), "
        f"group-by and Mutations bit-exact against the host oracle and a "
        f"one-device engine in {time.perf_counter() - t0:.1f} s; launches "
        f"(kernel, plain) {report['launches']}")
    return results


# one rank of phase 8d's pod path, run as `python -c POD_RANK <report path>
# <spec JSON>`: joins the process group, loads the snapshot, builds the
# port's engine over all D word shards on its card, keeps its own shards of
# the bank, dyn rows and full mask and frees the rest; runs ShardedQueryStep
# at each segment start with the launch counts set to 0 just before and
# read just after; then times the step (the card's busy time and wall) and
# the all-reduce alone and writes its report as JSON
POD_RANK = """
import datetime, gc, json, sys, time
t_start = time.perf_counter()
import numpy as np
import torch
import torch.distributed as dist
import chip_smoke
from lapis_silo_torch.ops import kernels
from lapis_silo_torch.ops.device_engine import DeviceEngine
from lapis_silo_torch.parallel import distributed
from lapis_silo_torch.parallel.mesh import ShardedQueryStep, make_mesh
from lapis_silo_torch.query.engine import Query
from lapis_silo_torch.storage.snapshot import load_database
report_path, spec = sys.argv[1], json.loads(sys.argv[2])
device = torch.device(spec["device"])
backend = distributed.initialize(
    spec["init"], spec["world"], spec["rank"], device, spec["backend"],
    timeout=datetime.timedelta(seconds=spec["timeout_s"]))
try:
    db = load_database(spec["snapshot"])
    mesh = make_mesh([device] * spec["local"])
    engine = DeviceEngine(db, device, devices=[device] * mesh.n_shards)
    code, _n, banks, dyns, _rows, fulls, _regs, _seg = engine.kernel_inputs(
        engine._prepare_program(engine.lower(Query(spec["query"]).filter)[0]))
    mine = slice(mesh.rank * spec["local"], (mesh.rank + 1) * spec["local"])
    banks, dyns, fulls = banks[mine], dyns[mine], fulls[mine]
    n_words = engine.n_flat_words
    del db, engine, _rows
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    ready_s = time.perf_counter() - t_start
    held = torch.cuda.memory_allocated(device)
    code = np.ascontiguousarray(code.numpy())
    step = ShardedQueryStep(mesh, n_words)
    kernels.reset_counts()
    results = []
    for start in spec["starts"]:
        words, count, muts = step(code, banks, dyns, fulls, start)
        results.append({"hashes": [chip_smoke.word_hash(w) for w in words],
                        "count": int(count),
                        "mutation_counts": muts.cpu().tolist()})
    launches = {k.name: k.launches for k in kernels.KERNELS}
    plain = {k.name: k.plain_launches for k in kernels.KERNELS}
    run = lambda: step(code, banks, dyns, fulls, spec["starts"][0])
    step_busy = chip_smoke.busy_ms(run, reps=20)
    step_wall = chip_smoke.wall_ms(run, reps=20)
    totals = torch.zeros(65, dtype=torch.int32, device=device)
    allreduce_wall = chip_smoke.wall_ms(lambda: dist.all_reduce(totals),
                                        reps=20, warmup=3)
finally:
    distributed.shutdown()
with open(report_path, "w") as f:
    json.dump({"backend": backend, "device": str(device), "n_words": n_words,
               "results": results, "launches": launches, "plain": plain,
               "step_busy_ms": step_busy, "step_wall_ms": step_wall,
               "allreduce_wall_ms": allreduce_wall, "ready_s": ready_s,
               "held_bytes": held,
               "peak_bytes": torch.cuda.max_memory_allocated(device),
               "banned": sorted(m for m in sys.modules if m.split(".")[0]
                                in ("jax", "jaxlib", "lapis_silo_tpu"))}, f)
"""


def wait_ranks(procs: dict, label: str, timeout: float = 600) -> None:
    """Wait for every process of `procs` ({label: (process, log path)}).
    Where one fails, or one is still running 30 s after another failed or
    at the deadline, the rest are killed and the smoke ends with every
    log's tail: a rank that died leaves the others in a collective."""
    deadline = time.monotonic() + timeout
    failed_at = None
    while any(proc.poll() is None for proc, _ in procs.values()):
        now = time.monotonic()
        if failed_at is None and any(proc.poll() not in (None, 0)
                                     for proc, _ in procs.values()):
            failed_at = now
        if now > deadline or (failed_at is not None and now > failed_at + 30):
            break
        time.sleep(0.2)
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    codes = {name: proc.returncode for name, (proc, _) in procs.items()}
    if any(codes.values()):
        for name, (proc, log_path) in procs.items():
            print(f"--- {name} (exit {proc.returncode}):\n"
                  f"{log_path.read_text()[-4000:]}", flush=True)
        raise SystemExit(f"{label}: ranks exited {codes}")


def worker_oracle(n_shards: int) -> tuple[np.ndarray, int, int]:
    """The numpy oracle of the pod-path worker's inputs at D shards
    (tests/test_jax_distributed.py's): the words, the count and the sum of
    the 64 segment counts."""
    rng = np.random.default_rng(0)
    bank = rng.integers(0, 1 << 32, size=(64, 2 * 4 * n_shards),
                        dtype=np.uint32)
    words = bank[3] & bank[7]
    return (words, int(np.bitwise_count(words).sum()),
            int(np.bitwise_count(bank & words[None, :]).sum()))


def phase8d(main: MainPath, kernels, torch, db, query: str,
            want: dict) -> dict:
    """The pod path at full width: phase 5's corpus saved as a snapshot
    under build/, then ranks of one process group over the N_SHARDS global
    word shards: on one card 2 ranks x 2 shards joined by gloo (NCCL takes
    one card per rank), on 4 cards 4 ranks x 1 over NCCL. Each rank loads
    the snapshot, keeps its shards of the port engine's bank and runs
    ShardedQueryStep on phase 8c's query at 8c's segment starts (`want`:
    its words' hashes, count and segment counts per start), which its
    words, the all-reduced count and segment counts must equal; the VM
    (which yields the count) and K2 launched in every rank, no K11, no
    plain version, no JAX module. Then
    the NCCL route on every machine: the worker, one rank with N_SHARDS
    shards on the first card, against the numpy oracle. Returns the
    ranks' times, memory and backends."""
    from lapis_silo_torch.storage.snapshot import save_database

    base = ROOT / "build" / "smoke_pod"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    t0 = time.perf_counter()
    snapshot = save_database(db, str(base / "data"))
    out = {"save_s": time.perf_counter() - t0}
    n_cards = torch.cuda.device_count()
    world = N_SHARDS if n_cards >= N_SHARDS else 2
    local = N_SHARDS // world
    # NCCL takes one card per rank; ranks sharing one card join over gloo,
    # which stages the CUDA tensors of the all-reduce through the host
    backend = "nccl" if n_cards >= world else "gloo"
    starts = list(want)
    procs = {}
    t0 = time.perf_counter()
    for rank in range(world):
        spec = {"init": f"file://{base / 'rendezvous'}", "world": world,
                "rank": rank, "local": local,
                "device": f"{DEVICE}:{rank % n_cards}", "backend": backend,
                "timeout_s": 300, "snapshot": snapshot, "query": query,
                "starts": starts}
        procs[f"rank{rank}"] = start_process(base, f"rank{rank}", [
            "-c", POD_RANK, str(base / f"rank{rank}.json"), json.dumps(spec)])
    wait_ranks(procs, "8d")
    out["ranks_s"] = time.perf_counter() - t0
    reports = [json.loads((base / f"rank{r}.json").read_text())
               for r in range(world)]
    for rank, report in enumerate(reports):
        for start, got in zip(starts, report["results"]):
            ref = want[start]
            assert got["hashes"] == ref["hashes"][rank * local:
                                                  (rank + 1) * local], (
                rank, start)
            assert (got["count"], got["mutation_counts"]) == (
                ref["count"], ref["mutation_counts"]), (rank, start)
        assert vm_launched(report["launches"]), (rank, report["launches"])
        for name in ("mutation_counts", "mutation_counts_sharded"):
            assert report["launches"][name] > 0, (rank, name)
        # the step's count comes from the VM launch
        assert report["launches"]["popcount_words"] == 0, rank
        assert not any(report["plain"].values()), (rank, report["plain"])
        assert report["banned"] == [], (rank, report["banned"])
        assert report["backend"] == backend, report["backend"]
        main.add(report["launches"], report["plain"])
    out["ranks"] = [{k: r[k] for k in ("device", "backend", "step_busy_ms",
                                       "step_wall_ms", "allreduce_wall_ms",
                                       "ready_s", "held_bytes", "peak_bytes")}
                    for r in reports]
    log("8d pod", f"{world} ranks x {local} shards over {backend} on "
        f"{[r['device'] for r in reports]} ({n_cards} card(s)), "
        f"PW {reports[0]['n_words']} words: each rank's words, the count and "
        f"the 64 segment counts at segment starts {starts} equal phase 8c's "
        f"one-process step; the VM (K6 with 2 shards a card, K1 with 1), "
        f"which yields the count, and K2 launched in every rank, no K11, no "
        f"plain version, no JAX module; "
        f"snapshot saved in {out['save_s']:.1f} s, "
        f"ranks done in {out['ranks_s']:.1f} s; per rank: "
        + "; ".join(
            f"rank {i} shards ready {r['ready_s']:.1f} s after start, step "
            f"{r['step_busy_ms']:.4f} ms per call busy on the card, "
            f"{r['step_wall_ms']:.4f} ms wall, all-reduce of 65 int32 alone "
            f"{r['allreduce_wall_ms']:.4f} ms wall, holds "
            f"{r['held_bytes'] / 1e9:.2f} GB, peak "
            f"{r['peak_bytes'] / 1e9:.2f} GB"
            for i, r in enumerate(reports))
        + "; launches " + str([{n: v for n, v in r["launches"].items() if v}
                               for r in reports])
        + f"; {nvidia_smi()}")
    # the NCCL route on every machine: one rank, all shards on one card
    words, count, mut = worker_oracle(N_SHARDS)
    t0 = time.perf_counter()
    proc = start_process(base, "worker", [
        "-m", "lapis_silo_torch.parallel.distributed_worker",
        f"file://{base / 'rendezvous_worker'}", "1", "0", "--device",
        f"{DEVICE}:0", "--backend", "nccl", "--local-shards", str(N_SHARDS),
        "--out", str(base / "worker")])
    wait_ranks({"worker": proc}, "8d worker")
    out["worker_s"] = time.perf_counter() - t0
    worker = json.loads((base / "worker" / "rank0.json").read_text())
    assert f"RESULT count={count} mut={mut}" in proc[1].read_text()
    assert worker["words"] == words.tolist() and worker["backend"] == "nccl"
    assert vm_launched(worker["launches"]) and worker["launches"][
        "mutation_counts"] > 0 and worker["launches"][
        "popcount_words"] == 0, worker["launches"]
    assert not any(worker["plain"].values()), worker["plain"]
    main.add(worker["launches"], worker["plain"])
    log("8d worker", f"python -m lapis_silo_torch.parallel.distributed_worker "
        f"over nccl, 1 rank x {N_SHARDS} shards on {DEVICE}:0: RESULT "
        f"count={count} mut={mut} equals the numpy oracle, its words too; "
        f"{out['worker_s']:.1f} s with the process's start")
    shutil.rmtree(base, ignore_errors=True)
    return out


def phase8b(main: MainPath, kernels, torch, answers: dict,
            err: dict) -> None:
    """Phase 7's corpus and answers on the sharded engine: window-local pool
    updates and densified blocks, the entry-split sparse Mutations; the
    windowed and chunked kernels compared at these shapes first."""
    engine = install_sharded(answers["db"], torch, "8b")
    assert engine.n_sparse > 0 and engine.pool_slots > 0, "tier not on"
    two_tier_kernels(engine, kernels, torch, err, "8b")
    for card in engine.shards.distinct:
        torch.cuda.reset_peak_memory_stats(card)
    two_tier_path(main, kernels, engine, answers, ("8b",) * 3)
    for k in (kernels.VM_RUN_SHARDED, kernels.DENSIFY_INTO_POOL,
              kernels.DENSIFY_ROWS, kernels.SPARSE_COUNTS):
        assert k.launches > 0, f"{k.name} did not launch in 8b"
    log("8b done", f"peak device memory over 8b "
        f"{peak_memory(torch, engine.shards.distinct)}; launches "
        f"{ {k.name: k.launches for k in kernels.KERNELS} }")
    del engine
    detach(answers["db"], torch)


def http(port: int, method: str, path: str, body: str | None = None):
    """(status, data-version, parsed JSON body) of one request."""
    conn = http_client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"} if body
                     else {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("data-version"), json.loads(
            resp.read())
    finally:
        conn.close()


def serve_checks(port: int, served, db, answers: dict, label: str,
                 note: str = "") -> dict:
    """Every query of `answers` ({action: (queries, oracle answers)}) over
    HTTP, each body equal to the host oracle's and each data-version the
    served snapshot's; GET /info equal to db.info(). Returns the p50 ms per
    action."""
    version = served.data_version.value
    p50 = {}
    for action, (queries, want) in answers.items():
        latencies = []
        for query, expected in zip(queries, want):
            t0 = time.perf_counter()
            status, got_version, got = http(port, "POST", "/query", query)
            latencies.append(time.perf_counter() - t0)
            assert (status, got_version) == (200, version), (status, query)
            assert got == expected, query
        p50[action] = statistics.median(latencies) * 1e3
    status, got_version, info = http(port, "GET", "/info")
    assert (status, got_version, info) == (200, version, db.info())
    log(label, f"over HTTP every body equals the host oracle "
        f"({', '.join(f'{len(q)} {a}' for a, (q, _) in answers.items())}) "
        f"and /info equals db.info(); p50 per action "
        f"{ {a: round(ms, 3) for a, ms in p50.items()} } ms{note}")
    return p50


def phase9(main: MainPath, kernels, torch, db, answers: dict) -> dict:
    """The slice's path: phase 5's corpus saved as a snapshot by the port,
    loaded by the port's watcher (which installs the port's engine on the
    visible cards and warms it up) and served in this process over HTTP on
    port 0, by the Python server and, where libsilo_http.so builds,
    by the native server and its count fast path. Returns the set-up
    seconds and the p50 per action."""
    from lapis_silo_torch.server import native_http
    from lapis_silo_torch.storage.snapshot import save_database

    data_dir = ROOT / "build" / "smoke_data"
    shutil.rmtree(data_dir, ignore_errors=True)
    t0 = time.perf_counter()
    path = Path(save_database(db, str(data_dir)))
    t_save = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in path.iterdir())
    out = {"save_s": t_save, "bytes": size}
    mutex, served, out["load_s"], out["warmup_s"] = load_served(data_dir,
                                                                torch)
    assert served.info() == db.info()
    engine = served.device_engine
    engine.COMPACT_MIN_WORDS = 0
    log("9 setup", f"snapshot of {db.info()['sequenceCount']} sequences "
        f"saved by the port in {t_save:.1f} s ({size / 1e9:.3f} GB on "
        f"disk); the watcher loaded it and installed the port's engine on "
        f"{[str(d) for d in engine.shards.devices]} in "
        f"{out['load_s']:.1f} s and warmed it up in {out['warmup_s']:.1f} "
        f"s; COMPACT_MIN_WORDS set to 0 on the served engine "
        f"({engine.n_flat_words} flat words) so Details goes through "
        f"evaluate_compact")
    if not native_http.native_http_available():
        log("9 native", "libsilo_http.so did not build here: the "
            "native server is not checked")
    out["python"] = serve_once(main, kernels, mutex, served, answers,
                               "9 python", impl="python")
    if native_http.native_http_available():
        out["native"] = serve_once(main, kernels, mutex, served, answers,
                                   "9 native", fast=True)
        out["fast"] = out["native"].pop("fast")
    del engine
    detach(served, torch)
    shutil.rmtree(data_dir, ignore_errors=True)
    return out


# runs the port's CLI main (--worker or --coordinator) in a subprocess; just
# before the CLI leaves through os._exit it writes, as JSON into the file
# its first argument names, its kernels' launches and plain-version runs
# since its first committed version, its peak device memory and the modules
# of jax* and lapis_silo_tpu* loaded
HOST_WRAPPER = """
import json, sys, time
import torch
from lapis_silo_torch import cli
from lapis_silo_torch.ops import kernels
from lapis_silo_torch.parallel import multihost
report, t0 = sys.argv[1], time.perf_counter()
committed = {}
commit, graceful_exit = multihost.StagedSnapshotWatcher.commit, cli._graceful_exit

def counts():
    return {k.name: [k.launches, k.plain_launches] for k in kernels.KERNELS}

def recording_commit(self, version):
    done = commit(self, version)
    if done and not committed:
        committed.update(counts=counts(), s=time.perf_counter() - t0)
    return done

def recording_exit():
    now = counts()
    since = committed.get("counts", {n: [0, 0] for n in now})
    with open(report, "w") as f:
        json.dump({"launches": {n: now[n][0] - since[n][0] for n in now},
                   "plain": {n: now[n][1] - since[n][1] for n in now},
                   "commit_s": committed.get("s"),
                   "peak_bytes": torch.cuda.max_memory_allocated()
                   if torch.cuda.is_available() else 0,
                   "banned": sorted(m for m in sys.modules if m.split(".")[0]
                                    in ("jax", "jaxlib", "lapis_silo_tpu"))},
                  f)
    graceful_exit()

multihost.StagedSnapshotWatcher.commit = recording_commit
cli._graceful_exit = recording_exit
sys.exit(cli.main(sys.argv[2:]))
"""


def free_port() -> int:
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def start_process(base: Path, label: str, args: list[str]):
    """`python <args>` in `base` with this checkout on its path, on the
    visible cards (SILO_TORCH_DEVICE and SILO_HTTP_IMPL unset), its output
    in base/<label>.log. Returns (process, log path)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("SILO_TORCH_DEVICE", "SILO_HTTP_IMPL", "PYTHONPATH")}
    env["PYTHONPATH"] = str(ROOT)
    log_path = base / f"{label}.log"
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen([sys.executable, *args], cwd=base, env=env,
                                stdout=log_file, stderr=subprocess.STDOUT)
    return proc, log_path


def start_host(base: Path, label: str, argv: list[str]):
    """One host of phase 11's slice: the port's CLI through HOST_WRAPPER,
    serving on the visible card. Returns (process, report path, log
    path)."""
    report = base / f"{label}.json"
    proc, log_path = start_process(
        base, label, ["-c", HOST_WRAPPER, str(report), *argv])
    return proc, report, log_path


def slice_memory(procs: dict) -> str:
    """Device memory per host process as nvidia-smi lists it (none where
    it cannot see the processes' ids), and the card's memory in use by
    every process."""
    def query(*args):
        return subprocess.run(["nvidia-smi", *args, "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.splitlines()

    used = dict(line.split(", ", 1)
                for line in query("--query-compute-apps=pid,used_memory")
                if ", " in line)
    return "; ".join(f"{label} {used.get(str(proc.pid), 'not listed')}"
                     for label, (proc, _r, _l) in procs.items()) + (
        f"; the card's memory.used {query('--query-gpu=memory.used')[0]}")


def timed_post(port: int, path: str, body: str) -> tuple[float, int, int]:
    """(ms, status, body bytes) of one POST, its body read whole."""
    t0 = time.perf_counter()
    conn = http_client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    return (time.perf_counter() - t0) * 1e3, resp.status, len(data)


def phase11(main: MainPath, kernels, torch, db, answers: dict,
            single_p50: dict) -> dict:
    """The multi-host slice on the card through the port's CLI: phase 5's
    corpus in 3 shards saved under one data version (the coordinator's
    partitions 0-1, worker A's 2, worker B's 3), two --worker processes
    and one --coordinator over them, each serving its shard on the visible
    card; phase 9's queries through the coordinator over HTTP, every body
    equal to the host oracle over the whole corpus, and /info and
    /info?details=true to the whole database's; per host, the VM, K2 and K9
    launched after its first committed version, no plain version ran and
    no module of jax* or lapis_silo_tpu* loaded; SIGTERM ends each with
    exit code 0. Returns the seconds to the first committed version and
    the p50 per action."""
    from lapis_silo_torch.storage.database import DataVersion
    from lapis_silo_torch.testing import save_shards, shard_database

    base = ROOT / "build" / "smoke_slice"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    version = "1700000011"
    groups = ([0, 1], [2], [3])
    dirs = [base / name for name in ("coordinator", "worker_a", "worker_b")]
    t0 = time.perf_counter()
    save_shards(db, groups, [d / "data" for d in dirs], version)
    out = {"save_s": time.perf_counter() - t0}
    log("11 setup", f"{db.info()['sequenceCount']} sequences saved as 3 "
        f"shards (partitions {list(groups)}) under data version {version} "
        f"in {out['save_s']:.1f} s")
    ports = [free_port() for _ in dirs]
    urls = [f"http://127.0.0.1:{port}" for port in ports[1:]]
    procs = {}
    t_start = time.perf_counter()
    for label, d, port in zip(("worker_a", "worker_b"), dirs[1:], ports[1:]):
        procs[label] = start_host(d, label, [
            "--worker", "--dataDirectory", str(d / "data"), "--port",
            str(port)])
    procs["coordinator"] = start_host(dirs[0], "coordinator", [
        "--coordinator", "--workerUrls", ",".join(urls), "--dataDirectory",
        str(dirs[0] / "data"), "--port", str(ports[0])])
    port = ports[0]
    try:
        want_info = db.info()
        deadline = time.time() + 600
        while True:
            for label, (proc, _r, log_path) in procs.items():
                if proc.poll() is not None:
                    print(log_path.read_text()[-4000:], flush=True)
                    raise SystemExit(f"11: {label} exited {proc.returncode}")
            try:
                status, got_version, info = http(port, "GET", "/info")
            except OSError:  # still starting
                info = None
            if info is not None and status == 200 and (
                    info["sequenceCount"] == want_info["sequenceCount"]):
                break
            assert time.time() < deadline, "the slice never committed"
            time.sleep(0.5)
        out["first_version_s"] = time.perf_counter() - t_start
        assert (info, got_version) == (want_info, version), info
        status, got_version, detailed = http(port, "GET",
                                             "/info?details=true")
        assert (status, got_version) == (200, version)
        assert detailed == db.detailed_info()
        log("11 up", f"2 workers and the coordinator committed version "
            f"{version} {out['first_version_s']:.1f} s after start; /info "
            f"and /info?details=true equal the whole database's; "
            f"{nvidia_smi()}")
        # the slice's version, not the whole database's, heads the answers
        shard = shard_database(db, groups[0])
        shard.data_version = DataVersion(version)
        p50 = serve_checks(port, shard, db, answers, "11 slice",
                           "; through the coordinator over 2 workers")
        # where a Mutations query's time goes: the coordinator's answer
        # against one worker's partial alone (its K2 and the count
        # matrices' frame over HTTP), each query three times
        out["mutations_ms"] = [
            {"coordinator": [timed_post(port, "/query", q)[0]
                             for _ in range(3)],
             "worker_partial": [timed_post(ports[1], "/internal/partial", q)
                                for _ in range(3)]}
            for q in answers["Mutations"][0]]
        log("11 mutations", f"per Mutations query, 3 times each: ms through "
            f"the coordinator, and (ms, status, bytes) of worker A's "
            f"/internal/partial alone {out['mutations_ms']}")
        counts, want = answers["counts"]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            got = list(pool.map(
                lambda q: http(port, "POST", "/query", q), counts))
        pooled_s = time.perf_counter() - t0
        assert got == [(200, version, w) for w in want]
        out["memory"] = slice_memory(procs)
        for label, (proc, _r, _l) in procs.items():
            proc.send_signal(signal.SIGTERM)
        codes = {label: proc.wait(timeout=120)
                 for label, (proc, _r, _l) in procs.items()}
        assert codes == {label: 0 for label in procs}, codes
    finally:
        for proc, _r, _l in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    reports = {label: json.loads(report.read_text())
               for label, (_p, report, _l) in procs.items()}
    for label, report in reports.items():
        assert vm_launched(report["launches"]), (label, report["launches"])
        for name in ("mutation_counts", "group_counts"):
            assert report["launches"][name] > 0, (label, name)
        for name in ("popcount_words", "compact_nonzero"):
            assert report["launches"][name] == 0, (label, name)
        assert not any(report["plain"].values()), (label, report["plain"])
        assert report["banned"] == [], (label, report["banned"])
        main.add(report["launches"], report["plain"])
    out["p50"] = p50
    log("11 done", f"64 counts again from 16 threads through the "
        f"coordinator's batched fan-out equal the host oracle in "
        f"{pooled_s * 1e3:.1f} ms; p50 per action through the coordinator "
        f"{ {a: round(v, 3) for a, v in p50.items()} } ms against phase 9's "
        f"single native host { {a: round(v, 3) for a, v in single_p50.items() if a in p50} } "
        f"ms; device memory per process (nvidia-smi) {out['memory']}; "
        f"allocator peak per process "
        f"{ {k: round(r['peak_bytes'] / 1e9, 2) for k, r in reports.items()} } "
        f"GB; launches since each host's first commit "
        f"{ {k: {n: v for n, v in r['launches'].items() if v} for k, r in reports.items()} }; "
        f"every process exited 0 on SIGTERM; {nvidia_smi()}")
    shutil.rmtree(base, ignore_errors=True)
    return out


# runs the port's CLI main in a subprocess and prints, as its last line, its
# exit code, the ingest's and the save's seconds, the NDJSON scanners the
# preprocessor made and the modules of jax* and lapis_silo_tpu* loaded
INGEST_WRAPPER = """
import json, sys, time
from lapis_silo_torch import cli
from lapis_silo_torch.preprocessing.preprocessor import Preprocessor
from lapis_silo_torch.storage import snapshot
made, saved = [], []
make, save = Preprocessor._make_ndjson_scanner, snapshot.save_database

def recording_make(self, *args, **kwargs):
    scanner = make(self, *args, **kwargs)
    made.append(type(scanner).__name__)
    return scanner

def timed_save(*args, **kwargs):
    t0 = time.perf_counter()
    path = save(*args, **kwargs)
    saved.append(time.perf_counter() - t0)
    return path

Preprocessor._make_ndjson_scanner = recording_make
snapshot.save_database = timed_save
t0 = time.perf_counter()
rc = cli.main(sys.argv[1:])
total = time.perf_counter() - t0
print(json.dumps({"rc": rc, "ingest_s": total - sum(saved),
                  "save_s": sum(saved), "scanners": made,
                  "banned": sorted(m for m in sys.modules if m.split(".")[0]
                                   in ("jax", "jaxlib", "lapis_silo_tpu"))}))
"""


def cli_ingest(base: Path, config: Path, inputs, label: str,
               shards: int = 1) -> dict:
    """The port's CLI --preprocessing on `config` in a subprocess (its
    output under `base`, SILO_NDJSON_NATIVE unset): it must exit 0, scan
    with the native scanner and load no module of jax* or lapis_silo_tpu*.
    Returns the wrapper's report with the snapshot's path and size."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("SILO_NDJSON_NATIVE", "PYTHONPATH")}
    env["PYTHONPATH"] = str(ROOT)
    argv = ["--preprocessing", "--preprocessingConfig", str(config),
            "--databaseConfig", inputs.database_config]
    if shards > 1:
        argv += ["--ingestShards", str(shards)]
    log_path = base / f"ingest_{label}.log"
    with open(log_path, "w") as log_file:
        done = subprocess.run([sys.executable, "-c", INGEST_WRAPPER, *argv],
                              cwd=base, env=env, stdout=subprocess.PIPE,
                              stderr=log_file, text=True, timeout=900)
    if done.returncode != 0:
        print(log_path.read_text()[-4000:], flush=True)
        raise SystemExit(f"ingest {label} exited {done.returncode}")
    report = json.loads(done.stdout.strip().splitlines()[-1])
    assert report["rc"] == 0, report
    assert report["scanners"][:1] == ["NativeNdjsonScanner"], report
    assert report["banned"] == [], report
    import yaml

    out = Path(yaml.safe_load(config.read_text())["outputDirectory"])
    (snapshot_dir,) = out.iterdir()
    report["path"] = snapshot_dir
    report["bytes"] = sum(f.stat().st_size for f in snapshot_dir.iterdir())
    lines = [line.split("] ")[-1]
             for line in log_path.read_text().splitlines()]
    scanned = [line for line in lines if line.startswith("scanning")]
    log("10 ingest", f"{label}: {INGEST['n_rows']} records in "
        f"{report['ingest_s']:.2f} s ({INGEST['n_rows'] / report['ingest_s']:.0f} "
        f"records/s), saved in {report['save_s']:.2f} s "
        f"({report['bytes'] / 1e9:.3f} GB on disk); scanners "
        f"{report['scanners']}, log: {scanned[0]}; jax* and "
        f"lapis_silo_tpu* modules loaded: {report['banned']}; "
        f"{nvidia_smi()}")
    return report


def load_served(path: Path, torch):
    """The snapshot directory's newest snapshot loaded by the port's watcher
    onto the visible card(s); returns (mutex, database, load+install s,
    warm-up s)."""
    import lapis_silo_torch
    from lapis_silo_torch.server.http_server import DatabaseMutex
    from lapis_silo_torch.server.watcher import DatabaseDirectoryWatcher

    mutex = DatabaseMutex()
    watcher = DatabaseDirectoryWatcher(str(path), mutex, poll_seconds=3600)
    warm = {}

    def timed_warmup(database):
        t = time.perf_counter()
        DatabaseDirectoryWatcher._warmup(database)
        warm["s"] = time.perf_counter() - t

    watcher._warmup = timed_warmup
    t0 = time.perf_counter()
    watcher.check_once()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    served = mutex.get_database()
    assert isinstance(served.device_engine, lapis_silo_torch.DeviceEngine)
    assert served.device_engine.device.type == torch.device(DEVICE).type
    assert served._engine._use_device
    return mutex, served, seconds - warm["s"], warm["s"]


def serve_once(main: MainPath, kernels, mutex, served, answers: dict,
               label: str, impl: str = "native", fast: bool = False) -> dict:
    """`answers` over HTTP from make_server on port 0 with SILO_HTTP_IMPL
    `impl` (and, with `fast`, the counts again through the native fast
    path), with the launch counts set to 0 just before and read just after:
    the VM, K2 and K9 launched, no K10 or K11 (the VM launch yields the
    Mutations filter's total and, the served engine's COMPACT_MIN_WORDS
    being 0, the Details filter's compact blocks), and no plain version
    ran. Returns the p50 ms
    per action (and the fast path's under "fast")."""
    from lapis_silo_torch.server import native_http
    from lapis_silo_torch.server.http_server import make_server

    os.environ["SILO_HTTP_IMPL"] = impl
    with main.phase():
        server = make_server(mutex, port=0)
        assert isinstance(server, native_http.NativeHTTPServer) == (
            impl == "native"), (impl, type(server))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        port = server.server_address[1]
        try:
            p50 = serve_checks(port, served, served, answers, label,
                               f"; {nvidia_smi()}")
            if fast:
                p50["fast"] = fast_path_checks(native_http, port, served,
                                               *answers["counts"])
        finally:
            server.shutdown()
            server.server_close()
            os.environ.pop("SILO_HTTP_IMPL", None)
        assert vm_launched({k.name: k.launches for k in kernels.KERNELS}), (
            f"the VM did not launch in {label}")
        for k in (kernels.MUTATION_COUNTS, kernels.GROUP_COUNTS):
            assert k.launches > 0, f"{k.name} did not launch in {label}"
        for k in (kernels.POPCOUNT_WORDS, kernels.COMPACT_NONZERO):
            assert k.launches == 0, f"{k.name} launched in {label}"
        assert not any(k.plain_launches for k in kernels.KERNELS), label
        log(f"{label} launches", f"{ {k.name: k.launches for k in kernels.KERNELS} } "
            f"({type(server).__name__})")
    return p50


def phase10(main: MainPath, kernels, torch) -> dict:
    """The slice's path: seeded input files ingested by the port's CLI, once
    in one process and once over 2 shard processes, each snapshot loaded by
    the port's watcher onto the card and served over HTTP; every body equal
    to the host oracle over the first snapshot, and the per-country and
    NucleotideEquals counts to the writer's arrays."""
    import yaml

    from lapis_silo_torch import native
    from lapis_silo_torch.testing import sample_count_queries, write_ingest_inputs

    base = ROOT / "build" / "smoke_ingest"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    t0 = time.perf_counter()
    inputs = write_ingest_inputs(
        base / "in", **INGEST, intermediate_directory=base / "inter_single",
        output_directory=base / "out_single")
    ndjson = base / "in" / "input_file.ndjson"
    log("10 input", f"{INGEST['n_rows']} records x {INGEST['length']} "
        f"positions as NDJSON ({ndjson.stat().st_size / 1e9:.3f} GB) written "
        f"in {time.perf_counter() - t0:.1f} s; {int(inputs.null_sequence.sum())} "
        f"null sequences")
    single = Path(inputs.preprocessing_config)
    sharded = base / "in" / "preprocessing_config_sharded.yaml"
    config = yaml.safe_load(single.read_text())
    config.update(intermediateResultsDirectory=str(base / "inter_sharded"),
                  outputDirectory=str(base / "out_sharded"))
    sharded.write_text(yaml.safe_dump(config))

    # the NDJSON scanner is built here, before the timed ingests, which
    # then find it fresh
    t0 = time.perf_counter()
    assert native.get_named_lib("libsilo_ndjson.so") is not None, (
        "libsilo_ndjson.so did not build")
    out = {"scanner_build_s": time.perf_counter() - t0}
    log("10 build", f"libsilo_ndjson.so built from native/silo_ndjson.cpp "
        f"against native_include/zstd.h in {out['scanner_build_s']:.2f} s; "
        f"{nvidia_smi()}")
    out["single"] = cli_ingest(base, single, inputs, "single process")
    mutex, served, out["load_s"], out["warmup_s"] = load_served(
        base / "out_single", torch)
    assert len(served.partitions) == 4, len(served.partitions)
    log("10 load", f"the watcher loaded {served.info()} in "
        f"{[p.sequence_count for p in served.partitions]} partitions and "
        f"installed the port's engine on "
        f"{[str(d) for d in served.device_engine.shards.devices]} in "
        f"{out['load_s']:.2f} s (load+install) and warmed it up in "
        f"{out['warmup_s']:.2f} s; {nvidia_smi()}")

    countries = json.dumps({
        "action": {"type": "Aggregated", "groupByFields": ["country"]},
        "filterExpression": {"type": "True"}})
    order = np.argsort(np.bincount(inputs.mut_pos * 5 + inputs.mut_sym))[::-1]
    pairs = [(int(code // 5) + 1, "-ACGT"[int(code % 5)])
             for code in order[:4]]
    pairs += [(int(pos) + 1, "-ACGT"[int(inputs.reference_ids[pos])])
              for pos in (0, 2400, 21562, INGEST["length"] - 1)]
    equals = [json.dumps({"action": {"type": "Aggregated"},
                          "filterExpression": {
                              "type": "NucleotideEquals", "position": pos,
                              "symbol": sym}}) for pos, sym in pairs]
    leaf = json.loads(mutations_queries(served)[0])["filterExpression"]
    queries = {
        "counts": sample_count_queries(served, 64, seed=1),
        "group-by": groupby_queries(served),
        "countries": [countries],
        "NucleotideEquals": equals,
        "Details": details_queries(served)[:1],
        "Mutations": mutations_queries(served),
        "AminoAcidMutations": [json.dumps({
            "action": {"type": "AminoAcidMutations", "minProportion": 0.01},
            "filterExpression": leaf})],
        "Insertions": [json.dumps({"action": {"type": "Insertions"},
                                   "filterExpression": leaf})],
    }
    answers = {action: (qs, oracle(served, qs))
               for action, qs in queries.items()}
    got = {row["country"]: row["count"]
           for row in answers["countries"][1][0]["queryResult"]}
    assert got == inputs.country_counts(), (got, inputs.country_counts())
    for (pos, sym), want in zip(pairs, answers["NucleotideEquals"][1]):
        assert want["queryResult"][0]["count"] == inputs.nucleotide_count(
            pos, sym), (pos, sym)
    log("10 oracle", f"the host oracle's per-country counts and "
        f"{len(pairs)} NucleotideEquals counts ({pairs}) equal the writer's "
        f"arrays counted with numpy")
    served.device_engine.COMPACT_MIN_WORDS = 0
    out["p50"] = serve_once(main, kernels, mutex, served, answers, "10c")
    info = served.info()
    del mutex, served
    gc.collect()
    torch.cuda.empty_cache()

    out["sharded"] = cli_ingest(base, sharded, inputs, "2 shards", shards=2)
    mutex, served, out["sharded_load_s"], out["sharded_warmup_s"] = (
        load_served(base / "out_sharded", torch))
    assert served.info() == info, (served.info(), info)
    served.device_engine.COMPACT_MIN_WORDS = 0
    out["sharded_p50"] = serve_once(main, kernels, mutex, served, answers,
                                    "10e")
    log("10 done", f"scanner build {out['scanner_build_s']:.2f} s; single "
        f"process: ingest {out['single']['ingest_s']:.2f} s, save "
        f"{out['single']['save_s']:.2f} s ({out['single']['bytes']} bytes), "
        f"load+install {out['load_s']:.2f} s, warm-up {out['warmup_s']:.2f} "
        f"s, p50 ms { {a: round(v, 3) for a, v in out['p50'].items()} }; "
        f"2 shards: ingest {out['sharded']['ingest_s']:.2f} s, save "
        f"{out['sharded']['save_s']:.2f} s, load+install "
        f"{out['sharded_load_s']:.2f} s, warm-up "
        f"{out['sharded_warmup_s']:.2f} s, p50 ms "
        f"{ {a: round(v, 3) for a, v in out['sharded_p50'].items()} }; "
        f"host times on the card's machine; {nvidia_smi()}")
    del mutex, served
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(base, ignore_errors=True)
    for run in ("single", "sharded"):
        out[run] = {k: v for k, v in out[run].items() if k != "path"}
    return out


def fast_path_checks(native_http, port: int, served, queries: list[str],
                     want: list[dict]) -> float:
    """The counts again until the native fast path answers every one of
    them with no call of the Python router: the same bodies and
    data-version. Returns the p50 ms of the fast path's answers."""
    version = served.data_version.value
    routed = [0]
    route_request = native_http.route_request

    def counted(*args):
        routed[0] += 1
        return route_request(*args)

    native_http.route_request = counted
    try:
        deadline = time.time() + 60
        while True:
            before = routed[0]
            latencies = []
            for query, expected in zip(queries, want):
                t0 = time.perf_counter()
                answer = http(port, "POST", "/query", query)
                latencies.append(time.perf_counter() - t0)
                assert answer == (200, version, expected), query
            if routed[0] == before or time.time() > deadline:
                break
            time.sleep(0.5)
        assert routed[0] == before, "the fast path never answered every count"
    finally:
        native_http.route_request = route_request
    p50 = statistics.median(latencies) * 1e3
    log("9 fast path", f"{len(queries)} counts answered by the native fast "
        f"path (no Python routing), equal to the host oracle; p50 "
        f"{p50:.3f} ms")
    return p50


def pod_only(main: MainPath, kernels, torch) -> None:
    """`--pod`: phase 5's corpus on the sharded engine with phase 8a's
    sharded kernels against their plain versions, then phases 8c and 8d
    alone: the one-process step and the pod step over the same shards, for
    a four-card machine, where the shards lie on four cards."""
    from lapis_silo_torch.query.engine import Query
    from lapis_silo_torch.testing import sample_count_queries, synthetic_database

    big = synthetic_database(**DEPLOYMENT)
    wide = sample_count_queries(big, 512, seed=7)
    engine = install_sharded(big, torch, "8a")
    lowered = [engine.lower(Query(q).filter)[0] for q in wide]
    err, timings = {k.name: 0 for k in kernels.KERNELS}, {}
    sharded_kernels(engine, kernels, lowered, mutations_queries(big)[0], err,
                    timings)
    assert all(e == 0 for e in err.values()), err
    step_results = phase8c(main, kernels, torch, engine, lowered[3])
    del engine
    detach(big, torch)
    pod = phase8d(main, kernels, torch, big, wide[3], step_results)
    log("pod done", f"main-path launches {main.launches}, plain-version runs "
        f"{main.plain}; phase 8d " + json.dumps(pod))
    assert not any(main.plain.values()), main.plain


def main() -> int:
    t_start = time.perf_counter()
    import torch

    log("1 env", f"python {sys.version.split()[0]}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this smoke has no CPU path")
    torch.cuda.init()  # every card's allocator, before any memory statistic
    log("1 env", f"card: {nvidia_smi()}; {torch.cuda.device_count()} "
        f"visible")
    device = torch.device(DEVICE)

    import lapis_silo_torch
    from lapis_silo_torch.query.engine import Query
    from lapis_silo_torch.testing import sample_count_queries, synthetic_database
    from lapis_silo_torch.ops import kernels, vm

    if ROOT not in Path(lapis_silo_torch.__file__).resolve().parents:
        raise SystemExit(f"lapis_silo_torch imported from outside {ROOT}")
    main_path = MainPath(kernels)

    t0 = time.perf_counter()
    library = kernels.build()
    kernels.load_library()
    report = [line.strip() for line in
              library.with_suffix(".log").read_text().splitlines()
              if "registers" in line or "Compiling entry" in line]
    log("2 build", f"{time.perf_counter() - t0:.1f} s for "
        f"{library.relative_to(ROOT)}; ptxas: {' | '.join(report)}")
    if sys.argv[1:] == ["--pod"]:
        pod_only(main_path, kernels, torch)
        print(nvidia_smi())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # the bench-default corpus; its launches in phase 3 are comparisons and
    # do not count
    t0 = time.perf_counter()
    db = synthetic_database(**BENCH)
    t_db = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = lapis_silo_torch.install(db, device)
    torch.cuda.synchronize()
    t_resident = time.perf_counter() - t0
    log("3 setup", f"bench corpus {BENCH}: built in {t_db:.1f} s, bank "
        f"{tuple(engine.banks[0].shape)} "
        f"({engine.banks[0].numel() * 4 / 1e9:.3f} GB) "
        f"resident in {t_resident:.1f} s")

    err = phase3_random(kernels, vm, torch, device)
    log("3 kernels", f"random inputs bit-exact against the plain versions: "
        f"max_abs_err {err}")
    wide = sample_count_queries(db, 512, seed=7)
    lowered = [engine.lower(Query(q).filter)[0] for q in wide]
    on_device = [p for p in lowered
                 if engine.host_count(p, allow_interpret=False) is None]
    code, n_instr, banks, dyns, rows, fulls, n_regs, segments = (
        engine.kernel_inputs(engine.batch_args(on_device)))
    vm_inputs = (code, n_instr, banks[0], dyns[0], rows[0], fulls[0], n_regs,
                 segments)
    got, want = kernels.vm_run(*vm_inputs), kernels.vm_run_plain(*vm_inputs)
    err["vm_run"] = max(err["vm_run"], *map(max_abs_err, got, want))
    vm_ms = cuda_ms(lambda: kernels.vm_run(*vm_inputs), reps=20)
    vm_wall_ms = wall_ms(lambda: kernels.vm_run(*vm_inputs), reps=20)
    vm_plain_ms = cuda_ms(lambda: kernels.vm_run_plain(*vm_inputs), reps=2,
                          warmup=0)
    # the same batch as one segment, the serial program: the same words and
    # counts, and what the segments save
    one_segment = kernels.vm_run(*vm_inputs[:-1])
    err["vm_run"] = max(err["vm_run"], *map(max_abs_err, one_segment, got))
    vm_one_ms = cuda_ms(lambda: kernels.vm_run(*vm_inputs[:-1]), reps=5)
    vm_bytes, vm_ops = vm_work(vm, code, n_instr, {
        vm.B_BANK: banks[0].shape[0], vm.B_DYN: dyns[0].shape[0],
        vm.B_SPARSE: rows[0].shape[0]}, engine.n_flat_words, segments)
    mut_filter = engine.device_filter(
        Query(mutations_queries(db)[0]).filter).parts[0]
    meta = engine.segment_meta[("nuc", "main")]
    mut_args = (banks[0], mut_filter, meta["offset"], meta["n_stored"])
    err["mutation_counts"] = max(err["mutation_counts"], max_abs_err(
        kernels.mutation_counts(*mut_args),
        kernels.mutation_counts_plain(*mut_args)))
    mut_ms = cuda_ms(lambda: kernels.mutation_counts(*mut_args), reps=20)
    mut_plain_ms = cuda_ms(lambda: kernels.mutation_counts_plain(*mut_args),
                           reps=3, warmup=1)
    # popcount_rows_and_filter: every bank row against the same filter
    rows_args = (banks[0], mut_filter)
    err["popcount_rows_and_filter"] = max(
        err["popcount_rows_and_filter"], max_abs_err(
            kernels.popcount_rows_and_filter(*rows_args),
            kernels.popcount_rows_and_filter_plain(*rows_args)))
    rows_ms = cuda_ms(lambda: kernels.popcount_rows_and_filter(*rows_args),
                      reps=20)
    rows_plain_ms = cuda_ms(
        lambda: kernels.popcount_rows_and_filter_plain(*rows_args), reps=3,
        warmup=1)
    log("3 kernels", f"main-path shapes bit-exact, max_abs_err {err}; vm_run "
        f"{len(on_device)} programs, {n_instr} instructions in "
        f"{len(segments) - 1} segments, PW {engine.n_flat_words}: kernel "
        f"{vm_ms:.4f} ms (bound {bound(vm_bytes, vm_ops)[0]:.4f} ms, "
        f"{vm_bytes / 1e6:.2f} MB; the wrapper's wall time per call "
        f"{vm_wall_ms:.4f} ms), as one segment {vm_one_ms:.4f} ms, plain "
        f"{vm_plain_ms:.1f} ms; mutation_counts {meta['n_stored']} rows x "
        f"{engine.n_flat_words} words: kernel {mut_ms:.4f} ms "
        f"({meta['n_stored'] * engine.n_flat_words * 4 / mut_ms / 1e6:.0f} "
        f"GB/s), plain {mut_plain_ms:.2f} ms; popcount_rows_and_filter "
        f"{engine.n_rows} rows: kernel {rows_ms:.4f} ms, plain "
        f"{rows_plain_ms:.2f} ms")
    assert all(e == 0 for e in err.values()), err
    pw, n_stored = engine.n_flat_words, meta["n_stored"]
    timings = {"vm_run": (vm_ms, vm_plain_ms, vm_bytes, vm_ops),
               "mutation_counts": (mut_ms, mut_plain_ms,
                                   4 * (n_stored * pw + pw + n_stored),
                                   2 * n_stored * pw),
               "popcount_rows_and_filter": (
                   rows_ms, rows_plain_ms,
                   4 * (engine.n_rows * pw + pw + engine.n_rows),
                   2 * engine.n_rows * pw)}

    # 4: the main path at the bench default
    counts64 = sample_count_queries(db, 64, seed=1)
    muts = mutations_queries(db)
    want64, want_wide, want_muts = (oracle(db, counts64), oracle(db, wide),
                                    oracle(db, muts))
    with main_path.phase():
        run_counts(db, counts64, want64, "4a counts")
        lowered = [engine.lower(Query(q).filter)[0] for q in wide]
        t0 = time.perf_counter()
        wide_counts = engine.count_programs(lowered)
        wide_s = time.perf_counter() - t0
        assert wide_counts == [w["queryResult"][0]["count"] for w in want_wide]
        log("4b wide", f"{len(wide)} queries in one count_programs call equal "
            f"the host oracle; {wide_s * 1e3:.2f} ms ({len(wide) / wide_s:.0f} "
            f"queries/s, lowering excluded)")
        run_mutations(db, muts, want_muts, "4c mutations")
        run_count_calls(db, engine, muts, "4c counts")
        assert db._engine._use_device
    del db, engine
    gc.collect()  # the engine and its database reference each other

    # 5: the dense deployment size
    t0 = time.perf_counter()
    big = synthetic_database(**DEPLOYMENT)
    t_db = time.perf_counter() - t0
    t0 = time.perf_counter()
    big_engine = lapis_silo_torch.install(big, device)
    torch.cuda.synchronize()
    t_resident = time.perf_counter() - t0
    log("5 setup", f"deployment corpus {DEPLOYMENT}: built in {t_db:.1f} s, "
        f"bank {tuple(big_engine.banks[0].shape)} "
        f"({big_engine.banks[0].numel() * 4 / 1e9:.2f} GB) resident in "
        f"{t_resident:.1f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    t0 = time.perf_counter()
    big_answers = {action: (queries, oracle(big, queries)) for action, queries
                   in (("counts", sample_count_queries(big, 64, seed=1)),
                       ("group-by", groupby_queries(big)),
                       ("Details", details_queries(big)),
                       ("Mutations", mutations_queries(big)))}
    log("5 oracle", f"host oracle answered in {time.perf_counter() - t0:.1f} s")
    compaction = compact_kernels(big_engine, kernels, torch, big, err,
                                 timings, "5")
    groupby = {"5": groupby_kernels(big_engine, kernels, torch, big, err,
                                    timings, "5")}
    assert all(e == 0 for e in err.values()), err
    with main_path.phase():
        run_counts(big, *big_answers["counts"], "5a counts")
        run_groupby(big, *big_answers["group-by"], "5b group-by", big_engine)
        run_details(big, big_engine, *big_answers["Details"], "5b details")
        run_mutations(big, *big_answers["Mutations"], "5c mutations")
        run_count_calls(big, big_engine, big_answers["Mutations"][0]
                        + big_answers["Details"][0], "5c counts")
        assert big._engine._use_device
        assert kernels.GROUP_COUNTS.launches > 0
    del big_engine
    detach(big, torch)

    # 8a: the same corpus on the word-sharded engine; 8d: its pod path
    pod_query, step_results = phase8a(main_path, kernels, torch, big,
                                      big_answers, err, timings, groupby)
    pod = phase8d(main_path, kernels, torch, big, pod_query, step_results)
    # 9: the same corpus as a snapshot, served over HTTP
    served_answers = {**big_answers,
                      "Details": (big_answers["Details"][0][:1],
                                  big_answers["Details"][1][:1])}
    served = phase9(main_path, kernels, torch, big, served_answers)
    # 11: the same corpus served by a multi-host slice through the CLI
    sliced = phase11(main_path, kernels, torch, big, served_answers,
                     served.get("native", served["python"]))
    del big
    gc.collect()

    # 7: the two-tier deployment, then 8b: the same on the sharded engine
    answers = phase7(main_path, kernels, torch, device, err, timings, groupby)
    phase8b(main_path, kernels, torch, answers, err)
    assert all(e == 0 for e in err.values()), err
    del answers
    gc.collect()

    # 10: input files ingested by the port, served on the card
    ingested = phase10(main_path, kernels, torch)

    # 6
    loaded = sorted(m for m in sys.modules
                    if m.startswith(JAX_MODULES) and sys.modules[m] is not None)
    log("6 checks", f"main-path launches {main_path.launches}, plain-version "
        f"runs {main_path.plain}, JAX modules loaded {loaded}, total "
        f"{time.perf_counter() - t_start:.0f} s")
    log("6 summary", "K10 and K11 and the compaction sweep "
        + json.dumps(compaction) + "; K9 by date and the group-by split "
        + json.dumps(groupby) + "; phase 8d " + json.dumps(pod)
        + "; phase 9 " + json.dumps(served)
        + "; phase 10 " + json.dumps(ingested) + "; phase 11 "
        + json.dumps(sliced))
    assert all(n for name, n in main_path.launches.items()
               if name not in OFF_PATH), main_path.launches
    assert not any(main_path.launches[name] for name in OFF_PATH), (
        main_path.launches)
    assert not any(main_path.plain.values()), main_path.plain
    assert not loaded, loaded

    print(nvidia_smi())
    # no single PyTorch call computes any of these functions (torch has no
    # popcount, no gather-VM, no CSR popcount or densify, and its nonzero
    # has no cap and waits for the card to learn its output's size), so
    # library_ms is null
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": REPLACES[k.name], "launches": main_path.launches[k.name],
         "max_abs_err": err[k.name], "ms": timings[k.name][0],
         "plain_ms": timings[k.name][1],
         **dict(zip(("bound_ms", "bound_by"), bound(*timings[k.name][2:]))),
         "library_ms": None}
        for k in kernels.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
