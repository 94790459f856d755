#!/usr/bin/env python3
"""Drive the PyTorch port's count and Mutations paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more (the last line is the JSON verdict):
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build the five CUDA kernels from lapis_silo_torch/csrc (one nvcc per
     source, all at once; seconds, and the compiler's register report);
  3. each kernel against its plain PyTorch version on the card, bit-exact
     (tolerance 0: every value is an integer), on random inputs (ragged word
     counts, empty segments, K = 1 and K at the caps, pool slots including
     the scratch row) and at the main paths' shapes, with both times there
     (the two-tier shapes are compared in phase 7's set-up);
  4. the dense main path at the bench default, 65,536 sequences x 29,903
     positions in 1 partition: (a) 64 count queries through
     db.execute_query, one at a time and then from a thread pool so the
     micro-batcher coalesces them, (b) 512 lowered queries through one wide
     count_programs launch, (c) two selective Mutations queries; all equal
     to the host oracle;
  5. the same checks at 1,048,576 sequences x 29,903 positions in 4
     partitions (a dense bank of about 11.8 GB on the card);
  7. the two-tier deployment, 2,097,152 sequences x 29,903 positions in 8
     partitions, whose all-dense bank (about 23.5 GB) exceeds the 12 GiB
     budget, so the engine builds the CSR sparse tier and the hot-leaf pool:
     (a) the 64 counts, cold and then hot, (b) 512 lowered queries through
     count_programs (pooled) and through count_dispatches with
     force_poolless (densified blocks), (c) two Mutations queries; all equal
     to the host oracle;
  6. assertions: every kernel launched during phases 4, 5 and 7 and no plain
     version ran there, no JAX module was imported, the device path stayed
     on.

Each main-path phase runs with the launch counts set to 0 just before it and
read just after; the comparisons between phases are not counted. There is no
CPU path: without a CUDA device the script exits non-zero before phase 2. It
imports the JAX package's host layers (storage, query language, synthetic
corpora), which import no JAX, and asserts that none of its JAX modules was
loaded.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
BENCH = dict(n_rows=65536, length=29903, n_partitions=1)
DEPLOYMENT = dict(n_rows=1048576, length=29903, n_partitions=4)
TWO_TIER = dict(n_rows=2097152, length=29903, n_partitions=8)
# the JAX package's device layer: none of these may be imported
JAX_MODULES = ("jax", "jaxlib", "lapis_silo_tpu.ops.device_engine",
               "lapis_silo_tpu.ops.vm", "lapis_silo_tpu.ops.lowering",
               "lapis_silo_tpu.ops.reductions",
               "lapis_silo_tpu.ops.pallas_kernels", "lapis_silo_tpu.parallel")
REPLACES = {name: f"lapis_silo_tpu/ops/pallas_kernels.py:{line}" for name, line
            in (("vm_run", 526), ("mutation_counts", 150),
                ("sparse_counts", 438), ("densify_rows", 850),
                ("densify_rows_into_pool", 1252))}


def log(phase: str, message: str) -> None:
    print(f"[{phase}] {message}", flush=True)


def nvidia_smi() -> str:
    done = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return done.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events over `reps` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest |got - want| over int32-held words/counts, compared as the
    unsigned values they hold (0 means bit-exact)."""
    import torch

    got = got.to(torch.int64) & 0xFFFFFFFF
    want = want.to(torch.int64) & 0xFFFFFFFF
    return int((got - want).abs().max()) if got.numel() else 0


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


def oracle(db, queries: list[str]) -> list[dict]:
    """The host query engine's answers. The device engine is detached while
    it runs: the Mutations action would otherwise reduce on it."""
    from lapis_silo_tpu.query.engine import QueryEngine

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
    from lapis_silo_tpu.common.symbols import NUCLEOTIDE

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
    for query, expected in zip(queries, want):
        t0 = time.perf_counter()
        got = db.execute_query(query)
        ms = (time.perf_counter() - t0) * 1e3
        assert got == expected, query
        log(phase, f"Mutations ({len(got['queryResult'])} rows) equals the "
            f"host oracle; {ms:.2f} ms")


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
    tail, out-of-range and repeated EMITs, PW 2,048 and ragged PWs; for the
    Mutations kernel unaligned segments; for the sparse kernels empty
    segments, ragged PWs, K = 1, K = 1,024 (the two-tier poolless cap) and a
    4,096-leaf pool update, with pool slots including the scratch row.
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
            args = (dev(code), vm._round_instr(n), dev(bank), dev(dyn),
                    dev(sparse), dev(full), n_regs)
            got = kernels.vm_run(*args)
            want = kernels.vm_run_plain(*args)
            for g, w in zip(got, want):
                err["vm_run"] = max(err["vm_run"], max_abs_err(g, w))
    for pw, start, n_rows in ((2048, 3, 1000), (2045, 1, 999), (77, 0, 1003)):
        bank = dev(rng.integers(0, 1 << 32, size=(1003, pw), dtype=np.uint32))
        filt = dev(rng.integers(0, 1 << 32, size=pw, dtype=np.uint32))
        n_rows = min(n_rows, 1003 - start)
        got = kernels.mutation_counts(bank, filt, start, n_rows)
        want = kernels.mutation_counts_plain(bank, filt, start, n_rows)
        err["mutation_counts"] = max(err["mutation_counts"],
                                     max_abs_err(got, want))
    for n_leaves, n_parts, part_words, n_pool in (
            (1, 1, 131, 1), (37, 3, 2045, 37), (1024, 8, 64, 1500),
            (4096, 8, 16, 4096)):
        idx, words, starts, lens = (dev(a) for a in random_stream(
            rng, n_leaves, n_parts, part_words, 12 if part_words < 100 else 300))
        pw = n_parts * part_words
        filt = dev(rng.integers(0, 1 << 32, size=pw, dtype=np.uint32))
        err["sparse_counts"] = max(err["sparse_counts"], max_abs_err(
            kernels.sparse_counts(idx, words, filt, starts, lens),
            kernels.sparse_counts_plain(idx, words, filt, starts, lens)))
        err["densify_rows"] = max(err["densify_rows"], max_abs_err(
            kernels.densify_rows(idx, words, starts, lens, pw),
            kernels.densify_rows_plain(idx, words, starts, lens, pw)))
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
    torch.cuda.synchronize()
    return err


def two_tier_kernels(engine, kernels, torch, err: dict, timings: dict) -> None:
    """The sparse kernels at the two-tier deployment's shapes, against their
    plain versions, with both times: sparse_counts over the whole stream,
    densify_rows for max_sparse_k leaves, densify_rows_into_pool for one
    _pool_update_k_cap chunk into a pool-sized block (the engine's own pool
    is left alone)."""
    rng = np.random.default_rng(7)
    device = engine.full_masks.device
    pw = engine.n_flat_words
    stream = (engine.sparse_idx, engine.sparse_words)
    filt = torch.from_numpy(rng.integers(0, 1 << 32, size=pw, dtype=np.uint32)
                            .view(np.int32)).to(device)
    args = (*stream, filt, engine._sparse_bounds[0], engine._sparse_bounds[1])
    err["sparse_counts"] = max(err["sparse_counts"], max_abs_err(
        kernels.sparse_counts(*args), kernels.sparse_counts_plain(*args)))
    timings["sparse_counts"] = (
        cuda_ms(lambda: kernels.sparse_counts(*args), reps=20),
        cuda_ms(lambda: kernels.sparse_counts_plain(*args), reps=2, warmup=1))

    leaves = rng.choice(engine.n_sparse, size=engine.max_sparse_k,
                        replace=False)
    bounds = engine._bounds_on_device(engine._bounds(leaves))
    err["densify_rows"] = max(err["densify_rows"], max_abs_err(
        kernels.densify_rows(*stream, *bounds, pw),
        kernels.densify_rows_plain(*stream, *bounds, pw)))
    timings["densify_rows"] = (
        cuda_ms(lambda: kernels.densify_rows(*stream, *bounds, pw), reps=20),
        cuda_ms(lambda: kernels.densify_rows_plain(*stream, *bounds, pw),
                reps=2, warmup=1))

    k_cap = min(engine._pool_update_k_cap, engine.pool_slots)
    leaves = rng.choice(engine.n_sparse, size=k_cap, replace=False)
    bounds = engine._bounds_on_device(engine._bounds(leaves))
    slots = np.concatenate([[engine.pool_slots], rng.permutation(
        engine.pool_slots)[: k_cap - 1]]).tolist()
    pool = torch.randint(-2**31, 2**31 - 1, (engine.pool_slots + 1, pw),
                         dtype=torch.int32, device=device)
    want = pool.clone()
    kernels.densify_rows_into_pool(pool, *stream, *bounds, slots)
    kernels.densify_rows_into_pool_plain(want, *stream, *bounds, slots)
    err["densify_rows_into_pool"] = max(err["densify_rows_into_pool"],
                                        max_abs_err(pool, want))
    timings["densify_rows_into_pool"] = (
        cuda_ms(lambda: kernels.densify_rows_into_pool(
            pool, *stream, *bounds, slots), reps=10),
        cuda_ms(lambda: kernels.densify_rows_into_pool_plain(
            want, *stream, *bounds, slots), reps=2, warmup=1))
    log("7 kernels", f"two-tier shapes bit-exact, max_abs_err {err}; "
        f"sparse_counts {engine.n_sparse} leaves x {engine.n_partitions} "
        f"segments over {stream[0].shape[0]} entries "
        f"({8 * stream[0].shape[0] / 1e9:.3f} GB): kernel "
        f"{timings['sparse_counts'][0]:.4f} ms, plain "
        f"{timings['sparse_counts'][1]:.2f} ms; densify_rows "
        f"{engine.max_sparse_k} leaves x {pw} words: kernel "
        f"{timings['densify_rows'][0]:.4f} ms, plain "
        f"{timings['densify_rows'][1]:.2f} ms; densify_rows_into_pool "
        f"{k_cap} leaves into {engine.pool_slots + 1} rows: kernel "
        f"{timings['densify_rows_into_pool'][0]:.4f} ms, plain "
        f"{timings['densify_rows_into_pool'][1]:.2f} ms")
    del pool, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase7(main: MainPath, kernels, torch, device, err: dict,
           timings: dict) -> None:
    """The two-tier deployment: set-up, kernel comparisons at its shapes,
    then the main path against the host oracle."""
    import lapis_silo_torch
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.testing import sample_count_queries, synthetic_database

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
        f"{n_dense} (bank {tuple(engine.bank.shape)}), stream {n_entries} "
        f"entries ({8 * n_entries / 1e9:.3f} GB), pool_slots "
        f"{engine.pool_slots} ({(engine.pool_slots + 1) * 4 * engine.n_flat_words / 1e9:.2f} GB), "
        f"max_sparse_k {engine.max_sparse_k}, pool update chunk "
        f"{engine._pool_update_k_cap}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    assert engine.n_sparse > 0 and engine.pool_slots > 0, "tier not on"
    two_tier_kernels(engine, kernels, torch, err, timings)

    counts64 = sample_count_queries(db, 64, seed=1)
    wide = sample_count_queries(db, 512, seed=7)
    muts = mutations_queries(db)
    t0 = time.perf_counter()
    want64, want_wide, want_muts = (oracle(db, counts64), oracle(db, wide),
                                    oracle(db, muts))
    log("7 oracle", f"host oracle answered in {time.perf_counter() - t0:.1f} s")
    want_wide = [w["queryResult"][0]["count"] for w in want_wide]
    lowered = [engine.lower(Query(q).filter)[0] for q in wide]
    torch.cuda.reset_peak_memory_stats()  # the comparisons' temporaries
    with main.phase():
        for label in ("cold", "hot"):
            hits, misses = engine.pool_hits, engine.pool_misses
            run_counts(db, counts64, want64, f"7a {label}")
            log(f"7a {label}", f"pool hits {engine.pool_hits - hits}, misses "
                f"{engine.pool_misses - misses}")
        launches = kernels.DENSIFY_INTO_POOL.launches
        hits, misses = engine.pool_hits, engine.pool_misses
        t0 = time.perf_counter()
        got = engine.count_programs(lowered)
        wide_s = time.perf_counter() - t0
        assert got == want_wide
        n_updates = kernels.DENSIFY_INTO_POOL.launches - launches
        assert n_updates > 0, "the wide batch did not ride the pool"
        log("7b pooled", f"{len(wide)} queries in one count_programs call equal "
            f"the host oracle; {wide_s * 1e3:.2f} ms "
            f"({len(wide) / wide_s:.0f} queries/s, lowering excluded); "
            f"{n_updates} pool updates, pool hits {engine.pool_hits - hits}, "
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
        log("7b poolless", f"the same {len(wide)} through count_dispatches("
            f"force_poolless=True) equal the host oracle; {wide_s * 1e3:.2f} ms "
            f"({len(wide) / wide_s:.0f} queries/s); {n_blocks} densified blocks")
        run_mutations(db, muts, want_muts, "7c mutations")
        assert db._engine._use_device
    log("7 done", f"peak device memory over 7a-7c "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (stream, pool, "
        f"densified blocks)")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    log("1 env", f"python {sys.version.split()[0]}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this smoke has no CPU path")
    log("1 env", f"card: {nvidia_smi()}")
    device = torch.device(DEVICE)

    import lapis_silo_torch
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.testing import sample_count_queries, synthetic_database
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
        f"{tuple(engine.bank.shape)} ({engine.bank.numel() * 4 / 1e9:.3f} GB) "
        f"resident in {t_resident:.1f} s")

    err = phase3_random(kernels, vm, torch, device)
    log("3 kernels", f"random inputs bit-exact against the plain versions: "
        f"max_abs_err {err}")
    wide = sample_count_queries(db, 512, seed=7)
    lowered = [engine.lower(Query(q).filter)[0] for q in wide]
    on_device = [p for p in lowered
                 if engine.host_count(p, allow_interpret=False) is None]
    vm_inputs = engine.kernel_inputs(engine.batch_args(on_device))
    got, want = kernels.vm_run(*vm_inputs), kernels.vm_run_plain(*vm_inputs)
    err["vm_run"] = max(err["vm_run"], *map(max_abs_err, got, want))
    vm_ms = cuda_ms(lambda: kernels.vm_run(*vm_inputs), reps=20)
    vm_plain_ms = cuda_ms(lambda: kernels.vm_run_plain(*vm_inputs), reps=2,
                          warmup=0)
    mut_filter = engine.device_filter(
        Query(mutations_queries(db)[0]).filter).words
    meta = engine.segment_meta[("nuc", "main")]
    mut_args = (engine.bank, mut_filter, meta["offset"], meta["n_stored"])
    err["mutation_counts"] = max(err["mutation_counts"], max_abs_err(
        kernels.mutation_counts(*mut_args),
        kernels.mutation_counts_plain(*mut_args)))
    mut_ms = cuda_ms(lambda: kernels.mutation_counts(*mut_args), reps=20)
    mut_plain_ms = cuda_ms(lambda: kernels.mutation_counts_plain(*mut_args),
                           reps=3, warmup=1)
    log("3 kernels", f"main-path shapes bit-exact, max_abs_err {err}; vm_run "
        f"{len(on_device)} programs, {vm_inputs[1]} instructions, PW "
        f"{engine.n_flat_words}: kernel {vm_ms:.4f} ms, plain "
        f"{vm_plain_ms:.1f} ms; mutation_counts {meta['n_stored']} rows x "
        f"{engine.n_flat_words} words: kernel {mut_ms:.4f} ms "
        f"({meta['n_stored'] * engine.n_flat_words * 4 / mut_ms / 1e6:.0f} "
        f"GB/s), plain {mut_plain_ms:.2f} ms")
    assert all(e == 0 for e in err.values()), err
    timings = {"vm_run": (vm_ms, vm_plain_ms),
               "mutation_counts": (mut_ms, mut_plain_ms)}

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
        f"bank {tuple(big_engine.bank.shape)} "
        f"({big_engine.bank.numel() * 4 / 1e9:.2f} GB) resident in "
        f"{t_resident:.1f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    big_counts = sample_count_queries(big, 64, seed=1)
    big_muts = mutations_queries(big)[:1]
    t0 = time.perf_counter()
    big_want, big_want_muts = oracle(big, big_counts), oracle(big, big_muts)
    log("5 oracle", f"host oracle answered in {time.perf_counter() - t0:.1f} s")
    with main_path.phase():
        run_counts(big, big_counts, big_want, "5a counts")
        run_mutations(big, big_muts, big_want_muts, "5c mutations")
        assert big._engine._use_device
    del big, big_engine
    gc.collect()
    torch.cuda.empty_cache()

    # 7: the two-tier deployment
    phase7(main_path, kernels, torch, device, err, timings)
    assert all(e == 0 for e in err.values()), err
    gc.collect()

    # 6
    loaded = sorted(m for m in sys.modules
                    if m.startswith(JAX_MODULES) and sys.modules[m] is not None)
    log("6 checks", f"main-path launches {main_path.launches}, plain-version "
        f"runs {main_path.plain}, JAX modules loaded {loaded}, total "
        f"{time.perf_counter() - t_start:.0f} s")
    assert all(main_path.launches.values()), main_path.launches
    assert not any(main_path.plain.values()), main_path.plain
    assert sys.modules.get("jax") is None and not loaded, loaded

    print(nvidia_smi())
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": REPLACES[k.name], "launches": main_path.launches[k.name],
         "max_abs_err": err[k.name], "ms": timings[k.name][0],
         "plain_ms": timings[k.name][1]}
        for k in kernels.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
