#!/usr/bin/env python3
"""Drive the PyTorch port's count and Mutations path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (the last line is the JSON verdict):
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build both CUDA kernels from lapis_silo_torch/csrc (seconds, and the
     compiler's register/shared-memory report);
  3. each kernel against its plain PyTorch version on the card, bit-exact
     (tolerance 0: every value is an integer), on random inputs and at the
     main path's shapes, with both times at those shapes;
  4. the main path at the bench default, 65,536 sequences x 29,903 positions
     in 1 partition: (a) 64 count queries through db.execute_query, one at a
     time and then from a thread pool so the micro-batcher coalesces them,
     (b) 512 lowered queries through one wide count_programs launch, (c) two
     selective Mutations queries; all equal to the host oracle;
  5. the same checks at 1,048,576 sequences x 29,903 positions in 4
     partitions (a dense bank of about 11.8 GB on the card);
  6. assertions: both kernels launched during phases 4-5 and their plain
     versions did not, no JAX module was imported, the device path stayed on.

There is no CPU path: without a CUDA device the script exits non-zero before
phase 2. It imports the JAX package's host layers (storage, query language,
synthetic corpora), which import no JAX, and asserts that none of its JAX
modules was loaded.
"""

from __future__ import annotations

import concurrent.futures
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
# the JAX package's device layer: none of these may be imported
JAX_MODULES = ("jax", "jaxlib", "lapis_silo_tpu.ops.device_engine",
               "lapis_silo_tpu.ops.vm", "lapis_silo_tpu.ops.lowering",
               "lapis_silo_tpu.ops.reductions",
               "lapis_silo_tpu.ops.pallas_kernels", "lapis_silo_tpu.parallel")


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


def phase3_random(kernels, vm, torch, device) -> dict[str, int]:
    """Both kernels against their plain versions on random inputs covering
    every mode and b-source, n_regs 4/8/16/32, clamped operands, the NOP
    tail, out-of-range and repeated EMITs, PW 2,048 and ragged PWs, and
    unaligned Mutations segments. Returns the largest error per kernel."""
    rng = np.random.default_rng(0)
    err = {"vm_run": 0, "mutation_counts": 0}

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
    torch.cuda.synchronize()
    return err


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

    t0 = time.perf_counter()
    library = kernels.build()
    kernels.load_library()
    report = [line.strip() for line in
              library.with_suffix(".log").read_text().splitlines()
              if "registers" in line or "Compiling entry" in line]
    log("2 build", f"{time.perf_counter() - t0:.1f} s for "
        f"{library.relative_to(ROOT)}; ptxas: {' | '.join(report)}")

    # the bench-default corpus; its launches in phase 3 are comparisons and
    # do not count (the counts are reset before phase 4)
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

    # 4: the main path at the bench default
    counts64 = sample_count_queries(db, 64, seed=1)
    muts = mutations_queries(db)
    want64, want_wide, want_muts = (oracle(db, counts64), oracle(db, wide),
                                    oracle(db, muts))
    kernels.reset_counts()
    run_counts(db, counts64, want64, "4a counts")
    lowered = [engine.lower(Query(q).filter)[0] for q in wide]
    t0 = time.perf_counter()
    wide_counts = engine.count_programs(lowered)
    wide_s = time.perf_counter() - t0
    assert wide_counts == [w["queryResult"][0]["count"] for w in want_wide]
    log("4b wide", f"{len(wide)} queries in one count_programs call equal the "
        f"host oracle; {wide_s * 1e3:.2f} ms ({len(wide) / wide_s:.0f} "
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
    run_counts(big, big_counts, big_want, "5a counts")
    run_mutations(big, big_muts, big_want_muts, "5c mutations")
    assert big._engine._use_device
    launches = {k.name: k.launches for k in kernels.KERNELS}
    plain = {k.name: k.plain_launches for k in kernels.KERNELS}
    del big, big_engine

    # 6
    loaded = sorted(m for m in sys.modules
                    if m.startswith(JAX_MODULES) and sys.modules[m] is not None)
    log("6 checks", f"main-path launches {launches}, plain-version runs "
        f"{plain}, JAX modules loaded {loaded}, total "
        f"{time.perf_counter() - t_start:.0f} s")
    assert all(launches.values()), launches
    assert not any(plain.values()), plain
    assert sys.modules.get("jax") is None and not loaded, loaded

    timings = {"vm_run": (vm_ms, vm_plain_ms),
               "mutation_counts": (mut_ms, mut_plain_ms)}
    replaces = {"vm_run": "lapis_silo_tpu/ops/pallas_kernels.py:526",
                "mutation_counts": "lapis_silo_tpu/ops/pallas_kernels.py:150"}
    print(nvidia_smi())
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": replaces[k.name], "launches": launches[k.name],
         "max_abs_err": err[k.name], "ms": timings[k.name][0],
         "plain_ms": timings[k.name][1]}
        for k in kernels.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
