#!/usr/bin/env python3
"""A/B of the port's filter VM (K1 `vm_run`, and `vm_run_sharded`) between
an earlier tree of `lapis_silo_torch` and this one, in one process on one
NVIDIA GPU.

    mkdir -p build/ab/parent
    git archive <commit> lapis_silo_torch | tar -x -C build/ab/parent
    python3 scripts/torch_vm_ab.py build/ab/parent

The earlier tree is loaded as ``parent_lapis_silo_torch`` (its kernels build
into ``build/ab/parent/build/torch_kernels``); a tree from before the port
kept its own host layers imports ``lapis_silo_tpu``'s jax-free ones, so its
engine is given a corpus of ``lapis_silo_tpu.testing`` and this tree's one
of ``lapis_silo_torch.testing``, both from the same seed. Every case runs in
the order parent, change, change, parent:

  kernel cases (the parent's wrapper and this tree's on the same tensors, the
  inputs of this tree's engine), each timed three ways: `old` is the parent
  smoke's cuda_ms (CUDA events around back-to-back calls: host time between
  launches shows where it exceeds the device time), `queued` this smoke's
  (the same calls queued behind a spin on the card, so host time does not
  show), `wall` the wall time per call (synchronize, calls, synchronize);
    - bench: the 512-query batch at the bench default (65,536 x 29,903, one
      partition; the programs the card runs), the parent's K1 running it
      serially, this tree's in its per-query segments and as one segment;
    - long: one filter program of about 500 instructions alone (what
      `evaluate` and a single count launch run), as one segment;
    - 8a: the same two on phase 8a's shapes of `chip_smoke.py` (1,048,576 x
      29,903 in 4 partitions, 4 word shards on one card) through
      vm_run_sharded;
  engine cases at the bench default, wall time per call: count_programs of
  the 512 programs, count_programs of the long program, evaluate of the
  long filter; and a host profile (cProfile) of this tree's wrapper on each
  batch.

Every result of the change equals the parent's. The last line is a JSON
object of every reading.
"""

from __future__ import annotations

import cProfile
import gc
import importlib
import importlib.util
import io
import json
import os
import pstats
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_ms, nvidia_smi, wall_ms  # noqa: E402

BENCH = dict(n_rows=65536, length=29903, n_partitions=1)
DEPLOYMENT = dict(n_rows=1048576, length=29903, n_partitions=4)
N_SHARDS = 4
DEVICE = "cuda"
ORDER = ("parent", "change", "change", "parent")


def log(message: str) -> None:
    print(f"[ab] {message}", flush=True)


def load_parent(root: Path):
    """The earlier tree's lapis_silo_torch as parent_lapis_silo_torch."""
    package = root / "lapis_silo_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_lapis_silo_torch", package / "__init__.py",
        submodule_search_locations=[str(package)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def old_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """The parent smoke's cuda_ms: events around `reps` back-to-back calls."""
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


def same(got, want) -> bool:
    """Two (words, counts) results equal, words per shard where listed."""
    (gw, gcounts), (ww, wcounts) = got, want
    gw = gw if isinstance(gw, list) else [gw]
    ww = ww if isinstance(ww, list) else [ww]
    return (bool((gcounts.cpu() == wcounts.cpu()).all())
            and all(bool((g.cpu() == w.cpu()).all()) for g, w in zip(gw, ww)))


def kernel_case(torch, readings: dict, label: str, variants: dict,
                reps: int) -> None:
    """Time each variant (name -> (side, fn)) three ways, in ORDER; every
    variant's result must equal the first parent variant's."""
    want = next(fn for side, fn in variants.values() if side == "parent")()
    for name, (_side, fn) in variants.items():
        assert same(fn(), want), f"{label} {name}: results differ"
    out = {name: {"old": [], "queued": [], "wall": []} for name in variants}
    for side in ORDER:
        for name, (v_side, fn) in variants.items():
            if v_side != side:
                continue
            out[name]["old"].append(old_ms(torch, fn, reps))
            out[name]["queued"].append(cuda_ms(fn, reps))
            out[name]["wall"].append(wall_ms(fn, reps))
    for name, methods in out.items():
        log(f"{label} {name}: " + "; ".join(
            f"{method} " + " ".join(f"{t:.4f}" for t in times) + " ms"
            for method, times in methods.items()))
    readings[label] = out


def host_profile(torch, label: str, fn, n: int = 200, top: int = 10) -> None:
    """Where a wrapper's host time goes: cProfile over `n` calls, the `top`
    functions by their own time."""
    profile = cProfile.Profile()
    profile.enable()
    for _ in range(n):
        fn()
    profile.disable()
    torch.cuda.synchronize()
    text = io.StringIO()
    pstats.Stats(profile, stream=text).sort_stats("tottime").print_stats(top)
    log(f"{label} host profile, {n} calls:\n{text.getvalue()}")


def engine_case(readings: dict, label: str, calls: dict, reps: int) -> None:
    """Median wall time per call of each side (name -> fn), in ORDER; the
    sides' answers must be equal."""
    parent, change = calls["parent"](), calls["change"]()
    assert len(parent) == len(change) and all(
        np.array_equal(a, b) for a, b in zip(parent, change)), label
    out = {side: [] for side in calls}
    for side in ORDER:
        fn = calls[side]
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out[side].append(statistics.median(times))
    log(f"{label}: " + "; ".join(
        f"{side} " + " ".join(f"{t:.4f}" for t in times) + " ms"
        for side, times in out.items()))
    readings[label] = out


def long_filter(lower, length: int) -> dict:
    """An Or of NucleotideEquals leaves, as many as keep the lowered program
    within the lowering's 512 instructions (`lower` raises ProgramTooLarge past)."""
    from lapis_silo_torch.ops.vm import ProgramTooLarge

    rng = np.random.default_rng(11)
    leaves = [{"type": "NucleotideEquals", "position": int(p),
               "symbol": "ACGT"[int(s)]}
              for p, s in zip(rng.integers(1, length + 1, size=400),
                              rng.integers(0, 4, size=400))]
    best = None
    for n in range(8, len(leaves) + 1, 8):
        expr = {"type": "Or", "children": leaves[:n]}
        try:
            lower(expr)
        except ProgramTooLarge:
            break
        best = expr
    return best


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        raise SystemExit(__doc__)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = torch.device(DEVICE)

    import lapis_silo_torch
    from lapis_silo_torch.ops import kernels
    from lapis_silo_torch.query.engine import Query
    from lapis_silo_torch.testing import sample_count_queries, synthetic_database

    parent = load_parent(Path(argv[1]).resolve())
    pkernels = importlib.import_module("parent_lapis_silo_torch.ops.kernels")
    pquery = importlib.import_module("parent_lapis_silo_torch.query.engine")
    readings = {"card": card}

    # the bench default: both engines, each on its own package's corpus
    db = synthetic_database(**BENCH)
    engine = lapis_silo_torch.install(db, device)
    ptesting = importlib.import_module(
        "lapis_silo_tpu.testing" if importlib.util.find_spec(
            "parent_lapis_silo_torch.testing") is None
        else "parent_lapis_silo_torch.testing")
    pdb = ptesting.synthetic_database(**BENCH)
    pengine = parent.install(pdb, device)
    wide = sample_count_queries(db, 512, seed=7)
    assert wide == ptesting.sample_count_queries(pdb, 512, seed=7)
    lowered = [engine.lower(Query(q).filter)[0] for q in wide]
    plowered = [pengine.lower(pquery.Query(q).filter)[0] for q in wide]
    on_device = [p for p in lowered
                 if engine.host_count(p, allow_interpret=False) is None]

    def query_json(expr):
        return json.dumps({"action": {"type": "Aggregated"},
                           "filterExpression": expr})

    expr = long_filter(lambda e: engine.lower(Query(query_json(e)).filter)[0],
                       BENCH["length"])
    long_prog = engine.lower(Query(query_json(expr)).filter)[0]
    plong_filter = pquery.Query(query_json(expr)).filter
    plong_prog = pengine.lower(plong_filter)[0]
    assert plong_prog.opcodes == long_prog.opcodes
    log(f"bench: {len(on_device)} of 512 programs on the card; long filter "
        f"{len(expr['children'])} leaves, {len(long_prog.opcodes)} "
        f"instructions")

    def vm_cases(eng, label: str, sharded: bool, programs: list,
                 long_prog) -> None:
        """The batch in its segments, and the long program as evaluate
        launches it (alone, no EMIT, one segment); the kernels build at
        their first call, which kernel_case does not time."""
        for case, args in (("batch", eng.batch_args(programs)),
                           ("long", eng._prepare_program(long_prog))):
            code, n_instr, banks, dyns, rows, fulls, n_regs, segments = (
                eng.kernel_inputs(args))
            if sharded:
                pargs = (code, n_instr, banks, dyns, rows, fulls, n_regs)
                variants = {"parent": ("parent",
                                       lambda: pkernels.vm_run_sharded(*pargs))}
                run = kernels.vm_run_sharded
                cargs = pargs
            else:
                shard = (banks[0], dyns[0], rows[0], fulls[0])
                code_dev = code.to(device)
                variants = {"parent": ("parent", lambda: pkernels.vm_run(
                    code_dev, n_instr, *shard, n_regs))}
                run = kernels.vm_run
                cargs = (code, n_instr, *shard, n_regs)
            if segments is not None:
                variants["change, segments"] = (
                    "change", lambda: run(*cargs, segments))
            variants["change, one segment"] = ("change", lambda: run(*cargs))
            kernel_case(torch, readings, f"{label} {case}", variants, reps=20)
            if segments is not None:
                host_profile(torch, f"{label} {case} change, segments",
                             variants["change, segments"][1])

    vm_cases(engine, "bench", False, on_device, long_prog)
    long_expr = Query(query_json(expr)).filter
    engine_case(readings, "bench engine count_programs 512", {
        "parent": lambda: pengine.count_programs(plowered),
        "change": lambda: engine.count_programs(lowered)}, reps=20)
    engine_case(readings, "bench engine count_programs long", {
        "parent": lambda: pengine.count_programs([plong_prog]),
        "change": lambda: engine.count_programs([long_prog])}, reps=50)
    engine_case(readings, "bench engine evaluate long", {
        "parent": lambda: pengine.evaluate(plong_filter),
        "change": lambda: engine.evaluate(long_expr)}, reps=50)
    for d in (db, pdb):
        d.device_engine = None
        d._engine = None
    del engine, pengine, db, pdb
    gc.collect()
    torch.cuda.empty_cache()

    # phase 8a's shapes: 4 word shards on one card
    big = synthetic_database(**DEPLOYMENT)
    engine = lapis_silo_torch.install(big, device, devices=[device] * N_SHARDS)
    wide = sample_count_queries(big, 512, seed=7)
    lowered = [engine.lower(Query(q).filter)[0] for q in wide]
    on_device = [p for p in lowered
                 if engine.host_count(p, allow_interpret=False) is None]
    expr = long_filter(lambda e: engine.lower(Query(query_json(e)).filter)[0],
                       DEPLOYMENT["length"])
    long_prog = engine.lower(Query(query_json(expr)).filter)[0]
    log(f"8a: {len(on_device)} of 512 programs on the card; long filter "
        f"{len(long_prog.opcodes)} instructions")
    vm_cases(engine, "8a", True, on_device, long_prog)

    print(json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
