#!/usr/bin/env python3
"""A/B of the port's filter VM (K1 `vm_run`, and `vm_run_sharded`) between
an earlier tree of `lapis_silo_torch` and this one, in one process on one
NVIDIA GPU.

    mkdir -p build/ab/parent
    git archive <commit> lapis_silo_torch | tar -x -C build/ab/parent
    python3 scripts/torch_vm_ab.py build/ab/parent

The earlier tree (one whose VM wrappers take the code on the host and the
segment starts) is loaded as ``parent_lapis_silo_torch`` (its kernels
build into ``build/ab/parent/build/torch_kernels``) and serves its own
corpus, built from the same seed as this tree's. Every case runs in the
order parent, change, change, parent:

  kernel cases (the parent's wrapper and this tree's on the same tensors, the
  inputs of this tree's engine), each timed three ways: `old` is the parent
  smoke's cuda_ms (CUDA events around back-to-back calls: host time between
  launches shows where it exceeds the device time), `queued` this smoke's
  (the same calls queued behind a spin on the card, so host time does not
  show), `wall` the wall time per call (synchronize, calls, synchronize);
    - bench: the 512-query batch at the bench default (65,536 x 29,903, one
      partition; the programs the card runs) through K1, in its per-query
      segments and as one segment;
    - long: one filter program of about 500 instructions alone (what
      `evaluate` and a single count launch run), as one segment;
    - 8a: the same two on phase 8a's shapes of `chip_smoke.py` (1,048,576 x
      29,903 in 4 partitions, 4 word shards on one card) through
      vm_run_sharded;
  engine cases at the bench default, wall time per call: count_programs of
  the 512 programs, count_programs of the long program, evaluate of the
  long filter; and a host profile (cProfile) of this tree's wrapper on each
  batch;
  8a's split: each side's vm_run_sharded on the batch under torch.profiler,
  the card's time per call by kernel and copy (the VM launches against the
  memsets, adds and copies around them), and beside it K1 alone over one
  8,192-word shard and, the yardstick, over the whole 32,768 words in one
  launch (the dense deployment's engine runs that), each with its bound
  (chip_smoke.py's vm_work) and achieved rate; K1's occupancy from the
  compiler's register report and its shared memory per CTA;
  8a's probes of K6: the warps a launch aims at per SM (32-256), and the
  batch with its bank rows renumbered to the bank's first rows (the same
  instructions and distinct rows over a few 2 MB pages), K6 against K1.

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
import pstats
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    bound, cuda_ms, nvidia_smi, vm_work, wall_ms)

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


def device_split(torch, label: str, fn, reps: int = 20) -> dict:
    """The card's time per call of fn() in ms, and launches per call, by
    kernel or copy name, as torch.profiler (CUPTI) records `reps` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {e.key[:90]: (e.self_device_time_total / 1e3 / reps,
                          e.count / reps)
             for e in prof.key_averages() if e.self_device_time_total > 0}
    total = sum(ms for ms, _n in split.values())
    log(f"{label} split, {total:.4f} ms per call on the card: " + "; ".join(
        f"{name} {ms:.4f} ms x {n:g}" for name, (ms, n) in
        sorted(split.items(), key=lambda item: -item[1][0])))
    return {"total_ms": total, "split": split}


def occupancy(regs: int, smem_per_cta: int, warps_per_cta: int) -> int:
    """Resident warps per H100 SM for a kernel of `regs` registers a thread
    and `smem_per_cta` bytes of shared memory: registers come in units of
    256 a warp from 65,536, shared memory from 233,472 bytes with 1 KB
    reserved per CTA, at most 32 CTAs and 64 warps."""
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = 65536 // (per_warp * warps_per_cta)
    by_smem = 233472 // (smem_per_cta + 1024)
    return min(by_regs, by_smem, 32, 64 // warps_per_cta) * warps_per_cta


def ptxas_registers(library: Path) -> dict:
    """Registers per thread of each kernel entry, from the build's -Xptxas
    -v report beside the library."""
    out, entry = {}, None
    for line in library.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line and entry:
            out[entry] = int(line.split("Used")[1].split("registers")[0])
    return out


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
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = torch.device(DEVICE)

    import lapis_silo_torch
    from lapis_silo_torch.ops import kernels, vm
    from lapis_silo_torch.query.engine import Query
    from lapis_silo_torch.testing import sample_count_queries, synthetic_database

    parent = load_parent(Path(argv[1]).resolve())
    pkernels = importlib.import_module("parent_lapis_silo_torch.ops.kernels")
    pquery = importlib.import_module("parent_lapis_silo_torch.query.engine")
    ptesting = importlib.import_module("parent_lapis_silo_torch.testing")
    readings = {"card": card}

    # the bench default: both engines, each on its own package's corpus
    db = synthetic_database(**BENCH)
    engine = lapis_silo_torch.install(db, device)
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
        """The batch in its segments and as one segment, and the long
        program as evaluate launches it (alone, no EMIT, one segment), by
        both sides' wrappers on the same inputs; the kernels build at their
        first call, which kernel_case does not time."""
        new, old = ((kernels.vm_run_sharded, pkernels.vm_run_sharded)
                    if sharded else (kernels.vm_run, pkernels.vm_run))
        for case, args in (("batch", eng.batch_args(programs)),
                           ("long", eng._prepare_program(long_prog))):
            inputs = eng.kernel_inputs(args)
            if not sharded:
                code, n_instr, banks, dyns, rows, fulls, n_regs, seg = inputs
                inputs = (code, n_instr, banks[0], dyns[0], rows[0], fulls[0],
                          n_regs, seg)
            forms = [("one segment", inputs[:-1])]
            if inputs[-1] is not None:
                forms.insert(0, ("segments", inputs))
            variants = {}
            for form, form_args in forms:
                variants[f"parent, {form}"] = (
                    "parent", lambda a=form_args: old(*a))
                variants[f"change, {form}"] = (
                    "change", lambda a=form_args: new(*a))
            kernel_case(torch, readings, f"{label} {case}", variants, reps=20)
            if inputs[-1] is not None:
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

    # 8a's split: where each side's vm_run_sharded spends the card's time,
    # then K1 alone over one shard and over the whole axis in one launch
    inputs = engine.kernel_inputs(engine.batch_args(on_device))
    code, n_instr, banks, dyns, rows, fulls, n_regs, segments = inputs
    split = {}
    for side in ORDER[:2]:
        run = (pkernels if side == "parent" else kernels).vm_run_sharded
        split[side] = device_split(torch, f"8a batch {side}",
                                   lambda run=run: run(*inputs))
    n_rows = {vm.B_BANK: banks[0].shape[0], vm.B_DYN: dyns[0].shape[0],
              vm.B_SPARSE: rows[0].shape[0]}
    k1 = {}
    for label, parts in (("one shard", [[a[0]] for a in (banks, dyns, rows,
                                                          fulls)]),
                         ("whole axis", (banks, dyns, rows, fulls))):
        args = [torch.cat(a, dim=-1) if len(a) > 1 else a[0] for a in parts]
        k1_inputs = (code, n_instr, *args, n_regs, segments)
        pw = args[-1].shape[0]
        n_bytes, n_ops = vm_work(vm, code, n_instr, n_rows, pw, segments)
        ms = cuda_ms(lambda: kernels.vm_run(*k1_inputs), reps=20)
        k1[label] = {"pw": pw, "ms": ms, "bound_ms": bound(n_bytes, n_ops)[0],
                     "bytes": n_bytes, "GB_per_s": n_bytes / ms / 1e6}
        del args, k1_inputs
        torch.cuda.empty_cache()
    starts = np.asarray(segments)
    n_rows_read = int(sum(
        ((code[1].numpy()[:n_instr].astype(np.int64) >> vm.WIRE_BSRC_SHIFT)
         & 0xF == src).sum() for src in n_rows))
    regs = {}
    for name, n in ptxas_registers(kernels.library_path()).items():
        form = re.search(r"vm_run_kernelILi(\d+)E", name)
        if form:
            regs[f"L={form[1]}"] = n
    list_cap = int(np.diff(starts).max())
    smem = 4 * 4 * ((n_regs + 1) * 128 + 2 * list_cap + 4096 // 32)
    k1["occupancy"] = {"registers": regs, "smem_per_cta": smem,
                       "warps_per_sm": {form: occupancy(n, smem, 4)
                                        for form, n in regs.items()}}
    log(f"8a K1: {len(starts) - 1} segments, {n_instr} instructions "
        f"(segment lengths min / median / max {np.diff(starts).min()} / "
        f"{int(np.median(np.diff(starts)))} / {np.diff(starts).max()}), "
        f"{n_rows_read} row reads, n_regs {n_regs}; " + "; ".join(
            f"{label}: PW {r['pw']}, {r['ms']:.4f} ms on the card, bound "
            f"{r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.1f} MB), "
            f"{r['GB_per_s']:.0f} GB/s of the bound's bytes"
            for label, r in k1.items() if "pw" in r)
        + f"; K1's registers {regs}, shared memory {smem} bytes per CTA of "
        f"4 warps: {k1['occupancy']['warps_per_sm']} resident warps per SM "
        f"of 64; {card}")
    readings["8a split"] = {"vm_run_sharded": split, "vm_run": k1}

    # probes of what bounds K6 at 8a: the launch's warps per SM (the ranges
    # follow), and the batch with its bank rows renumbered in order
    # (the same instructions and distinct rows, packed at the bank's start:
    # a few 2 MB pages a shard instead of about one per row)
    probes = {}
    default_warps = kernels.K6_WARPS_PER_SM
    for warps in (32, 64, 128, 256):
        kernels.K6_WARPS_PER_SM = warps
        probes[f"K6, {warps} warps a SM"] = cuda_ms(
            lambda: kernels.vm_run_sharded(*inputs), reps=20)
    kernels.K6_WARPS_PER_SM = default_warps
    host = code.numpy().copy()
    specs = host[1, :n_instr].astype(np.int64)
    is_bank = np.flatnonzero(
        ((specs >> vm.WIRE_OP_SHIFT) & 0x3 == vm.ALU)
        & ((specs >> vm.WIRE_BSRC_SHIFT) & 0xF == vm.B_BANK))
    _, packed_rows = np.unique(
        np.clip(host[0, is_bank], 0, n_rows[vm.B_BANK] - 1),
        return_inverse=True)
    host[0, is_bank] = packed_rows.reshape(-1)
    packed = (torch.from_numpy(host), *inputs[1:])
    whole = (packed[0], n_instr, *[torch.cat(a, dim=-1) for a in (
        banks, dyns, rows, fulls)], n_regs, segments)
    k6_words, k6_counts = kernels.vm_run_sharded(*packed)
    k1_words, k1_counts = kernels.vm_run(*whole)
    assert bool((k6_counts == k1_counts).all()) and bool(
        (torch.cat(k6_words) == k1_words).all())
    probes["K6, rows packed"] = cuda_ms(
        lambda: kernels.vm_run_sharded(*packed), reps=20)
    probes["K1 whole axis, rows packed"] = cuda_ms(
        lambda: kernels.vm_run(*whole), reps=20)
    del whole
    torch.cuda.empty_cache()
    log("8a probes, ms on the card: " + "; ".join(
        f"{name} {ms:.4f}" for name, ms in probes.items())
        + f" ({packed_rows.max() + 1} distinct bank rows); {card}")
    readings["8a probes"] = probes

    print(json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
