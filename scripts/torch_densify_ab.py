#!/usr/bin/env python3
"""A/B of the port's densify kernels (K4 `densify_rows`, K5
`densify_rows_into_pool`) and of the host path that feeds them, between an
earlier tree of `lapis_silo_torch` and this one, in one process on one
NVIDIA GPU.

    mkdir -p build/ab/parent
    git archive <commit> lapis_silo_torch | tar -x -C build/ab/parent
    python3 scripts/torch_densify_ab.py build/ab/parent

The earlier tree is loaded as ``parent_lapis_silo_torch`` by
`torch_vm_ab.load_parent` (its kernels build into
``build/ab/parent/build/torch_kernels``). Both engines serve ONE corpus, the
two-tier deployment of `chip_smoke.py` phase 7 (2,097,152 x 29,903 in 8
partitions, built by this tree's `testing`), from one bank state built by
this tree (the parent's engine takes it, and this tree's lowered programs,
by duck typing). Every case runs in the order parent, change, change,
parent:

  - K4 at phase 7's shape: 1,024 leaves into [1,024, 65,536] words, each
    tree's wrapper on its own engine's device inputs, timed three ways
    (`old`: the parent smoke's events around back-to-back calls; `queued`:
    behind a spin on the card, the device time; `wall`: per call with a
    synchronize at both ends), and each engine's poolless route
    (`_densified`) by wall time per call;
  - K5 at phase 7's shape: one 4,096-leaf update chunk into an 8,193-row
    pool, on the card alone (queued; inputs and slots already on the card,
    the parent's kernel called through its C entry point) and by wall time
    per chunk through each engine's route (the parent: its
    `_eager_update_chunks` body, `_window_stream` and the wrapper with host
    slots per shard; this tree: `_update_pools`);
  - the same two K5 readings at phase 8b's shape (4 word shards of 16,384
    words on the one card);
  - engine calls by median wall time: 7a cold (the 64 count queries of the
    smoke, lowered, one `count_programs` call each from an empty pool), 7b
    pooled (the 512 queries in one `count_programs` call from an empty
    pool) and poolless (`count_dispatches(force_poolless=True)`).

Every result of the change equals the parent's: densified rows, pools, and
counts. The last line is a JSON object of every reading.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import cuda_ms, nvidia_smi, wall_ms  # noqa: E402
from torch_vm_ab import (  # noqa: E402
    ORDER, engine_case, load_parent, log, old_ms,
)

TWO_TIER = dict(n_rows=2097152, length=29903, n_partitions=8)
N_SHARDS = 4
DEVICE = "cuda"


def timed(torch, readings: dict, label: str, variants: dict, methods: tuple,
          reps: int) -> None:
    """Time each variant (name -> (side, fn)) by each method, in ORDER."""
    clocks = {"old": lambda fn: old_ms(torch, fn, reps),
              "queued": lambda fn: cuda_ms(fn, reps),
              "wall": lambda fn: wall_ms(fn, reps)}
    out = {name: {m: [] for m in methods} for name in variants}
    for side in ORDER:
        for name, (v_side, fn) in variants.items():
            if v_side == side:
                for method in methods:
                    out[name][method].append(clocks[method](fn))
    for name, by_method in out.items():
        log(f"{label} {name}: " + "; ".join(
            f"{m} " + " ".join(f"{t:.4f}" for t in ts) + " ms"
            for m, ts in by_method.items()))
    readings[label] = out


def empty_pool(engine) -> None:
    """Every pool slot free and no leaf resident (the pool's memory kept)."""
    with engine._pool_lock:
        engine._leaf_slot.clear()
        engine._protected.clear()
        engine._free_slots = list(range(engine.pool_slots))


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    from lapis_silo_torch.ops import kernels
    from lapis_silo_torch.ops.device_engine import DeviceEngine, build_state
    from lapis_silo_torch.parallel.shards import resolve
    from lapis_silo_torch.query.engine import Query
    from lapis_silo_torch.testing import sample_count_queries, synthetic_database

    load_parent(Path(argv[1]).resolve())
    pkernels = importlib.import_module("parent_lapis_silo_torch.ops.kernels")
    pde = importlib.import_module("parent_lapis_silo_torch.ops.device_engine")
    readings = {"card": card}
    rng = np.random.default_rng(7)
    device = resolve(DEVICE)

    t0 = time.perf_counter()
    db = synthetic_database(**TWO_TIER)
    log(f"two-tier corpus {TWO_TIER} built in {time.perf_counter() - t0:.1f} s")

    def engines(devices):
        state = build_state(db, device, devices=devices)
        return (pde.DeviceEngine(db, device, state=state, devices=devices),
                DeviceEngine(db, device, state=state, devices=devices))

    pengine, engine = engines([device])
    assert engine.n_sparse and engine.pool_slots, "tier not on"
    plib = pkernels.load_library()
    kernels.load_library()
    log(f"n_sparse {engine.n_sparse}, pool_slots {engine.pool_slots}, "
        f"max_sparse_k {engine.max_sparse_k}, update chunk "
        f"{engine._pool_update_k_cap}, stream {engine.sparse_idx.shape[0]} "
        f"entries")

    # K4: both wrappers on their engines' inputs, then the poolless routes
    rows_ids = rng.choice(engine.n_sparse, size=engine.max_sparse_k,
                          replace=False)
    bounds = engine._bounds(rows_ids)
    pargs = (*pengine._window_stream(bounds, 0), engine.n_flat_words, 0)
    cargs = (*engine._stream_on[device],
             *kernels.densify_inputs(bounds, None, device),
             engine.n_flat_words, 0)
    assert torch.equal(pkernels.densify_rows(*pargs),
                       kernels.densify_rows(*cargs)), "K4 rows differ"
    timed(torch, readings, "7 K4 kernel", {
        "parent": ("parent", lambda: pkernels.densify_rows(*pargs)),
        "change": ("change", lambda: kernels.densify_rows(*cargs))},
        ("old", "queued", "wall"), reps=20)
    assert all(torch.equal(a, b) for a, b in zip(
        pengine._densified(rows_ids), engine._densified(rows_ids)))
    timed(torch, readings, "7 K4 route", {
        "parent": ("parent", lambda: pengine._densified(rows_ids)),
        "change": ("change", lambda: engine._densified(rows_ids))},
        ("wall",), reps=20)
    del pargs, cargs

    def pool_cases(label: str, pengine, engine) -> None:
        """K5 on the card and through each engine's route, one chunk."""
        shards = engine.shards
        k_cap = min(engine._pool_update_k_cap, engine.pool_slots)
        ids = rng.choice(engine.n_sparse, size=k_cap, replace=False)
        slots = np.concatenate([[engine.pool_slots], rng.permutation(
            engine.pool_slots)[: k_cap - 1]]).astype(np.int32)
        bounds = engine._bounds(ids)
        old = [torch.randint(-2**31, 2**31 - 1,
                             (engine.pool_slots + 1, shards.local_words),
                             dtype=torch.int32, device=device)
               for _ in shards.devices]
        ppools = [pool.clone() for pool in old]
        cpools = [pool.clone() for pool in old]
        del old
        slots_dev = torch.from_numpy(slots).to(device)
        pinputs = [(*pengine._window_stream(bounds, d), w_off)
                   for d, w_off in enumerate(shards.offsets)]
        cinputs = {d: kernels.densify_inputs(bounds, slots, d)
                   for d in shards.distinct}
        stream = torch.cuda.current_stream(device).cuda_stream

        def parent_kernel():
            for pool, (idx, words, starts, lens, w_off) in zip(ppools,
                                                               pinputs):
                err = plib.lapis_densify_rows_into_pool(
                    idx.data_ptr(), words.data_ptr(), starts.data_ptr(),
                    lens.data_ptr(), starts.shape[0], starts.shape[1],
                    pool.shape[1], w_off, idx.shape[0], slots_dev.data_ptr(),
                    pool.data_ptr(), stream)
                assert err == 0, err

        def change_kernel():
            for pool, d, w_off in zip(cpools, shards.devices, shards.offsets):
                kernels.densify_rows_into_pool(pool, *engine._stream_on[d],
                                               *cinputs[d], w_off)

        def parent_route():
            for d, pool in enumerate(ppools):
                pkernels.densify_rows_into_pool(
                    pool, *pengine._window_stream(pengine._bounds(ids), d),
                    slots.tolist(), shards.offsets[d])

        parent_kernel()
        change_kernel()
        assert all(torch.equal(a, b) for a, b in zip(ppools, cpools)), label
        timed(torch, readings, f"{label} K5 kernel", {
            "parent": ("parent", parent_kernel),
            "change": ("change", change_kernel)}, ("queued",), reps=10)
        timed(torch, readings, f"{label} K5 route", {
            "parent": ("parent", parent_route),
            "change": ("change", lambda: engine._update_pools(cpools, ids,
                                                              slots))},
            ("wall",), reps=10)
        assert all(torch.equal(a, b) for a, b in zip(ppools, cpools)), label
        del ppools, cpools
        torch.cuda.empty_cache()

    pool_cases("7", pengine, engine)

    # the engines' main path: 7a cold and 7b pooled/poolless
    counts64 = sample_count_queries(db, 64, seed=1)
    wide = sample_count_queries(db, 512, seed=7)
    lowered64 = [engine.lower(Query(q).filter)[0] for q in counts64]
    lowered = [engine.lower(Query(q).filter)[0] for q in wide]

    def cold(eng):
        empty_pool(eng)
        return [eng.count_programs([p])[0] for p in lowered64]

    def pooled(eng):
        empty_pool(eng)
        return eng.count_programs(lowered)

    def poolless(eng):
        return eng.count_finish([None] * len(lowered),
                                list(range(len(lowered))),
                                eng.count_dispatches(lowered,
                                                     force_poolless=True))

    for name, fn, reps in (("7a cold, 64 counts", cold, 5),
                           ("7b pooled, 512 queries", pooled, 10),
                           ("7b poolless, 512 queries", poolless, 10)):
        engine_case(readings, f"engine {name}", {
            "parent": lambda fn=fn: fn(pengine),
            "change": lambda fn=fn: fn(engine)}, reps)
    del pengine, engine
    torch.cuda.empty_cache()

    # phase 8b's shape: 4 word shards on the one card
    pengine, engine = engines([device] * N_SHARDS)
    pool_cases("8b", pengine, engine)
    print(json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main(sys.argv))
