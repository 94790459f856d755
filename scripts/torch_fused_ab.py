#!/usr/bin/env python3
"""The filter's VM launch with its epilogue (`kernels.vm_filter_sharded`:
the words' total and each shard's compact blocks from the launch that
writes the filter) against what it replaced, an earlier tree's VM launch
followed by K11 (`popcount_words_sharded`) or by K10
(`compact_nonzero_sharded`), in one process on one NVIDIA GPU.

    mkdir -p build/ab/parent
    git archive <commit> lapis_silo_torch | tar -x -C build/ab/parent
    python3 scripts/torch_fused_ab.py build/ab/parent

The earlier tree (one with K10 and K11 in `csrc/compact.cu`) is loaded as
``parent_lapis_silo_torch``; its kernels build into
``build/ab/parent/build/torch_kernels``. Every case times its functions
in turns: each in order, then in the reverse order, twice; each reading
is the median of its four:

  kernels: a 12-instruction filter program over synthetic bank rows (its
  result a row with 400 or 16,384 non-zero words) at 32,768 flat words
  (phase 5 of `chip_smoke.py`, one shard), 4 x 8,192 (phase 8a, 4 shards
  of one card), 312,512 (the 10,000,000 x 32-partition corpus' flat axis,
  one shard) and 1,048,576 (one shard); card time per call, queued
  (`chip_smoke.cuda_ms`): the VM alone on each side; the parent's VM and
  K11 against the change's VM with its total; the parent's VM and K10
  against the change's VM with its total and compact blocks (cap 16,384);
  whole calls (wall per call, host included) at 131,072 (the port's
  `COMPACT_MIN_WORDS`), 312,512 and 1,048,576 flat words (one shard),
  which check the threshold against the change's route: the parent's VM,
  K10, the copy of the blocks and the host's rebuild (`compact_to_host`);
  the change's VM with its blocks, the copy and the rebuild
  (`blocks_to_host`); and the bitset's copy after the change's VM
  (`evaluate()`'s route below the threshold);
  batches: the 512-query batch on the card, queued, through K1 at the bench
  default (65,536 x 29,903, one partition) and through K6 at phase 8a's
  shapes (1,048,576 x 29,903 in 4 partitions on 4 shards of one card), on
  this tree's engine's inputs: the kernels the epilogue left as they were.

Every result of the change equals the parent's. The last line is a JSON
object of every reading.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
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
CAP = 16384
FILLS = (400, CAP)
# (flat words, shards): phase 5's, phase 8a's, a large one-shard corpus
KERNEL_CASES = ((32768, 1), (32768, 4), (312512, 1), (1048576, 1))
CALL_WORDS = (131072, 312512, 1048576)


def log(message: str) -> None:
    print(f"[fused-ab] {message}", flush=True)


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


def turns(fns: dict, timer, reps: int) -> dict:
    """{name: median} of the readings by `timer` of each function of `fns`
    ({name: fn}), taken in order, then in reverse, twice."""
    names = list(fns)
    times = {name: [] for name in names}
    for name in (names + names[::-1]) * 2:
        times[name].append(timer(fns[name], reps))
    return {name: statistics.median(t) for name, t in times.items()}


def program(vm):
    """A 12-instruction filter over bank rows 0-5 whose reg[0] is row 0 (the
    others and the full mask all take part): the wire code [2, 16]."""
    ops = [vm.ALU] * 12
    spec = [
        0 | (vm.M_MOVB << 24) | (vm.B_BANK << 28),               # r0 = b0
        1 | (vm.M_MOVB << 24) | (vm.B_BANK << 28),               # r1 = b2
        1 | 1 << 8 | (vm.M_AND << 24) | (vm.B_BANK << 28),       # r1 &= b3
        2 | (vm.M_MOVB << 24) | (vm.B_BANK << 28),               # r2 = b4
        2 | 2 << 8 | (vm.M_OR << 24) | (vm.B_BANK << 28),        # r2 |= b5
        1 | 1 << 8 | 2 << 16 | (vm.M_AND << 24) | (vm.B_REG << 28),
        3 | 1 << 8 | 1 << 16 | (vm.M_XOR << 24) | (vm.B_REG << 28),  # r3 = 0
        0 | (vm.M_AND << 24) | (vm.B_BANK << 28),                # r0 &= b1
        0 | 3 << 16 | (vm.M_OR << 24) | (vm.B_REG << 28),        # r0 |= r3
        0 | 3 << 16 | (vm.M_ANDN << 24) | (vm.B_REG << 28),  # ANDN
        2 | (vm.M_MOVB << 24) | (vm.B_FULL << 28),               # r2 = full
        0 | 2 << 16 | (vm.M_AND << 24) | (vm.B_REG << 28),       # r0 &= r2
    ]
    operands = [0, 2, 3, 4, 5, 0, 0, 1, 0, 0, 0, 0]
    return vm.pack_code_array(16, ops, operands, spec), len(ops)


def synthetic(torch, vm, rng, n_words: int, n_shards: int, n_hot: int,
              device):
    """The kernels' inputs over `n_shards` equal shards of `n_words` flat
    words: 8 bank rows (row 0 with `n_hot` non-zero words, row 1 all ones,
    rows 2-5 random), one zero dyn row, one zero sparse row, a full mask
    of ones; and the shards' offsets."""
    bank = rng.integers(0, 1 << 32, size=(8, n_words), dtype=np.uint32)
    bank[0] = 0
    hot = rng.choice(n_words, size=n_hot, replace=False)
    bank[0, hot] = rng.integers(1, 1 << 32, size=n_hot, dtype=np.uint64)
    bank[1] = 0xFFFFFFFF
    local = n_words // n_shards

    def shards(a):
        return [torch.from_numpy(np.ascontiguousarray(
            a[..., d * local:(d + 1) * local]).view(np.int32)).to(device)
            for d in range(n_shards)]

    zero = np.zeros((1, n_words), dtype=np.uint32)
    code, n_instr = program(vm)
    inputs = (torch.from_numpy(code), n_instr, shards(bank), shards(zero),
              shards(zero), shards(np.full(n_words, 0xFFFFFFFF, np.uint32)),
              4)
    return inputs, [d * local for d in range(n_shards)], bank[0]


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = torch.device("cuda")

    import lapis_silo_torch
    from lapis_silo_torch.ops import device_engine as de
    from lapis_silo_torch.ops import kernels, vm
    from lapis_silo_torch.ops.words import to_host
    from lapis_silo_torch.parallel.shards import gather_words
    from lapis_silo_torch.query.engine import Query
    from lapis_silo_torch.testing import sample_count_queries, synthetic_database

    load_parent(Path(argv[1]).resolve())
    pk = importlib.import_module("parent_lapis_silo_torch.ops.kernels")
    pde = importlib.import_module("parent_lapis_silo_torch.ops.device_engine")
    t0 = time.perf_counter()
    kernels.load_library()
    pk.load_library()
    log(f"both trees' kernels built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(15)
    readings = {"card": card, "kernels": [], "calls": [], "batches": {}}

    for n_words, n_shards in KERNEL_CASES:
        for n_hot in FILLS:
            args, offsets, want = synthetic(torch, vm, rng, n_words,
                                            n_shards, n_hot, device)

            def vm_parent():
                return pk.vm_run_sharded(*args)

            def vm_change():
                return kernels.vm_run_sharded(*args)

            def total_parent():
                return pk.popcount_words_sharded(vm_parent()[0])

            def total_change():
                return kernels.vm_filter_sharded(*args).total

            def compact_parent():
                return pk.compact_nonzero_sharded(vm_parent()[0], offsets, CAP)

            def compact_change():
                return kernels.vm_filter_sharded(*args, offsets=offsets,
                                                 cap=CAP).blocks

            words = torch.cat([w.cpu() for w in vm_change()[0]]).numpy()
            assert np.array_equal(words.view(np.uint32), want)
            assert int(total_parent()) == int(total_change()) == int(
                np.bitwise_count(want).sum())
            for g, w in zip(compact_change(), compact_parent()):
                assert torch.equal(g.cpu(), w.cpu()), (n_words, n_hot)
            row = {"words": n_words, "shards": n_shards, "nonzero": n_hot}
            row.update(turns({
                "vm_parent": vm_parent, "vm_change": vm_change,
                "vm_and_k11_parent": total_parent,
                "vm_total_change": total_change,
                "vm_and_k10_parent": compact_parent,
                "vm_compact_change": compact_change}, cuda_ms, 50))
            readings["kernels"].append(row)
            log(json.dumps(row))
            del args
            torch.cuda.empty_cache()

    for n_words in CALL_WORDS:
        for n_hot in FILLS:
            inputs, offsets, want = synthetic(torch, vm, rng, n_words, 1,
                                              n_hot, device)

            def call_parent():
                return pde.compact_to_host(pk.vm_run_sharded(*inputs)[0],
                                           offsets, CAP, n_words)

            def call_change():
                return de.blocks_to_host(kernels.vm_filter_sharded(
                    *inputs, offsets=offsets, cap=CAP).blocks, CAP, n_words)

            def call_copy():
                return to_host(gather_words(kernels.vm_run_sharded(
                    *inputs)[0], "cpu"))

            fns = {"parent": call_parent, "change": call_change,
                   "copy": call_copy}
            for fn in fns.values():
                assert np.array_equal(fn(), want), fn
                # warmed with as many calls as are timed (pinned blocks)
                wall_ms(fn, reps=20, warmup=20)
            row = {"words": n_words, "nonzero": n_hot}
            row.update(turns(fns, wall_ms, 20))
            readings["calls"].append(row)
            log(f"whole call {json.dumps(row)}")
            del inputs
            torch.cuda.empty_cache()
    readings["compaction_wins"] = sorted(
        {r["words"] for r in readings["calls"]}
        - {r["words"] for r in readings["calls"] if r["change"] >= r["copy"]})
    log(f"the change's compaction faster than the bitset copy at both fills "
        f"at {readings['compaction_wins']} flat words")

    for label, corpus, devices in (
            ("bench K1", BENCH, None),
            ("8a K6", DEPLOYMENT, [device] * 4)):
        db = synthetic_database(**corpus)
        engine = lapis_silo_torch.install(db, device, devices=devices)
        lowered = [engine.lower(Query(q).filter)[0]
                   for q in sample_count_queries(db, 512, seed=7)]
        on_device = [p for p in lowered
                     if engine.host_count(p, allow_interpret=False) is None]
        inputs = engine.kernel_inputs(engine.batch_args(on_device))
        if devices is None:
            code, n_instr, banks, dyns, rows, fulls, n_regs, seg = inputs
            inputs = (code, n_instr, banks[0], dyns[0], rows[0], fulls[0],
                      n_regs, seg)
            new, old = kernels.vm_run, pk.vm_run
        else:
            new, old = kernels.vm_run_sharded, pk.vm_run_sharded
        got, want = new(*inputs), old(*inputs)
        for g, w in zip(got, want):
            for a, b in zip(g if isinstance(g, list) else [g],
                            w if isinstance(w, list) else [w]):
                assert torch.equal(a.cpu(), b.cpu()), label
        row = turns({"parent": lambda: old(*inputs),
                     "change": lambda: new(*inputs)}, cuda_ms, 20)
        row["ratio"] = row["change"] / row["parent"]
        readings["batches"][label] = row
        log(f"batch {label}: {json.dumps(row)}")
        db.device_engine = None
        db._engine = None
        del engine, db, inputs, got, want
        gc.collect()
        torch.cuda.empty_cache()

    log(f"done; {card}")
    print(card)
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
