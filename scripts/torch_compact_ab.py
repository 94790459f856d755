#!/usr/bin/env python3
"""K10 (`compact_nonzero`) and K11 (`popcount_words`) against the torch-op
chains they replace, in one process on one NVIDIA GPU.

    python3 scripts/torch_compact_ab.py

The chains are the plain versions in `lapis_silo_torch/ops/reductions.py`
(`compact_nonzero`: a compare, a cumsum, a scatter and a gather per shard,
then `torch.stack`; `popcount_words`: the SWAR chain of `ops/words.py` and a
sum per shard, then the shards' sum): what the engine ran on the card before
K10 and K11. On synthetic flat words at 32,768 (phase 5 of `chip_smoke.py`,
one shard), 4 x 8,192 (phase 8a, 4 shards of one card) and the compaction
sweep's 131,072, 312,512, 1,048,576 and 4,194,304 words, with 400 and
16,384 (the cap) non-zero words, each case in the order chain, kernel,
kernel, chain:

  card: ms on the card, queued (chip_smoke.py's cuda_ms), for K10, K10 with
  its scratch zeroed by a fill before each launch instead of by the launch
  before (`memset`), the compaction chain, K11 and the popcount chain; each
  kernel's bound (chip_smoke.py's compact_bound; the words' bytes for K11);
  whole calls (wall per call, host included): the bitset copy (evaluate()'s
  route), the extraction with K10 (device_engine.compact_to_host: K10, one
  copy of the blocks into pinned memory, the host's rebuild), the parent's
  extraction (the chain, torch.stack, a copy into pageable memory, the
  rebuild), and two parts of the new one: K10 with its copy alone, and the
  host's rebuild alone (device_engine.rebuild_from_blocks and the reshape
  into partitions).

Every kernel result equals its chain's. The last line is a JSON object of
every reading.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    HBM_BYTES_PER_S, bound, compact_bound, cuda_ms, nvidia_smi, wall_ms)

CAP = 16384
CASES = ((32768, 1), (32768, 4), (131072, 1), (312512, 1), (1048576, 1),
         (4194304, 1))
FILLS = (400, CAP)


def log(message: str) -> None:
    print(f"[compact-ab] {message}", flush=True)


def abba(first, second, reps: int, timer) -> tuple[float, float]:
    """Medians of (first, second, second, first) x 2 readings by `timer`."""
    times = {0: [], 1: []}
    for which in (0, 1, 1, 0) * 2:
        times[which].append(timer((first, second)[which], reps))
    return statistics.median(times[0]), statistics.median(times[1])


def main() -> int:
    import torch

    from lapis_silo_torch.ops import kernels, reductions
    from lapis_silo_torch.ops.device_engine import (
        compact_to_host, rebuild_from_blocks)
    from lapis_silo_torch.ops.words import to_host
    from lapis_silo_torch.parallel.shards import gather_words, reduce_sum

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    device = torch.device("cuda")
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}")
    t0 = time.perf_counter()
    kernels.load_library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    lib = kernels.load_library()
    rng = np.random.default_rng(14)
    rows = []
    for n_words, n_shards in CASES:
        for n_hot in FILLS:
            host = np.zeros(n_words, dtype=np.uint32)
            host[rng.choice(n_words, size=n_hot, replace=False)] = (
                rng.integers(1, 1 << 32, size=n_hot, dtype=np.uint64)
                .astype(np.uint32))
            flat = torch.from_numpy(host.view(np.int32)).to(device)
            local = n_words // n_shards
            words = [flat[d * local:(d + 1) * local].clone()
                     for d in range(n_shards)]
            offsets = [d * local for d in range(n_shards)]

            def chain():
                return torch.stack([reductions.compact_nonzero(w, CAP, o)
                                    for w, o in zip(words, offsets)])

            def kernel():
                return kernels.compact_nonzero_sharded(words, offsets, CAP)[0]

            rows_t, n_tiles = kernels.compact_layout(
                tuple(w.shape[0] for w in words), kernels._heads(words))
            scratch = torch.zeros(1 + n_tiles, dtype=torch.int64,
                                  device=device)
            blocks = torch.empty((n_shards, 1 + 2 * CAP), dtype=torch.int32,
                                 device=device)
            table = kernels.compact_table(words, blocks, offsets, rows_t)
            stream = torch.cuda.current_stream().cuda_stream

            def memset():
                scratch.zero_()
                err = lib.lapis_compact_nonzero(
                    table, n_shards, n_tiles, CAP, scratch.data_ptr(), None,
                    0, stream)
                assert err == 0, err
                return blocks

            def pop_chain():
                return reduce_sum([reductions.popcount_words(w)
                                   for w in words], device)

            def pop_kernel():
                return kernels.popcount_words_sharded(words)

            want = chain()
            assert torch.equal(kernel(), want) and torch.equal(memset(), want)
            assert int(pop_kernel()) == int(pop_chain())
            chain_ms, k10_ms = abba(chain, kernel, 20, cuda_ms)
            memset_ms, k10_again = abba(memset, kernel, 50, cuda_ms)
            pop_chain_ms, k11_ms = abba(pop_chain, pop_kernel, 20, cuda_ms)

            def copy():
                return to_host(gather_words(words, "cpu"))

            def extract():
                return compact_to_host(words, offsets, CAP, n_words)

            def parent():
                packed = to_host(chain())
                return rebuild_from_blocks(packed.view(np.int32), CAP,
                                           n_words)

            staged = torch.empty((n_shards, 1 + 2 * CAP), dtype=torch.int32,
                                 pin_memory=True)

            def launch_and_copy():
                staged.copy_(kernel(), non_blocking=True)
                torch.cuda.current_stream().synchronize()
                return staged

            packed = launch_and_copy().numpy().copy()

            def rebuild():
                return rebuild_from_blocks(packed, CAP, n_words).reshape(
                    n_shards, -1)

            for fn in (copy, extract, parent):
                got = fn()
                assert got is not None and np.array_equal(got, host), fn
            copy_ms, extract_ms = abba(copy, extract, 20, wall_ms)
            parent_ms, extract_again = abba(parent, extract, 20, wall_ms)
            row = {
                "words": n_words, "shards": n_shards, "nonzero": n_hot,
                "k10_ms": statistics.median([k10_ms, k10_again]),
                "k10_memset_ms": memset_ms, "chain_ms": chain_ms,
                "k10_bound_ms": compact_bound(n_words, CAP, n_shards)[0],
                "k11_ms": k11_ms, "popcount_chain_ms": pop_chain_ms,
                "k11_bound_ms": bound(4 * n_words, n_words)[0],
                "copy_wall": copy_ms,
                "extract_wall": statistics.median([extract_ms,
                                                   extract_again]),
                "parent_extract_wall": parent_ms,
                "k10_and_copy_wall": wall_ms(launch_and_copy, reps=20),
                "rebuild_wall": wall_ms(rebuild, reps=20)}
            rows.append(row)
            log(json.dumps(row))
            del flat, words, scratch, blocks
    wins = sorted({r["words"] for r in rows if r["shards"] == 1}
                  - {r["words"] for r in rows
                     if r["extract_wall"] >= r["copy_wall"]})
    log(f"extraction with K10 faster than the bitset copy at both fills at "
        f"{wins} flat words; HBM rate {HBM_BYTES_PER_S:.3g} B/s; {card}")
    print(card)
    print(json.dumps({"card": card, "rows": rows, "extraction_wins": wins}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
