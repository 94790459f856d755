"""One rank of the multi-process pod path: ``ShardedQueryStep`` across
processes over ``torch.distributed``.

The counterpart of ``scripts/distributed_worker.py``: every rank builds the
same inputs from one seed (the flat global word axis, partitions folded into
words), keeps its shards of them and runs the step, whose count and 64
segment counts the ranks all-reduce. Rank 0 prints
``RESULT count=<count> mut=<sum of the segment counts>`` as the reference
does. Each rank holds `--local-shards` word shards (4 by default, as each
JAX process holds 4 virtual devices) on its `--device`, which is
``cuda:<process_id>`` unless given; the backend is NCCL for a card and gloo
for the CPU unless `--backend` names one.

Two ranks on the CPU (gloo):

    python -m lapis_silo_torch.parallel.distributed_worker file:///tmp/rdv 2 0 --device cpu &
    python -m lapis_silo_torch.parallel.distributed_worker file:///tmp/rdv 2 1 --device cpu

One rank per card (NCCL), or several ranks on one card with
``--device cuda:0 --backend gloo``. With `--out DIR` each rank writes
``rank<r>.json``: its words, the count, the segment counts, its kernels'
launches and plain-version runs. The worker raises if a module of jax* or
lapis_silo_tpu* was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import kernels
from ..ops.vm import ALU, B_BANK, M_AND, M_MOVB, pack_code_array
from ..ops.words import to_host
from . import distributed
from .mesh import ShardedQueryStep, make_mesh
from .shards import rank_words

# the reference worker's shapes (scripts/distributed_worker.py:41-43):
# partitions, bank rows, the program's length bucket
N_PARTITIONS, N_ROWS, PROGRAM_LEN = 2, 64, 16
BANNED_MODULES = ("jax", "jaxlib", "lapis_silo_tpu")


def worker_inputs(n_shards: int) -> tuple[np.ndarray, ...]:
    """(code [2, 16] int32, bank [64, PW], dyn [1, PW], full [PW] uint32)
    with PW = 2 * 4 * `n_shards`, from ``default_rng(0)``: the program
    ``reg0 = bank[3]; reg0 &= bank[7]`` (scripts/distributed_worker.py:41-51)."""
    n_words = N_PARTITIONS * 4 * n_shards
    rng = np.random.default_rng(0)
    bank = rng.integers(0, 1 << 32, size=(N_ROWS, n_words), dtype=np.uint32)
    dyn = np.zeros((1, n_words), dtype=np.uint32)
    full = np.full(n_words, 0xFFFFFFFF, dtype=np.uint32)
    code = pack_code_array(
        PROGRAM_LEN, [ALU, ALU], [3, 7],
        [0 | (M_MOVB << 24) | (B_BANK << 28),
         0 | (0 << 8) | (M_AND << 24) | (B_BANK << 28)])
    return code, bank, dyn, full


def run_rank(mesh, code: np.ndarray, bank: np.ndarray, dyn: np.ndarray,
             full: np.ndarray, seg_slice: int = 0) -> dict:
    """The step over this rank's shards of the whole inputs (host arrays of
    the flat global axis): its words (uint32, the rank's window of the
    axis), the count and the 64 segment counts over every rank."""
    step = ShardedQueryStep(mesh, bank.shape[-1])
    words, count, muts = step(code, rank_words(bank, mesh),
                              rank_words(dyn, mesh), rank_words(full, mesh),
                              seg_slice)
    return {"words": to_host(torch.cat(words)).tolist(), "count": int(count),
            "mutation_counts": muts.cpu().tolist()}


def banned_modules() -> list[str]:
    """The modules of jax* or lapis_silo_tpu* loaded in this process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in BANNED_MODULES)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m lapis_silo_torch.parallel.distributed_worker",
        description="one rank of ShardedQueryStep across processes")
    parser.add_argument("init_method",
                        help="rendezvous: tcp://host:port or file:///path")
    parser.add_argument("num_processes", type=int)
    parser.add_argument("process_id", type=int)
    parser.add_argument("--device", help="this rank's device "
                        "(default cuda:<process_id>)")
    parser.add_argument("--local-shards", type=int, default=4)
    parser.add_argument("--backend", choices=("nccl", "gloo"))
    parser.add_argument("--out", type=Path,
                        help="directory for rank<process_id>.json")
    args = parser.parse_args(argv)
    if args.local_shards < 1:
        parser.error("--local-shards must be at least 1")
    device = torch.device(args.device or f"cuda:{args.process_id}")
    backend = distributed.initialize(args.init_method, args.num_processes,
                                     args.process_id, device, args.backend)
    try:
        mesh = make_mesh([device] * args.local_shards)
        result = run_rank(mesh, *worker_inputs(mesh.n_shards))
        if mesh.rank == 0:
            print(f"RESULT count={result['count']} "
                  f"mut={sum(result['mutation_counts'])}", flush=True)
        banned = banned_modules()
        if banned:
            raise RuntimeError(f"the port loaded {banned}")
        if args.out:
            args.out.mkdir(parents=True, exist_ok=True)
            result.update(
                rank=mesh.rank, world_size=mesh.world_size,
                n_shards=mesh.n_shards, device=str(device), backend=backend,
                launches={k.name: k.launches for k in kernels.KERNELS},
                plain={k.name: k.plain_launches for k in kernels.KERNELS})
            (args.out / f"rank{mesh.rank}.json").write_text(
                json.dumps(result))
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
