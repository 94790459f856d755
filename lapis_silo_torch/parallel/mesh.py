"""The multi-device query step over word shards.

The counterpart of ``lapis_silo_tpu/parallel/mesh.py:31-81``
(``ShardedQueryStep``), where one jitted step runs over a ``Mesh`` with the
flat word axis sharded. Here the shards are a list of torch devices
(repeats allowed, ``parallel/shards.py``'s ``ShardLayout``): shard d owns
the words [d*PW/D, (d+1)*PW/D) of every bank row, dyn row and the full
mask. The filter VM (K1, ``kernels.vm_run_sharded``) and the 64-row
Mutations reduction (K2, ``kernels.mutation_counts_sharded``) run on each
shard alone, and their counts are added on ``devices[0]``, where the
reference's all-reduces land.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from ..ops.reductions import popcount_words
from ..ops.vm import ALU, B_SPARSE, MAX_REGS, wire_bsrc, wire_opcode
from .shards import ShardLayout, reduce_sum, resolve

# rows of the bank segment whose per-row counts a step returns
SEGMENT_ROWS = 64


class ShardedQueryStep:
    """The full query step over `devices`: the filter VM over the word
    shards, the popcount of its words and the per-row popcount of a
    64-row bank segment AND those words (mesh.py:53-66).

    `n_words` is the flat word axis (PW, the bank's width), a multiple of
    the shard count. The whole padded program runs (NOPs write only the
    trash register), with MAX_REGS registers."""

    def __init__(self, devices, n_words: int):
        if n_words % len(devices) != 0:
            raise ValueError(
                f"n_words={n_words} must be a multiple of mesh size "
                f"{len(devices)} (pad the word axis)"
            )
        self.layout = ShardLayout([resolve(d) for d in devices], 1, n_words)
        self.n_words = n_words
        # the VM's sparse rows: this step has no sparse tier
        self._no_sparse = [
            torch.zeros((1, self.layout.local_words), dtype=torch.int32,
                        device=device) for device in self.layout.devices]

    def __call__(self, code, banks: list, dyns: list, fulls: list,
                 seg_slice: int = 0) -> tuple[list, torch.Tensor, torch.Tensor]:
        """(words per shard [PW/D] int32, count 0-d int32 and the 64
        segment rows' counts [64] int32, both on devices[0]) for the
        wire-format program `code` [2, L] (int32, on the host) over the
        shards' bank rows, dyn rows and full masks. The segment starts at
        `seg_slice`, plus R where it is negative, clamped into [0, R-64],
        as jax.lax.dynamic_slice takes it."""
        # this path has no sparse-tier stream: a B_SPARSE-source program
        # would silently read zeros — fail loudly instead
        host_code = np.ascontiguousarray(code, dtype=np.int32)
        if ((wire_opcode(host_code[1]) == ALU)
                & (wire_bsrc(host_code[1]) == B_SPARSE)).any():
            raise ValueError(
                "ShardedQueryStep cannot execute sparse-tier programs")
        n_rows = banks[0].shape[0]
        if n_rows < SEGMENT_ROWS:
            raise TypeError(
                f"slice slice_sizes must be less than or equal to operand "
                f"shape, got slice_sizes ({SEGMENT_ROWS}, {self.n_words}) "
                f"for operand shape ({n_rows}, {self.n_words}).")
        start = int(seg_slice)
        if start < 0:  # jax.lax.dynamic_slice wraps a negative start once
            start += n_rows
        start = min(max(start, 0), n_rows - SEGMENT_ROWS)
        words, _emits = kernels.vm_run_sharded(
            torch.from_numpy(host_code), host_code.shape[1], banks, dyns,
            self._no_sparse, fulls, MAX_REGS)
        primary = self.layout.devices[0]
        count = reduce_sum([popcount_words(part).to(torch.int32)
                            for part in words], primary)
        mutation_counts = kernels.mutation_counts_sharded(
            banks, words, start, SEGMENT_ROWS)
        return words, count, mutation_counts
