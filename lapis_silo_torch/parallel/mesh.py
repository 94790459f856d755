"""The multi-device query step over word shards, in one process or many.

The counterpart of ``lapis_silo_tpu/parallel/mesh.py`` (``make_mesh`` and
``ShardedQueryStep``), where one jitted step runs over a ``Mesh`` with the
flat word axis sharded. Here the shards are the local devices of a
``ProcessMesh`` (repeats allowed, ``parallel/shards.py``'s ``ShardLayout``)
on every rank of a process group: global shard g = rank * L + l (local
device l of `rank`, L local devices per rank) owns the words
[g*PW/D, (g+1)*PW/D) of every bank row, dyn row and the full mask, D = world
size x L shards in all. That is the order ``jax.devices()`` gives under
``jax.distributed``: process-major. The filter VM with the count of its
words in the same launch (K1 or K6, ``kernels.vm_filter_sharded``) and
the 64-row Mutations reduction (K2, ``kernels.mutation_counts_sharded``)
run on each local shard alone, and their counts are added on the rank's
first device. Across ranks one
``torch.distributed.all_reduce`` adds them, where the reference's
XLA-inserted all-reduces land (``parallel/distributed.py`` joins the
processes). A plain list of devices is the one-process mesh, with no
collective.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops import kernels
from ..ops.vm import ALU, B_SPARSE, MAX_REGS, wire_bsrc, wire_opcode
from .shards import ShardLayout, resolve

# rows of the bank segment whose per-row counts a step returns
SEGMENT_ROWS = 64


class ProcessMesh:
    """The word shards of one flat axis over the local devices of every
    rank of a process group: global shard ``rank * L + l`` is local device
    l of `rank`. Where `joined` is false the mesh is this process's devices
    alone and no collective runs. `group` is the process group the counts
    are summed over, None for the default one: the mesh then holds no
    process group, which must not outlive its destruction (a gloo group
    freed at the interpreter's exit can abort the process)."""

    def __init__(self, local_devices, world_size: int = 1, rank: int = 0,
                 group=None, joined: bool = False):
        self.local_devices = tuple(resolve(d) for d in local_devices)
        if not self.local_devices:
            raise ValueError("no devices")
        self.world_size, self.rank = world_size, rank
        self.group, self.joined = group, joined

    @property
    def n_shards(self) -> int:
        """D: the global shard count, world size x local devices."""
        return self.world_size * len(self.local_devices)

    def window(self, n_words: int) -> tuple[int, int]:
        """The rank's words [lo, hi) of a flat axis of `n_words` (a
        multiple of D): its local shards' windows, which are adjacent."""
        local = n_words // self.n_shards * len(self.local_devices)
        return self.rank * local, (self.rank + 1) * local


def make_mesh(local_devices, group=None) -> ProcessMesh:
    """The mesh over this rank's `local_devices` and every other rank's in
    `group` (the default process group where none is given); with no
    process group initialized, the one-process mesh."""
    if group is None and not dist.is_initialized():
        return ProcessMesh(local_devices)
    return ProcessMesh(local_devices, dist.get_world_size(group),
                       dist.get_rank(group), group, joined=True)


class ShardedQueryStep:
    """The full query step over the shards of `mesh` (a ``ProcessMesh``, or
    a list of devices: one process): the filter VM over the word shards,
    the popcount of its words and the per-row popcount of a 64-row bank
    segment AND those words (mesh.py:53-66).

    `n_words` is the global flat word axis (PW, the bank's width), a
    multiple of the global shard count. The whole padded program runs (NOPs
    write only the trash register), with MAX_REGS registers."""

    def __init__(self, mesh, n_words: int):
        self.mesh = mesh if isinstance(mesh, ProcessMesh) else ProcessMesh(mesh)
        n_shards = self.mesh.n_shards
        if n_words % n_shards != 0:
            raise ValueError(
                f"n_words={n_words} must be a multiple of mesh size "
                f"{n_shards} (pad the word axis)"
            )
        devices = self.mesh.local_devices
        self.layout = ShardLayout(devices, 1,
                                  n_words // n_shards * len(devices))
        self.n_words = n_words
        # the VM's sparse rows: this step has no sparse tier
        self._no_sparse = [
            torch.zeros((1, self.layout.local_words), dtype=torch.int32,
                        device=device) for device in self.layout.devices]

    def __call__(self, code, banks: list, dyns: list, fulls: list,
                 seg_slice: int = 0) -> tuple[list, torch.Tensor, torch.Tensor]:
        """(words per local shard [PW/D] int32, count 0-d int32 and the 64
        segment rows' counts [64] int32, both on the first local device and
        summed over every shard of the mesh) for the wire-format program
        `code` [2, L] (int32, on the host) over the local shards' bank rows,
        dyn rows and full masks. The segment starts at `seg_slice`, plus R
        where it is negative, clamped into [0, R-64], as
        jax.lax.dynamic_slice takes it."""
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
        out = kernels.vm_filter_sharded(
            torch.from_numpy(host_code), host_code.shape[1], banks, dyns,
            self._no_sparse, fulls, MAX_REGS)
        words, count = out.words, out.total.to(torch.int32)
        mutation_counts = kernels.mutation_counts_sharded(
            banks, words, start, SEGMENT_ROWS)[:SEGMENT_ROWS]
        if not self.mesh.joined:
            return words, count, mutation_counts
        # the other ranks' shards: one int32 sum over the group, which
        # wraps as the reference's int32 psum does. NCCL runs it on its own
        # stream after the current stream's VM and K2, and the current
        # stream then waits for it; gloo waits for them, stages the tensor
        # through the host and copies the sum back.
        totals = torch.cat([count.reshape(1), mutation_counts])
        dist.all_reduce(totals, group=self.mesh.group)
        return words, totals[0], totals[1:]
