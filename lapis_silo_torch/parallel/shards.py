"""Word-axis sharding over a list of torch devices, inside one process.

The counterpart of ``lapis_silo_tpu/parallel/mesh.py:26-28`` (``make_mesh``)
and of the ``shard_map`` specs around it. The JAX engine is single-controller:
one process holds a ``Mesh`` over its local devices and shards the flat
global word axis (partition p's words at [p*W, (p+1)*W)) over it. Here one
engine holds one shard per entry of ``devices``: shard d owns the words
[d*PW/D, (d+1)*PW/D) of every bank row, dyn row, pool row and full mask.
Devices may repeat, so several shards can share one card (or the CPU); the
arithmetic is the same whether the shards' copies cross cards or not.

Every VM instruction and every Mutations row is word-local, so each shard
runs its kernels alone; the counts cross shards, copied to the primary
device ``devices[0]`` and added there (the counterpart of ``psum``).
``torch.cuda.comm.reduce_add`` wants distinct devices, and the counts are
at most 4,096 int32s (or one per stored row), so plain copies and adds do
it. The only words that cross shards are a Mutations filter's, gathered
whole onto each distinct device for the entry-split sparse reduction (the
reference's all-gather, lapis_silo_tpu/ops/reductions.py:124).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.words import to_device


def resolve(device) -> torch.device:
    """`device` as the torch.device its tensors report: an index-less CUDA
    device is the current one, and the CPU has no index ("cuda" and
    "cuda:0", or "cpu:0" and "cpu", then compare equal)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if device.type == "cpu":
        return torch.device("cpu")
    return device


class ShardLayout:
    """The shards of a flat word axis of `n_partitions` x `n_words` words
    over `devices` (n_words a multiple of the shard count)."""

    def __init__(self, devices, n_partitions: int, n_words: int):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("no devices")
        if len({d.type for d in self.devices}) > 1:
            raise ValueError(f"shards mix device types: {self.devices}")
        n_shards = len(self.devices)
        if n_words % n_shards:
            raise ValueError(f"{n_words} words per partition do not split "
                             f"over {n_shards} shards")
        self.n_partitions = n_partitions
        self.n_words = n_words
        self.local_words = n_partitions * n_words // n_shards
        # shard d's global words are [offsets[d], offsets[d] + local_words)
        self.offsets = [d * self.local_words for d in range(n_shards)]
        # one entry per distinct device, in first-seen order (a stream copy
        # or a gathered filter is made once per device, not once per shard)
        self.distinct = tuple(dict.fromkeys(self.devices))

    def __len__(self) -> int:
        return len(self.devices)

    def partitions(self, shard: int) -> tuple[int, int]:
        """The partitions [p_lo, p_hi) whose words overlap the shard's
        window: a sparse leaf's other segments hold no word of the shard."""
        lo = self.offsets[shard]
        hi = lo + self.local_words
        return lo // self.n_words, min(-(-hi // self.n_words), self.n_partitions)


def reduce_sum(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The elementwise sum of equal-shape tensors, on `device`: each copied
    there (no copy where it already lies) and added in its own dtype."""
    total = parts[0] if parts[0].device == device else parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def split_words(words: np.ndarray, devices) -> list[torch.Tensor]:
    """uint32 host words [..., PW] -> one int32 tensor [..., PW/D] per
    device, the d-th window on the d-th device."""
    if words.shape[-1] % len(devices):
        raise ValueError(f"{words.shape[-1]} words do not split over "
                         f"{len(devices)} shards")
    local = words.shape[-1] // len(devices)
    return [to_device(words[..., d * local:(d + 1) * local], device)
            for d, device in enumerate(devices)]


def gather_words(parts: list[torch.Tensor], device) -> torch.Tensor:
    """The shards' words [..., PW/D] joined along the word axis into one
    tensor [..., PW] on `device` (the host with ``"cpu"``); one shard's
    words are copied only to reach `device`."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([part.to(device) for part in parts], dim=-1)
