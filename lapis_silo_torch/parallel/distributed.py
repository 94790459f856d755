"""Join processes into one process group for the multi-process query step.

The counterpart of ``jax.distributed.initialize`` as
``scripts/distributed_worker.py:22-26`` uses it: each process calls
`initialize` with the same rendezvous, the world size and its own rank, then
builds a ``ProcessMesh`` over its local devices (``parallel/mesh.py``
``make_mesh``), whose ``ShardedQueryStep`` all-reduces the counts over the
group. The rank's device is the caller's: ``cuda:<local index>`` on the
card, where NCCL carries the collective (one card per rank), or the CPU,
where gloo does. Gloo also takes CUDA tensors, staging them through the
host, which is how several ranks share one card. Nothing is chosen by
failure: a backend that cannot start or a collective that fails raises.

    initialize("file:///tmp/silo_rendezvous", 2, rank, torch.device("cpu"))
    ...
    shutdown()
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

# how long a rank waits at the rendezvous or in a collective for the others:
# a rank that died leaves the rest waiting no longer than this
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def default_backend(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(init_method: str, world_size: int, rank: int, device,
               backend: str | None = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> str:
    """Join the default process group as `rank` of `world_size` through
    `init_method` (``tcp://host:port`` or ``file:///path``), with `device`
    the rank's device: a CUDA device becomes the current one and, under
    NCCL, the communicator's. Returns, once every rank has joined, the
    backend's name."""
    device = torch.device(device)
    backend = backend or default_backend(device)
    if device.type == "cuda":
        if device.index is None:
            raise ValueError("give the rank's card as cuda:<local index>")
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=timeout,
        # NCCL builds its communicator at once, so a rank that cannot
        # reach its card fails here and not at the first collective
        device_id=device if backend == "nccl" else None)
    # return only once every rank has joined: a rank that is done at once
    # (a step that refuses its inputs) and destroys its group would
    # otherwise close the connections a slower peer is still making, and
    # that peer's join fails ("Connection closed by peer")
    dist.barrier(device_ids=[device.index] if backend == "nccl" else None)
    return backend


def shutdown() -> None:
    """Destroy the default process group, where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
