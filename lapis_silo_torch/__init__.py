"""LAPIS-SILO on PyTorch: the query engine ported to torch and hand-written
CUDA kernels for NVIDIA Hopper.

The package stands alone. Its host layers are its own copies of the JAX
package's (``common/``, ``config/``, ``storage/``, ``query/``, ``native.py``
and the synthetic corpora of ``testing.py``); the JAX package,
``lapis_silo_tpu``, stays the reference the port is tested against, and no
module here imports it or ``jax``. ``ops/`` holds the ISA, the lowering, the
two-tier device engine and the kernels (``csrc/``), and ``query/engine.py``
the query engine that drives them. ``storage/snapshot.py`` reads and writes
the JAX package's snapshot format, and ``server/`` serves snapshots over
HTTP; the entry point for users is the CLI's ``--api`` mode, which serves the
newest snapshot of a directory on every visible CUDA card (or on the device
that ``SILO_TORCH_DEVICE`` names):

    python -m lapis_silo_torch.cli --api --dataDirectory ./output

Its ``--worker`` and ``--coordinator`` modes serve one corpus from several
hosts, each with its own partitions (``parallel/multihost.py``).

As a library:

    from lapis_silo_torch.testing import synthetic_database
    db = synthetic_database(65536, 29903)            # or a database of yours
    install(db, torch.device("cuda"))
    db.execute_query('{"action": {"type": "Aggregated"}, ...}')

With ``devices`` the engine shards the word axis over them, one shard per
entry, in this process (``parallel/shards.py``):

    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    install(db, cards[0], devices=cards)
"""

from __future__ import annotations

import torch

from .ops.device_engine import DeviceEngine
from .query.engine import QueryEngine


def install(db, device: torch.device, devices=None) -> DeviceEngine:
    """Build the port's device engine for `db` (a database of this package)
    on `device`, or sharded over `devices` (two or more, repeats allowed,
    `device` their first), and route ``db.execute_query`` through it."""
    engine = DeviceEngine(db, torch.device(device), devices=devices)
    db.device_engine = engine
    with db._engine_lock:
        db._engine = QueryEngine(db, engine)
    return engine
