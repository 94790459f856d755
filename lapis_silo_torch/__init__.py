"""LAPIS-SILO on PyTorch: the query engine's device layer ported to torch and
hand-written CUDA kernels for NVIDIA Hopper.

The host layers (storage, snapshots, the JSON query language and its
actions) are the reference package's, ``lapis_silo_tpu``, which they import
without JAX. This package replaces the device layer: ``ops/`` holds the ISA,
the lowering, the two-tier device engine and the kernels (``csrc/``), and
``query/engine.py`` the query engine that drives them. No module here imports
``jax``.

    db = lapis_silo_tpu.testing.synthetic_database(...)   # or a snapshot
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
    """Build the port's device engine for `db` on `device`, or sharded over
    `devices` (two or more, repeats allowed, `device` their first), and
    route ``db.execute_query`` through it (the seam of
    ``lapis_silo_tpu/storage/database.py:98-104``)."""
    engine = DeviceEngine(db, torch.device(device), devices=devices)
    db.device_engine = engine
    with db._engine_lock:
        db._engine = QueryEngine(db, engine)
    return engine
