"""Data-directory watcher: 2 s poll, hot-swap on newer valid snapshot.

Parity with reference src/silo_api/database_directory_watcher.cpp: load
errors are caught and logged, the old snapshot stays live, the server keeps
serving from an empty/stale database until a valid snapshot appears.

Each loaded snapshot gets the port's device engine before it goes live
(``install``), on the devices ``serving_devices`` names: every visible CUDA
card (sharded over them when there are several), or the one device that
``SILO_TORCH_DEVICE`` names (``cpu`` for the tests). With neither, the load
fails and is logged like any bad snapshot: the port never serves a snapshot
on the CPU unasked.
"""

from __future__ import annotations

import logging
import os
import threading

import torch

from .. import install
from ..storage import snapshot
from .http_server import DatabaseMutex

DEVICE_ENV = "SILO_TORCH_DEVICE"

logger = logging.getLogger(__name__)


class DatabaseDirectoryWatcher:
    def __init__(self, data_directory: str, database_mutex: DatabaseMutex,
                 poll_seconds: float = 2.0):
        self.data_directory = data_directory
        self.database_mutex = database_mutex
        self.poll_seconds = poll_seconds
        self._current_version: str | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="silo-directory-watcher")

    def start(self):
        self.check_once()  # synchronous first check so startup is immediate
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(self.poll_seconds):
            self.check_once()

    def check_once(self):
        try:
            newest = snapshot.find_newest_snapshot(self.data_directory)
            if newest is None:
                return
            version = newest.rstrip("/").rsplit("/", 1)[-1]
            if self._current_version is not None and version <= self._current_version:
                return
            logger.info("loading snapshot %s", newest)
            database = snapshot.load_database(newest)
            devices = serving_devices()
            install(database, devices[0],
                    devices=devices if len(devices) > 1 else None)
            self._warmup(database)
            self.database_mutex.set_database(database)
            self._current_version = version
            logger.info("now serving data version %s", version)
        except Exception:  # parity: never crash the server on a bad snapshot
            logger.exception("snapshot load failed; keeping current database")

    @staticmethod
    def _warmup(database):
        """Run the device paths once BEFORE the snapshot goes live: the
        kernels' library is built and loaded at first launch, the hot-leaf
        pool is allocated, and queries served meanwhile keep hitting the old
        database."""
        import json
        import time

        t0 = time.time()
        try:
            # /info's Roaring size model walks every plane on first call
            # (memoized after) — compute it BEFORE the
            # snapshot goes live or the first healthcheck poll stalls past
            # its timeout
            database.info()
            seg = next(iter(database.nuc_sequences), None)
            filt = (
                {"type": "HasNucleotideMutation", "position": 1, "sequenceName": seg}
                if seg is not None
                else {"type": "True"}
            )
            database.execute_query(json.dumps(
                {"action": {"type": "Aggregated"}, "filterExpression": filt}))
            database.execute_query(json.dumps(
                {"action": {"type": "Aggregated"}, "filterExpression": {"type": "True"}}))
            # Also run a batched count launch once
            engine = database.device_engine
            if engine is not None:
                from ..query.engine import Query

                query = Query(json.dumps(
                    {"action": {"type": "Aggregated"}, "filterExpression": filt}))
                programs = [engine.lower(query.filter)[0]]
                # The densify path needs a program that TOUCHES the sparse
                # tier (dense programs skip densify entirely): synthesize one
                # from the engine's own sparse row metadata.
                if engine.n_sparse:
                    from ..common.symbols import AMINO_ACID, NUCLEOTIDE

                    for (kind, name), meta in engine.segment_meta.items():
                        n_seg_sparse = len(meta["sparse_sym_ids"])
                        if not n_seg_sparse:
                            continue
                        alphabet = NUCLEOTIDE if kind == "nuc" else AMINO_ACID
                        # And of two sparse leaves: single-leaf counts are
                        # answered host-side (stored cardinalities) and
                        # would never reach the densify kernels
                        leaves = [{
                            "type": ("NucleotideEquals" if kind == "nuc"
                                     else "AminoAcidEquals"),
                            "position": int(meta["sparse_pos_ids"][j]) + 1,
                            "symbol": alphabet.chars[
                                int(meta["sparse_sym_ids"][j])],
                            "sequenceName": name,
                        } for j in (0, min(1, n_seg_sparse - 1))]
                        sparse_query = Query(json.dumps({
                            "action": {"type": "Aggregated"},
                            "filterExpression": {"type": "And",
                                                 "children": leaves}}))
                        programs.append(engine.lower(sparse_query.filter)[0])
                        break
                engine.count_programs(programs)
                # pooled engines: the pool is allocated before live miss
                # bursts hit it
                engine.warm_pool_updates()
            logger.info("device warm-up done in %.1f s", time.time() - t0)
        except Exception:  # noqa: BLE001 — warm-up must never block serving
            logger.exception("device warm-up failed (serving anyway)")


def serving_devices() -> list[torch.device]:
    """The devices a loaded snapshot is served on: the one SILO_TORCH_DEVICE
    names (e.g. ``cpu``, ``cuda:1``), else every visible CUDA card. Raises
    RuntimeError where there is neither."""
    name = os.environ.get(DEVICE_ENV)
    if name:
        return [torch.device(name)]
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device to serve on; set {DEVICE_ENV}=cpu "
                           f"to serve on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
