"""Count fast path for the native HTTP server.

The reference serves queries entirely in native code
(src/silo_api/query_handler.cpp:22-74); this package splits the request
path in two:

- C++ (native/silo_http.cpp) matches exact `POST /query` bodies against a
  registered map and queues hits for the drainer — zero Python per request.
- ONE Python drainer thread (here) pops whole batches, resolves each opaque
  handle to a pre-lowered filter program, queues a single device launch for
  the batch (DeviceEngine.count_split) and hands it to a completion pump
  thread, which reads the counts back (count_finish) and hands them to C++
  to format and write.

Registration happens on the slow path: after the Python router answers a
`POST /query` 200, `maybe_register` checks the query is count-shaped
(Aggregated, no group-by, no offset/limit effects) and — once per distinct
body per snapshot generation — registers body -> (generation << 20 | index)
with the C++ map.

Snapshot swaps (the watcher) are handled by the drainer alone: it clears the
C++ map (after which no old-generation task can enter the queue), waits until
the pump has answered every batch handed to it, drains the queue to empty
answering with the OLD generation's programs/engine/version (each request
sees one consistent snapshot, exactly like the slow path), and only then
retires the old table and bumps the generation.

A batch handed to the pump after it stopped is answered at once in the
caller's thread, so no matched connection is left without an answer.
"""

from __future__ import annotations

import ctypes
import json
import logging
import threading
import time

logger = logging.getLogger(__name__)

MAX_BATCH = 2048
# pipeline depth: batch k is dispatched while up to this many earlier
# batches' readbacks are in flight in the pump
PIPELINE_DEPTH = 3
# drain width cap: half of
# device_engine.MAX_BATCH_QUERIES (4096) — serving favors latency; with
# max_bucket pinned to SERVE_LEN_BUCKET a wider pop splits into several
# pipelined launches anyway, but fewer pops = less host CPU per request
_GEN_SHIFT = 20
_IDX_MASK = (1 << _GEN_SHIFT) - 1
_GEN_MASK = (1 << (32 - _GEN_SHIFT)) - 1
_NEGATIVE_CACHE_MAX = 65536
# registrations per generation are bounded too: the C++ map stores full
# body bytes and the table a lowered program each — a client iterating
# distinct count queries must not grow server memory without limit
# (overflow just stays on the slow path)
_POSITIVE_CACHE_MAX = 65536


class _Generation:
    """One snapshot generation: the database/engine it serves, an append-only
    program table (index = low handle bits), and the data-version bytes."""

    def __init__(self, gen: int, epoch: int, database, engine):
        self.gen = gen
        self.epoch = epoch  # swap epoch at creation; any later swap retires
        self.database = database
        self.engine = engine
        self.version = (database.data_version.value or "").encode("ascii")
        self.programs: list = []
        self.registered: set[bytes] = set()
        self.negative: set[bytes] = set()


class _CompletionPump:
    """The completion thread: readbacks block here, so the drainer keeps
    popping and dispatching while earlier batches' counts come back.
    Bounded: submit() blocks at `capacity` in-flight batches (the pipeline
    depth). A batch stays at the queue head until fully answered, so
    drain() waits for true quiescence (generation retire needs that).
    After stop(), submit() answers the batch in the caller's thread: the
    pump thread may already have returned, and a batch queued then would
    never be answered."""

    def __init__(self, fastpath: "CountFastPath", capacity: int):
        self._fp = fastpath
        self._capacity = max(1, capacity)
        self._cv = threading.Condition()
        self._queue: list = []
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, name="silo-fastpath-complete", daemon=True)
        self._thread.start()

    def submit(self, batch) -> None:
        with self._cv:
            while len(self._queue) >= self._capacity and not self._stopped:
                self._cv.wait()
            if not self._stopped:
                self._queue.append(batch)
                self._cv.notify_all()
                return
        self._answer(batch)

    def idle(self) -> bool:
        with self._cv:
            return not self._queue

    def drain(self) -> None:
        """Block until every submitted batch is fully answered."""
        with self._cv:
            while self._queue and not self._stopped:
                self._cv.wait()

    def stop(self, timeout: float = 10.0) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def _answer(self, batch) -> None:
        """_complete the batch; on a failure, answer its remaining groups
        with a 500 (no connection may hang)."""
        try:
            self._fp._complete(batch)
        except Exception:  # noqa: BLE001 — no connection may hang
            logger.exception("fast-path completion failed")
            # _complete pops groups as it answers them: the remaining
            # groups are exactly the unanswered ones
            for group in list(batch):
                try:
                    self._fp._respond_error(
                        group[1], 500,
                        {"error": "Internal Server Error",
                         "message": "fast-path completion failed"})
                except Exception:  # noqa: BLE001 — best effort
                    pass
            del batch[:]

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait()
                if not self._queue:
                    return  # stopped and drained
                batch = self._queue[0]  # stays queued until answered
            self._answer(batch)
            with self._cv:
                self._queue.pop(0)
                self._cv.notify_all()


class CountFastPath:
    """Owns the drainer thread and the registration state for one native
    HTTP server instance."""

    def __init__(self, lib, server_id: int, database_mutex):
        self._lib = lib
        self._sid = server_id
        self._mutex = database_mutex
        self._reg_lock = threading.Lock()
        self._state: _Generation | None = None
        self._tables: dict[int, _Generation] = {}
        self._next_gen = 0
        # Bumped (under _reg_lock) by the mutex swap listener BEFORE it
        # clears the C++ map. A generation whose epoch is stale must be
        # retired even when the database object looks current again —
        # swap A->B->A inside one drainer tick would otherwise leave
        # `registered` claiming bodies the C++ map no longer holds (and a
        # racing registration could resurrect pre-swap programs).
        self._swap_epoch = 0
        self._keys = (ctypes.c_uint64 * MAX_BATCH)()
        self._handles = (ctypes.c_uint32 * MAX_BATCH)()
        self._counts = (ctypes.c_int64 * MAX_BATCH)()
        lib.silo_fastpath_wait.restype = ctypes.c_int
        lib.silo_fastpath_wait.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_int,
        ]
        lib.silo_fastpath_register.restype = None
        lib.silo_fastpath_register.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32,
        ]
        lib.silo_fastpath_clear.restype = None
        lib.silo_fastpath_clear.argtypes = [ctypes.c_int]
        lib.silo_fastpath_respond_counts.restype = None
        lib.silo_fastpath_respond_counts.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_char_p,
        ]
        lib.silo_fastpath_respond_error.restype = None
        lib.silo_fastpath_respond_error.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
        ]
        # Swap-freshness parity with the slow path: clearing the C++ map the
        # moment the watcher installs a new snapshot means no NEW request can
        # match a stale body; already-queued tasks are in-flight and answered
        # with the old (consistent) snapshot, exactly like slow-path requests
        # that resolved just before the swap. (Without this the drainer's
        # 250 ms poll bounds staleness instead.) A racing registration can
        # re-add an old-generation body; the drainer's _retire clears again
        # under _reg_lock, which closes that window for good.
        if hasattr(database_mutex, "add_swap_listener"):
            database_mutex.add_swap_listener(self._on_swap)
        self._pump = _CompletionPump(self, PIPELINE_DEPTH)
        self._thread = threading.Thread(
            target=self._drain_loop, name="silo-fastpath", daemon=True)
        self._thread.start()

    def _on_swap(self) -> None:
        """Mutex swap listener (watcher thread). Bump-then-clear: any
        registration completing after the bump aborts on the epoch check;
        one completing before it is wiped by the clear."""
        with self._reg_lock:
            self._swap_epoch += 1
        self._lib.silo_fastpath_clear(self._sid)

    # -- registration (called from native worker threads) ---------------------

    def maybe_register(self, body: bytes) -> None:
        """Register `body` for the fast path if its response is a pure count.
        Called after the slow path answered it with a 200 — so the query is
        known-valid and the device engine exists."""
        try:
            self._maybe_register(body)
        except Exception:  # noqa: BLE001 — registration is best-effort
            logger.exception("fast-path registration failed")

    def _maybe_register(self, body: bytes) -> None:
        state = self._state
        if state is None or state.database is not self._mutex.get_database():
            return  # drainer will swap generations shortly
        key = bytes(body)
        if key in state.registered or key in state.negative:
            return
        if len(state.registered) >= _POSITIVE_CACHE_MAX:
            return  # table full for this generation: stay on the slow path
        data = self._count_shaped(key)
        if data is None:
            if len(state.negative) < _NEGATIVE_CACHE_MAX:
                state.negative.add(key)
            return
        from ..query import ast

        filter_expr = ast.parse_expression(data["filterExpression"])
        filter_key = json.dumps(data["filterExpression"], sort_keys=True,
                                separators=(",", ":"))
        engine = state.engine
        program = engine.lower_cached(filter_expr, filter_key)[0]
        with self._reg_lock:
            if state is not self._state or state.epoch != self._swap_epoch:
                return  # generation retired / snapshot swapped mid-register
            idx = len(state.programs)
            if idx > _IDX_MASK:
                return  # table full: stop registering this generation
            state.programs.append(program)
            handle = ((state.gen & _GEN_MASK) << _GEN_SHIFT) | idx
            self._lib.silo_fastpath_register(self._sid, key, len(key), handle)
            state.registered.add(key)

    @staticmethod
    def _count_shaped(key: bytes):
        """The parsed query dict when the response is exactly [{"count": N}]
        with no post-processing — Aggregated, no group-by, offset absent/0,
        limit absent/>=1 (orderBy on a single count row is the identity, and
        the slow path already validated it) — else None."""
        from ..query.actions import Aggregated, parse_action

        try:
            data = json.loads(key)
            action = parse_action(data["action"])
        except Exception:  # noqa: BLE001 — slow path answered; stay out
            return None
        if not isinstance(data.get("filterExpression"), dict):
            return None
        if not isinstance(action, Aggregated) or action.group_by_fields:
            return None
        if action.offset not in (None, 0):
            return None
        if action.limit is not None and action.limit < 1:
            return None
        return data

    # -- drainer ---------------------------------------------------------------

    def _ensure_state(self) -> _Generation | None:
        """Swap generations when the watcher installed a new snapshot. Runs
        ONLY in the drainer thread."""
        database = self._mutex.get_database()
        state = self._state
        if (state is not None and state.database is database
                and state.epoch == self._swap_epoch):
            return state
        engine = getattr(database, "device_engine", None)
        if engine is None:
            # The empty database served before the first snapshot has no
            # engine: nothing to register or answer.
            if state is not None:
                self._retire(state)
            return None
        with self._reg_lock:
            gen = self._next_gen
            self._next_gen += 1
            new_state = _Generation(gen, self._swap_epoch, database, engine)
            # keyed by the MASKED generation — handles carry only
            # _GEN_MASK bits, so an unmasked key would stop matching after
            # 4096 snapshot swaps (every registered body would 500 forever)
            self._tables[gen & _GEN_MASK] = new_state
            self._state = new_state
        return new_state

    def _retire(self, state: _Generation) -> None:
        """Clear the C++ map and answer every queued old-generation task,
        then drop retired tables. After silo_fastpath_clear returns, no task
        for a cleared entry can enter the queue (fp_mu covers match+push),
        so one empty poll proves the queue holds no old handles."""
        with self._reg_lock:
            if self._state is state:
                self._state = None  # stop registrations into the old table
        self._lib.silo_fastpath_clear(self._sid)
        # old-generation batches already handed to the completion pump
        # answer from their own table references; wait them out before
        # this method drops the retired tables below
        self._pump.drain()
        while True:
            n = self._lib.silo_fastpath_wait(
                self._sid, self._keys, self._handles, MAX_BATCH, 20)
            if n <= 0:
                break
            dispatched = self._dispatch(self._pop_copy(n))
            if dispatched is not None:
                self._complete(dispatched)
        keep = (self._state.gen & _GEN_MASK) if self._state is not None else None
        self._tables = {g: t for g, t in self._tables.items() if g == keep}

    def _pop_copy(self, n: int) -> list[tuple[int, int]]:
        """Copy popped (key, handle) pairs out of the shared ctypes buffers
        — the next silo_fastpath_wait reuses them."""
        return [(self._keys[i], self._handles[i]) for i in range(n)]

    def _drain_loop(self) -> None:
        # The loop body is fully guarded: an uncaught exception would kill
        # the only thread that pops fast-path tasks while the C++ map keeps
        # matching bodies — every matched connection would then hang
        # forever (the slow path never sees a matched body).
        while True:
            n = self._lib.silo_fastpath_wait(
                self._sid, self._keys, self._handles, MAX_BATCH, 250)
            if n < 0:
                self._pump.drain()
                self._pump.stop()
                return  # server stopping
            dispatched = None
            try:
                dispatched = self._dispatch(self._pop_copy(n)) if n else None
                if dispatched is not None:
                    # hand off; blocks only when `depth` batches are
                    # already awaiting readback (backpressure)
                    self._pump.submit(dispatched)
                    dispatched = None
                if n == 0 and self._pump.idle():
                    # idle moment: generation maintenance
                    state = self._state
                    if state is not None and (
                            state.epoch != self._swap_epoch
                            or state.database is not self._mutex.get_database()):
                        self._retire(state)
                    if self._state is None:
                        self._ensure_state()
            except Exception:  # noqa: BLE001 — the drainer must survive
                logger.exception("fast-path drain iteration failed")
                # no task may be dropped silently: a matched connection the
                # drainer never answers hangs forever. Submitted batches are
                # the pump's to answer; only a dispatch not yet submitted
                # needs answering here.
                for entry in dispatched or ():
                    try:
                        self._respond_error(
                            entry[1], 500,
                            {"error": "Internal Server Error",
                             "message": "fast-path drain failed"})
                    except Exception:  # noqa: BLE001 — best effort
                        pass
                time.sleep(0.05)  # never spin on a persistent fault

    def _dispatch(self, tasks: list[tuple[int, int]]):
        """Phase 1 (non-blocking): group tasks by generation, coalesce
        identical bodies into one program slot (same instant, same snapshot
        — pure fan-out, not a cache), answer host-computable programs'
        slots inline, and enqueue ONE device dispatch per group. Returns
        the in-flight batch for _complete."""
        from ..ops.device_engine import SERVE_LEN_BUCKET

        by_gen: dict[int, list[tuple[int, int]]] = {}
        for key, handle in tasks:
            by_gen.setdefault((handle >> _GEN_SHIFT) & _GEN_MASK,
                              []).append((key, handle))
        batch = []
        for gen, group in by_gen.items():
            table = self._tables.get(gen)
            keys = [key for key, _ in group]
            if table is None:
                self._respond_error(
                    keys, 500, {"error": "Internal Server Error",
                                "message": "fast-path generation retired"})
                continue
            try:
                slot_of: dict[int, int] = {}
                task_slot: list[int] = []
                programs = []
                for _, handle in group:
                    handle_idx = handle & _IDX_MASK
                    slot = slot_of.get(handle_idx)
                    if slot is None:
                        slot = len(programs)
                        slot_of[handle_idx] = slot
                        programs.append(table.programs[handle_idx])
                    task_slot.append(slot)
                split = table.engine.count_split(
                    programs, max_bucket=SERVE_LEN_BUCKET)
                batch.append((table, keys, task_slot, split))
            except Exception as ex:  # noqa: BLE001 — parity: JSON 500
                logger.exception("fast-path batch dispatch failed")
                self._respond_error(
                    keys, 500, {"error": "Internal Server Error",
                                "message": str(ex)})
        return batch or None

    def _complete(self, batch) -> None:
        """Phase 2 (blocking): pull each group's device counts to the host,
        fan them out to the coalesced tasks, hand C++ the answers. Entries
        pop as they are answered so a mid-batch crash cannot double-answer
        a connection from the pump's recovery path."""
        while batch:
            # Peek, answer, THEN pop: if the respond call itself raises,
            # the group stays in `batch` where the pump's recovery walk can
            # still answer it. The pop immediately follows the respond with
            # no fallible statement between, so a group can never be
            # answered twice either.
            table, keys, task_slot, split = batch[0]
            try:
                slot_counts = table.engine.count_finish(*split)
                counts = [slot_counts[s] for s in task_slot]
            except Exception as ex:  # noqa: BLE001 — parity: JSON 500
                logger.exception("fast-path batch readback failed")
                self._respond_error(
                    keys, 500, {"error": "Internal Server Error",
                                "message": str(ex)})
                batch.pop(0)
                continue
            ckeys = (ctypes.c_uint64 * len(keys))(*keys)
            vals = (ctypes.c_int64 * len(keys))(*counts)
            self._lib.silo_fastpath_respond_counts(
                self._sid, ckeys, vals, len(keys), table.version)
            batch.pop(0)

    def _respond_error(self, keys: list[int], status: int, payload: dict) -> None:
        body = json.dumps(payload, ensure_ascii=False).encode("utf-8")
        ckeys = (ctypes.c_uint64 * len(keys))(*keys)
        self._lib.silo_fastpath_respond_error(
            self._sid, ckeys, len(keys), status, body, len(body))

    def stop(self, timeout: float = 10.0) -> None:
        """Join the drainer after silo_http_stop woke it (wait returns -1).
        Without the join, a daemon thread blocked in a ctypes call at
        interpreter exit aborts the process (pthread_exit unwinding through
        C++ frames). The drain loop stops its own completion pump on the
        way out; the extra stop here covers a drainer that died early."""
        self._thread.join(timeout)
        self._pump.stop(timeout)
