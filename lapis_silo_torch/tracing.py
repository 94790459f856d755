"""Spans of the count path, of Mutations and of group-by, recorded where
the work happens.

The switch is the performance logger: spans are recorded exactly while
``lapis_silo_torch.performance`` is enabled for INFO (the CLI's
performance log at ``SPDLOG_LEVEL=info``, its default). ``QueryEngine``
asks ``enabled()`` once as a request enters and the micro-batcher once per
batch; with the switch off no other code of this module runs, and no
collector callback is installed. Spans go to ``RECORDER``. A traced
Mutations request on the device records under its ``request``
``mutations.filter`` (the device filter: its lowering and VM launch) and
``mutations.assemble`` (the action: the rows on the host and their
order), and under the latter ``mutations.reduce``
(``mutation_counts_many``: K2, K3, their read-backs and the majority). A
traced group-by (``Aggregated`` with ``groupByFields``) on the device
records under its ``request`` ``groupby.filter`` (parse's end to the
filter's words on the card) and ``groupby.reduce`` (K9 and its read-back),
both recorded by ``DeviceEngine.group_counts``, which finds the request in
``SERVING``, and ``groupby.assemble`` (the per-partition counts to rows:
the groups with a count, their decode, order and slice).

A span is a row of seven integers (``COLUMNS``) in preallocated arrays
used as a ring: no Python object per span, so the recorder does not add
to the collector's work it times. Start and end are ``time.time_ns()``,
the clock that ``torch.profiler`` (Kineto) stamps the card's events with,
so a span can be laid over the card's timeline. ``RECORDER.spans(t0_ns,
t1_ns)`` reads the rows that started in a window back, by column.

Readers: the benchmark's ``program_span`` metrics, and the operator's
summary: once every ``SUMMARY_S`` seconds of traced requests, one line on
this module's logger (the main log at INFO) with each span's count and
mean over the rows recorded since the line before.
"""

from __future__ import annotations

import gc
import itertools
import logging
import threading
import time

import numpy as np

NAMES = ("request", "parse", "batcher.enqueue", "batcher.wait",
         "batcher.wake", "batch", "batch.lower", "batch.count",
         "batch.readback", "gc", "mutations.filter", "mutations.reduce",
         "mutations.assemble", "groupby.filter", "groupby.reduce",
         "groupby.assemble")
(REQUEST, PARSE, BATCHER_ENQUEUE, BATCHER_WAIT, BATCHER_WAKE, BATCH,
 BATCH_LOWER, BATCH_COUNT, BATCH_READBACK, GC, MUTATIONS_FILTER,
 MUTATIONS_REDUCE, MUTATIONS_ASSEMBLE, GROUPBY_FILTER, GROUPBY_REDUCE,
 GROUPBY_ASSEMBLE) = range(len(NAMES))
COLUMNS = ("name", "start", "end", "thread", "id", "parent", "n")

# five rows a count (request, parse, batcher.enqueue, batcher.wait,
# batcher.wake) and four a batch: a 40 s window at up to 40,000 counts/s
# (the pages are mapped as rows are written: 56 bytes a row, 470 MB full)
CAPACITY = 1 << 23
SUMMARY_S = 60

PERFORMANCE_LOGGER = logging.getLogger("lapis_silo_torch.performance")
log = logging.getLogger(__name__)


class _Serving(threading.local):
    """What the calling thread serves, for spans recorded below the query
    engine: ``group_by`` is [its request's span, its parse's end, a
    group-by's read-back's end (0 until one ends)] while it serves a traced
    request on the device's Aggregated route, else None."""
    group_by = None


SERVING = _Serving()


class Recorder:
    """A ring of `capacity` spans. Ids come from one counter (taken when a
    span opens, so its children can name it), rows from another (taken
    when it closes)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        # zeroed pages are only mapped once written
        self._arrays = [np.zeros(capacity, dtype=np.int64) for _ in COLUMNS]
        self._columns = [memoryview(a) for a in self._arrays]
        self._ids = itertools.count(1)
        self._rows = itertools.count()
        self._gc_start = 0
        self._gc_lock = threading.Lock()
        self.collecting = False
        self._summary_lock = threading.Lock()
        self._summary_due = 0
        self._summary_row = self._summary_ns = 0

    def new_id(self) -> int:
        return next(self._ids)

    def record(self, name: int, start: int, end: int, span: int,
               parent: int = 0, n: int = 0) -> int:
        """Write a span; returns the number of the row it took."""
        row = next(self._rows)
        slot = row % self.capacity
        names, starts, ends, threads, ids, parents, ns = self._columns
        names[slot] = name
        starts[slot] = start
        ends[slot] = end
        threads[slot] = threading.get_ident()
        ids[slot] = span
        parents[slot] = parent
        ns[slot] = n
        return row

    def _read(self, slots: np.ndarray) -> dict:
        """The filled ones of `slots`, by column, in the order they
        started."""
        arrays = dict(zip(COLUMNS, (a[slots] for a in self._arrays)))
        filled = arrays["id"] > 0
        order = np.argsort(arrays["start"][filled], kind="stable")
        return {name: column[filled][order] for name, column in arrays.items()}

    def spans(self, t0_ns: int, t1_ns: int) -> dict | None:
        """The rows that started in [t0_ns, t1_ns), by column name, in the
        order they started; None where the ring has lost a row that may
        have (its oldest row ended after t0_ns)."""
        _, starts, ends, _, ids, _, _ = self._arrays
        filled = ids > 0
        # once the last slot is written, every row overwrites an older one
        if filled[-1] and ends.min(where=filled, initial=t0_ns + 1) > t0_ns:
            return None
        return self._read(np.flatnonzero(
            filled & (starts >= t0_ns) & (starts < t1_ns)))

    # -- the operator's summary ------------------------------------------------

    def tick(self, now_ns: int, row: int) -> None:
        """Once ``SUMMARY_S`` have passed, log the summary of the rows
        since the last line up to `row`, the one the caller just recorded;
        the first call only starts the clock."""
        if now_ns < self._summary_due or not self._summary_lock.acquire(
                blocking=False):
            return
        try:
            if now_ns < self._summary_due:
                return
            if self._summary_due and log.isEnabledFor(logging.INFO):
                log.info("%s", self.summary(
                    self._summary_row, row + 1,
                    (now_ns - self._summary_ns) / 1e9))
            self._summary_row, self._summary_ns = row + 1, now_ns
            self._summary_due = now_ns + SUMMARY_S * 10 ** 9
        finally:
            self._summary_lock.release()

    def summary(self, first: int, last: int, seconds: float) -> str:
        """Each span's count and mean over rows [first, last), the
        batches' mean queries, and how many of the rows the ring lost."""
        lost = max(0, last - first - self.capacity)
        rows = self._read(np.arange(first + lost, last) % self.capacity)
        parts = []
        for code, name in enumerate(NAMES):
            keep = rows["name"] == code
            if keep.any():
                took = rows["end"][keep] - rows["start"][keep]
                parts.append(f"{name} {int(keep.sum())} x "
                             f"{took.mean() / 1e6:.3f} ms")
        batches = rows["n"][rows["name"] == BATCH]
        if len(batches):
            parts.append(f"{batches.mean():.1f} queries a batch")
        if lost:
            parts.append(f"{lost} rows lost")
        return (f"spans in the last {seconds:.1f} s: "
                + (", ".join(parts) or "none"))

    # -- the collector --------------------------------------------------------

    def collect(self, on: bool) -> None:
        """Install the collector's callback (`on`) or remove it."""
        with self._gc_lock:
            if on and not self.collecting:
                gc.callbacks.append(self._on_gc)
            elif not on and self.collecting:
                gc.callbacks.remove(self._on_gc)
            self.collecting = on

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start = time.time_ns()
        elif self._gc_start:
            self.record(GC, self._gc_start, time.time_ns(), self.new_id(),
                        0, info["generation"])
            self._gc_start = 0


RECORDER = Recorder()


def enabled() -> bool:
    """Whether to record: the performance logger is enabled for INFO. The
    collector's callback follows the answer."""
    on = PERFORMANCE_LOGGER.isEnabledFor(logging.INFO)
    if on is not RECORDER.collecting:
        RECORDER.collect(on)
    return on
