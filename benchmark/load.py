"""Load from client threads in the benchmark's process, as a server's worker
threads call ``Database.execute_query``.

- ``closed``: each client sends its next request when its reply came;
- ``open``: requests fall due at fixed offsets and wait in a queue for a
  worker; a request's latency runs from when it was due, so a stall shows
  in every request behind it.

A request's error is recorded with it, never dropped. In the window a
closed loop writes its times into arrays, and holds only the answers that
the check may read: the harness adds few objects to the collector's work,
which the program pays for in its own passes. The records are built once
the window has closed.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from array import array
from dataclasses import dataclass, field

# how long past the window's close the load waits for replies
GRACE_S = 60.0


@dataclass
class Record:
    index: int  # into the request list
    kind: str
    due: float  # perf_counter seconds
    start: float
    end: float | None = None  # None: no reply within the grace
    response: object = None
    error: str | None = None
    held: bool = True  # the answer was kept for the check

    @property
    def ok(self) -> bool:
        return self.end is not None and self.error is None


def _call(execute, request, record: Record) -> None:
    """`execute` takes a generator.Request."""
    try:
        record.response = execute(request)
    except Exception as ex:  # noqa: BLE001 — a failed request is a result
        record.error = f"{type(ex).__name__}: {ex}"
    record.end = time.perf_counter()


def _close_at(t_end: float, at_close) -> None:
    wait = t_end - time.perf_counter()
    if wait > 0:
        time.sleep(wait)
    if at_close is not None:
        at_close()


@dataclass
class _Log:
    """One client's requests: index, start and end, in arrays; an end is
    missing for a request never answered."""
    index: array = field(default_factory=lambda: array("q"))
    start: array = field(default_factory=lambda: array("d"))
    end: array = field(default_factory=lambda: array("d"))
    errors: dict = field(default_factory=dict)
    responses: dict = field(default_factory=dict)


def closed(execute, requests, clients: int, seconds: float | None,
           at_close=None, hold=None):
    """Clients send requests in index order until the window of `seconds`
    closes (`requests` a generator.RequestStream, which never runs out), or
    with `seconds` None until every request of the list was sent once.
    `hold(i)` says whether request i's answer is kept for the check (all
    when `hold` is None). `at_close` runs in the calling thread when the
    window closes, before the replies still due are awaited. Returns
    (records of every request sent, window start, window end)."""
    counter = itertools.count()
    logs = [_Log() for _ in range(clients)]
    gate = threading.Barrier(clients + 1)
    window = {}

    def client(log: _Log) -> None:
        gate.wait()
        t_end = window["end"]
        while True:
            # the close is checked before an index is taken: every index
            # taken is sent and recorded
            start = time.perf_counter()
            if start >= t_end:
                return
            i = next(counter)
            if seconds is None and i >= len(requests):
                return
            request = requests[i]
            log.index.append(i)
            log.start.append(start)
            try:
                response = execute(request)
            except Exception as ex:  # noqa: BLE001 — a failed request is a result
                log.errors[i] = f"{type(ex).__name__}: {ex}"
            else:
                if hold is None or hold(i):
                    log.responses[i] = response
            log.end.append(time.perf_counter())

    threads = [threading.Thread(target=client, args=(log,), daemon=True,
                                name=f"bench-client-{n}")
               for n, log in enumerate(logs)]
    for thread in threads:
        thread.start()
    t0 = time.perf_counter()
    window["end"] = float("inf") if seconds is None else t0 + seconds
    gate.wait()
    if seconds is not None:
        _close_at(window["end"], at_close)
    deadline = window["end"] + GRACE_S
    for thread in threads:
        thread.join(timeout=max(0.0, deadline - time.perf_counter())
                    if seconds is not None else None)
    records = []
    for log in logs:
        ends = log.end[:]
        for k, i in enumerate(log.index[:]):
            start = log.start[k]
            answered = k < len(ends)
            records.append(Record(
                i, requests[i].kind, start, start,
                ends[k] if answered else None, log.responses.get(i),
                log.errors.get(i), hold is None or hold(i)))
    records.sort(key=lambda r: r.start)
    t1 = time.perf_counter() if seconds is None else t0 + seconds
    return records, t0, t1


def open_(execute, requests, arrivals, workers: int, seconds: float,
          at_close=None):
    """Request k falls due at window start + arrivals[k] and is served by
    the first free worker; `at_close` as in ``closed``. Returns (records
    of every request due, window start, window end, lateness of the
    dispatch per request in seconds)."""
    pending: queue.SimpleQueue = queue.SimpleQueue()
    records = [Record(k, requests[k].kind, 0.0, 0.0)
               for k in range(len(arrivals))]

    def worker() -> None:
        while True:
            k = pending.get()
            if k is None:
                return
            record = records[k]
            record.start = time.perf_counter()
            _call(execute, requests[k], record)

    threads = [threading.Thread(target=worker, daemon=True,
                                name=f"bench-worker-{n}")
               for n in range(workers)]
    for thread in threads:
        thread.start()
    lateness = []
    t0 = time.perf_counter() + 0.01
    for k, offset in enumerate(arrivals):
        due = t0 + float(offset)
        records[k].due = due
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        pending.put(k)
        lateness.append(time.perf_counter() - due)
    _close_at(t0 + seconds, at_close)
    for _ in threads:
        pending.put(None)
    deadline = t0 + seconds + GRACE_S
    for thread in threads:
        thread.join(timeout=max(0.0, deadline - time.perf_counter()))
    return records, t0, t0 + seconds, lateness
