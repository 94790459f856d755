"""What a run with ``--trace 1`` records: which queries each VM launch
answered, the port's spans (its performance logger set to INFO turns its
recorder on, ``lapis_silo_torch.tracing``), and the card's timeline from
``torch.profiler``; and the breakdown of the card's time and idle gaps,
the gaps named by the port's spans.

The port's spans and the profiler's device events share one clock: Kineto
stamps both in nanoseconds of the system clock, which ``time.time_ns``
reads.
"""

from __future__ import annotations

import logging
import sys
import time
from collections import defaultdict

import numpy as np

PERFORMANCE_LOGGER = "lapis_silo_torch.performance"
# a gap's name where the port's ring lost part of the window
RING_LOST = "ring lost"


class Trace:
    def __init__(self):
        # (ns, filter JSON of each query) per count launch
        self.launches: list[tuple[int, list[str]]] = []
        # id of a lowered program: its filter's JSON. Holding the programs
        # would grow the collector's work for the whole window; an id that a
        # freed program leaves is taken over by the next lowering that gets
        # it, before that program reaches a launch
        self._programs: dict[int, str] = {}
        self._logger_was = (logging.NOTSET, True)
        self.device_events: list[tuple[str, int, int]] = []
        self.t0_ns = self.t1_ns = 0
        self._profiler = None

    # -- host ----------------------------------------------------------------

    def attach(self, engine) -> None:
        """Note which queries each count launch answered (from
        ``lower_cached`` and ``batch_args``), and turn the port's span
        recorder on: its performance logger at INFO."""
        programs = self._programs
        launches = self.launches
        lower_cached = engine.lower_cached
        batch_args = engine.batch_args

        def lower_noting(filter_expr, key=None):
            result = lower_cached(filter_expr, key)
            programs[id(result[0])] = key
            return result

        def batch_noting(lowered, *args, **kwargs):
            launches.append((time.time_ns(), [
                programs[id(p)] for p in lowered if id(p) in programs]))
            return batch_args(lowered, *args, **kwargs)

        engine.lower_cached = lower_noting
        engine.batch_args = batch_noting
        logger = logging.getLogger(PERFORMANCE_LOGGER)
        self._logger_was = (logger.level, logger.propagate)
        # the records themselves go nowhere: the spans are what is read
        logger.setLevel(logging.INFO)
        logger.propagate = False

    def detach(self, engine) -> None:
        for name in ("lower_cached", "batch_args"):
            engine.__dict__.pop(name, None)
        logger = logging.getLogger(PERFORMANCE_LOGGER)
        level, logger.propagate = self._logger_was
        logger.setLevel(level)

    # -- device --------------------------------------------------------------

    def start(self, device) -> None:
        if device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            self._profiler = profile(activities=[ProfilerActivity.CUDA])
            self._profiler.start()
        self.t0_ns = time.time_ns()

    def stop(self, device) -> None:
        if device.type == "cuda":
            import torch
            torch.cuda.synchronize(device)
        self.t1_ns = time.time_ns()
        if self._profiler is None:
            return
        from torch.autograd import DeviceType
        self._profiler.stop()
        for event in self._profiler.profiler.kineto_results.events():
            if event.device_type() == DeviceType.CUDA:
                start = event.start_ns()
                self.device_events.append(
                    (event.name(), start, start + event.duration_ns()))
        self._profiler = None

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def in_window(self, at_ns: int) -> bool:
        return self.t0_ns <= at_ns < self.t1_ns


def busy(events, t0: int, t1: int) -> list[tuple[int, int]]:
    """The union of the events' intervals inside [t0, t1], merged."""
    merged: list[list[int]] = []
    for _, start, end in sorted(events, key=lambda e: e[1]):
        start, end = max(start, t0), min(end, t1)
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def busy_s(events, t0: int, t1: int) -> float:
    return sum(b - a for a, b in busy(events, t0, t1)) / 1e9


def gaps(events, t0: int, t1: int) -> list[tuple[int, int]]:
    """The idle intervals of [t0, t1], longest first."""
    out = []
    at = t0
    for a, b in busy(events, t0, t1):
        if a > at:
            out.append((at, a))
        at = b
    if t1 > at:
        out.append((at, t1))
    return sorted(out, key=lambda g: g[0] - g[1])


def gap_names(trace: Trace, middles: list[int]) -> list[str]:
    """The port's span open at each of `middles`: a ``gc`` span (a
    collector pass) first, else the innermost, the one that started last.
    Where the port's ring lost part of the window, every gap is
    ``RING_LOST``, and standard error says so."""
    from lapis_silo_torch import tracing

    rows = tracing.RECORDER.spans(trace.t0_ns, trace.t1_ns)
    if rows is None:
        print("breakdown: the port's ring lost part of the window; idle gaps "
              f"are named {RING_LOST!r}", file=sys.stderr, flush=True)
        return [RING_LOST] * len(middles)
    names, starts, ends = rows["name"], rows["start"], rows["end"]
    out = []
    for at in middles:
        open_ = (starts <= at) & (at < ends)
        collecting = open_ & (names == tracing.GC)
        hits = np.flatnonzero(collecting if collecting.any() else open_)
        if not len(hits):
            out.append("no span")
            continue
        # the latest start; of spans that started together, the first to end
        pick = max(hits.tolist(), key=lambda i: (starts[i], -ends[i]))
        out.append(tracing.NAMES[names[pick]])
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took the most time, by name, and the
    longest idle gaps, each named by the port's span open in its middle
    (`gap_names`)."""
    by_name: dict[str, float] = defaultdict(float)
    for name, start, end in trace.device_events:
        by_name[name] += (end - start) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = gaps(trace.device_events, trace.t0_ns, trace.t1_ns)[:top]
    names = gap_names(trace, [(a + b) // 2 for a, b in longest])
    idle = [[name, (b - a) / 1e9] for name, (a, b) in zip(names, longest)]
    return {"device_ops": [[name, s] for name, s in ops], "idle_gaps": idle}
