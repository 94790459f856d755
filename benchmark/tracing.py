"""What a run with ``--trace 1`` records: the benchmark's own spans around
calls into the port, the VM launches' queries, the port's performance log,
and the card's timeline from ``torch.profiler``.

Host spans and the profiler's device events share one clock: Kineto stamps
both in nanoseconds of the system clock, which ``time.time_ns`` reads.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict

# port methods a span wraps, on the engine instance
ENGINE_SPANS = ("count_programs", "lower_cached", "group_counts",
                "mutation_counts_many", "evaluate_compact", "device_filter")
PERFORMANCE_LOGGER = "lapis_silo_torch.performance"


class Trace:
    def __init__(self):
        self.spans: list[tuple[str, int, int]] = []  # name, start, end ns
        # (ns, filter JSON of each query) per count launch
        self.launches: list[tuple[int, list[str]]] = []
        self.actions: list[tuple[str, float, float]] = []  # kind, filter us, action us
        # id of a lowered program: its filter's JSON. Holding the programs
        # would grow the collector's work for the whole window; an id that a
        # freed program leaves is taken over by the next lowering that gets
        # it, before that program reaches a launch
        self._programs: dict[int, str] = {}
        self._local = threading.local()
        self._handler = None
        self.device_events: list[tuple[str, int, int]] = []
        self.t0_ns = self.t1_ns = 0
        self._profiler = None

    # -- host ----------------------------------------------------------------

    def _span(self, name: str, fn):
        spans = self.spans

        def wrapper(*args, **kwargs):
            start = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.append((name, start, time.time_ns()))
        return wrapper

    def attach(self, engine) -> None:
        """Spans around the engine's routes, and which queries each count
        launch answered (from ``lower_cached`` and ``batch_args``)."""
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
        for name in ENGINE_SPANS:
            setattr(engine, name, self._span(name, getattr(engine, name)))
        logger = logging.getLogger(PERFORMANCE_LOGGER)
        trace = self

        class Actions(logging.Handler):
            def emit(self, record):
                filter_us, action_us = record.args
                trace.actions.append((getattr(trace._local, "kind", None),
                                      float(filter_us), float(action_us)))

        self._handler = Actions()
        logger.addHandler(self._handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False

    def execute(self, execute):
        """`execute` (of a generator.Request) with a span per request,
        named by its kind."""
        local, spans = self._local, self.spans

        def run(request):
            local.kind = request.kind
            start = time.time_ns()
            try:
                return execute(request)
            finally:
                spans.append((f"request:{request.kind}", start,
                              time.time_ns()))
        return run

    def detach(self, engine) -> None:
        for name in (*ENGINE_SPANS, "lower_cached", "batch_args"):
            engine.__dict__.pop(name, None)
        logging.getLogger(PERFORMANCE_LOGGER).removeHandler(self._handler)

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

    def window_spans(self, name: str) -> list[tuple[int, int]]:
        return [(start, end) for span, start, end in self.spans
                if span == name and self.in_window(start)]


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


def open_span(spans, at: int) -> str:
    """The name of the span open at `at` that started last."""
    best = None
    for name, start, end in spans:
        if start <= at < end and (best is None or start > best[1]):
            best = (name, start)
    return best[0] if best else "no span"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took the most time, by name, and the
    longest idle gaps, each named by the host span open in its middle."""
    by_name: dict[str, float] = defaultdict(float)
    for name, start, end in trace.device_events:
        by_name[name] += (end - start) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = [[open_span(trace.spans, (a + b) // 2), (b - a) / 1e9]
            for a, b in gaps(trace.device_events, trace.t0_ns,
                             trace.t1_ns)[:top]]
    return {"device_ops": [[name, s] for name, s in ops], "idle_gaps": idle}
