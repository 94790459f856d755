"""The port's own spans (``lapis_silo_torch.tracing``) that started inside
a traced run's window, for the readers of the ``program_span`` metrics.

Each helper returns None, and its reader leaves the metric out, where
there is nothing to read: an untraced run, a port without the recorder, a
window in which the port recorded nothing (its performance logger below
INFO), or a ring that has lost part of the window.
"""

from __future__ import annotations

import sys

import numpy as np

from benchmark.tracing import busy_s


def window(run) -> dict | None:
    """The window's spans by column (``tracing.COLUMNS``), in the order
    they started."""
    trace = run.trace
    if trace is None or not trace.t1_ns:
        return None
    try:
        from lapis_silo_torch import tracing
    except ImportError:
        return None
    rows = tracing.RECORDER.spans(trace.t0_ns, trace.t1_ns)
    if rows is None:
        print("program spans: the port's ring lost part of the window; its "
              "span metrics are left out", file=sys.stderr, flush=True)
        return None
    if not len(rows["id"]):
        return None
    return rows


def _of(rows: dict, name: str) -> dict:
    from lapis_silo_torch import tracing
    keep = rows["name"] == tracing.NAMES.index(name)
    return {column: values[keep] for column, values in rows.items()}


def named(run, name: str):
    """(start, end, n) of the window's spans called `name`, as arrays, or
    None."""
    rows = window(run)
    if rows is None:
        return None
    spans = _of(rows, name)
    return spans["start"], spans["end"], spans["n"]


def mean(run, name: str, unit_ns: float) -> float | None:
    """The mean duration of the `name` spans, in units of `unit_ns`."""
    spans = named(run, name)
    if spans is None or not len(spans[0]):
        return None
    starts, ends, _ = spans
    return float((ends - starts).mean()) / unit_ns


def per_query(run, name: str, unit_ns: float) -> float | None:
    """The `name` spans' summed duration over their summed ``n`` (the
    queries each served), in units of `unit_ns`."""
    spans = named(run, name)
    if spans is None or not spans[2].sum():
        return None
    starts, ends, ns = spans
    return float((ends - starts).sum()) / float(ns.sum()) / unit_ns


def union_pct(run, name: str) -> float | None:
    """The union of the `name` spans, cut at the window's end, as a share
    of the window: 0 where the port recorded spans but none of these."""
    spans = named(run, name)
    if spans is None:
        return None
    trace = run.trace
    events = [(name, s, e) for s, e in zip(spans[0].tolist(),
                                          spans[1].tolist())]
    return 100.0 * busy_s(events, trace.t0_ns, trace.t1_ns) / trace.window_s


def request_uncovered_pct(run) -> float | None:
    """How much of the counts' `request` spans their children leave
    uncovered, as a share of them: the summed `request` less, for each, its
    `parse`, `batcher.wait`, the batch serving it (the end of the wait to
    the start of `batcher.wake`) and `batcher.wake`. Requests without all
    three children (not counts) are left out."""
    rows = window(run)
    if rows is None:
        return None
    requests = _of(rows, "request")
    ids = requests["id"]
    children = [_of(rows, name)
                for name in ("parse", "batcher.wait", "batcher.wake")]
    for child in children:
        ids = np.intersect1d(ids, child["parent"])
    if not len(ids):
        return None

    def at(spans, key):  # the spans whose `key` is each of `ids`
        order = np.argsort(spans[key])
        pick = order[np.searchsorted(spans[key], ids, sorter=order)]
        return spans["start"][pick], spans["end"][pick]

    start, end = at(requests, "id")
    (parse_start, parse_end), (wait_start, _), (_, wake_end) = (
        at(child, "parent") for child in children)
    total = float((end - start).sum())
    covered = float(((parse_end - parse_start) + (wake_end - wait_start)).sum())
    return 100.0 * (total - covered) / total
