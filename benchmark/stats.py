"""Percentiles over every request and the spread of repeated runs."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


def latencies_ms(run) -> list[float]:
    """Every request of the window, timed from when it was due: a failed
    one to its failure, one never answered to the end of the grace."""
    give_up = run.t1 + run.grace_s
    return [((r.end if r.end is not None else give_up) - r.due) * 1e3
            for r in run.records]


def spread(values) -> float:
    """The distance between the first and the third quartile as a share of
    the median (Python's quartiles, the 'exclusive' method)."""
    q1, median, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / median
