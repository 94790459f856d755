"""request_uncovered_pct: the share of the port's count `request` spans
that their children (`parse`, `batcher.wait`, the batch serving the
request, `batcher.wake`) leave uncovered: how far the spans account for a
request."""

from benchmark.program_spans import request_uncovered_pct


def read(run):
    return request_uncovered_pct(run)
