"""dispatcher_us_per_query: the port's `batch` spans (the dispatcher's take
to its last release) summed over the queries they took. Times qps.counts it is
the dispatcher's busy share: near 1, the dispatcher paces the loop."""

from benchmark.program_spans import per_query


def read(run):
    return per_query(run, "batch", 1e3)
