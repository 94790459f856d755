"""lower_us_per_query: the port's `batch.lower` spans (the dispatcher's
lower_cached loop) summed over the queries they lowered."""

from benchmark.program_spans import per_query


def read(run):
    return per_query(run, "batch.lower", 1e3)
