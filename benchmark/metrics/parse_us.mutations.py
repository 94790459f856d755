"""parse_us.mutations: the mean time of the port's `parse` spans
(Query(json): JSON, AST, action and filter key, on the client thread) of
the lineage cell's Mutations requests."""

from benchmark.program_spans import mean


def read(run):
    return mean(run, "parse", 1e3)
