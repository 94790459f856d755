"""gc_pause_pct.mutations: the union of the port's `gc` spans (the
collector's passes, from gc.callbacks, on any thread) as a share of the
window, in the lineage cell."""

from benchmark.program_spans import union_pct


def read(run):
    return union_pct(run, "gc")
