"""gc_pause_pct: the union of the port's `gc` spans (the collector's passes,
from gc.callbacks, on any thread) as a share of the window."""

from benchmark.program_spans import union_pct


def read(run):
    return union_pct(run, "gc")
