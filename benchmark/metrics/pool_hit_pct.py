"""pool_hit_pct: the hot-leaf pool's hits over its lookups in the window,
from the engine's pool_hits and pool_misses."""


def read(run):
    hits, misses = run.counter("pool_hits"), run.counter("pool_misses")
    return 100.0 * hits / (hits + misses) if hits + misses else None
