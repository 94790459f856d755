"""enqueue_ms: the mean time of the port's `batcher.enqueue` spans: a
count's client from the end of its parse to its item on the batcher's
queue (count_coalesced's wait on the engine's lowering lock)."""

from benchmark.program_spans import mean


def read(run):
    return mean(run, "batcher.enqueue", 1e6)
