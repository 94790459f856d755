"""batcher_wait_ms: the mean time of the port's `batcher.wait` spans: a
count queued for the micro-batcher until its dispatcher takes it."""

from benchmark.program_spans import mean


def read(run):
    return mean(run, "batcher.wait", 1e6)
