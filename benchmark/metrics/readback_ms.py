"""readback_ms: the mean time of the port's `batch.readback` spans: the
dispatcher blocked on the card until a launch's counts are on the host."""

from benchmark.program_spans import mean


def read(run):
    return mean(run, "batch.readback", 1e6)
