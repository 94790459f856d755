"""wake_ms: the mean time of the port's `batcher.wake` spans: the
dispatcher releasing a count until its caller runs again (the interpreter
lock handed back to the woken callers)."""

from benchmark.program_spans import mean


def read(run):
    return mean(run, "batcher.wake", 1e6)
