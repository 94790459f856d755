"""batch_launch_ms: the mean time of the port's `batch.count` spans
(count_programs: host answers, pack, upload, pool plan, launch and
read-back), recorded inside the program."""

from benchmark.program_spans import mean


def read(run):
    return mean(run, "batch.count", 1e6)
