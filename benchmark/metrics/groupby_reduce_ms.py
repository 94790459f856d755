"""groupby_reduce_ms: the mean time of the port's `groupby.reduce` spans
(DeviceEngine.count_groups: K9 over the filter's words and the group
codes, and the read-back of its per-partition counts), in the
variant-page cell; nothing from a port without the span."""

from benchmark.program_spans import mean


def read(run):
    from lapis_silo_torch import tracing
    if "groupby.reduce" not in tracing.NAMES:
        return None
    return mean(run, "groupby.reduce", 1e6)
