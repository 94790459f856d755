"""mutations_filter_ms: the mean time of the port's `mutations.filter`
spans (DeviceEngine.device_filter: the lowering and the VM launch), in the
lineage cell; nothing from a port without the span."""

from benchmark.program_spans import mean


def read(run):
    from lapis_silo_torch import tracing
    if "mutations.filter" not in tracing.NAMES:
        return None
    return mean(run, "mutations.filter", 1e6)
