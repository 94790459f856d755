"""groupby_filter_ms: the mean time of the port's `groupby.filter` spans
(parse's end to the group-by's filter on the card: its lowering and VM
launch), in the variant-page cell; nothing from a port without the
span."""

from benchmark.program_spans import mean


def read(run):
    from lapis_silo_torch import tracing
    if "groupby.filter" not in tracing.NAMES:
        return None
    return mean(run, "groupby.filter", 1e6)
