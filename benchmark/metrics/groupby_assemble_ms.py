"""groupby_assemble_ms: the mean time of the port's `groupby.assemble`
spans (the per-partition counts to rows: the groups with a count, their
decode, order and slice), in the variant-page cell; nothing from a port
without the span."""

from benchmark.program_spans import mean


def read(run):
    from lapis_silo_torch import tracing
    if "groupby.assemble" not in tracing.NAMES:
        return None
    return mean(run, "groupby.assemble", 1e6)
