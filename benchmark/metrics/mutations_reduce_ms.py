"""mutations_reduce_ms: the mean time of the port's `mutations.reduce`
spans (DeviceEngine.mutation_counts_many: K2 per segment and K3 over the
stream, their read-backs and the majority rebuild), in the lineage cell;
nothing from a port without the span."""

from benchmark.program_spans import mean


def read(run):
    from lapis_silo_torch import tracing
    if "mutations.reduce" not in tracing.NAMES:
        return None
    return mean(run, "mutations.reduce", 1e6)
