"""mutations_assemble_ms: the mean time of the port's `mutations.assemble`
spans (the Mutations action: its rows on the host and their order) less
the `mutations.reduce` span under each (the reduction it waits on), in the
lineage cell; nothing from a port without the spans."""

import numpy as np

from benchmark.program_spans import window


def read(run):
    from lapis_silo_torch import tracing
    if "mutations.assemble" not in tracing.NAMES:
        return None
    rows = window(run)
    if rows is None:
        return None
    names, took = rows["name"], rows["end"] - rows["start"]
    assemble = names == tracing.NAMES.index("mutations.assemble")
    if not assemble.any():
        return None
    under = ((names == tracing.NAMES.index("mutations.reduce"))
             & np.isin(rows["parent"], rows["id"][assemble]))
    return float(took[assemble].sum() - took[under].sum()) / (
        int(assemble.sum()) * 1e6)
