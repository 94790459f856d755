"""request_uncovered_pct.mutations: the share of the port's Mutations
`request` spans that their children (`parse`, `mutations.filter` and
`mutations.assemble`, which holds the reduction) leave uncovered: how far
the spans account for a Mutations request. Requests without all three are
left out; nothing from a port without the Mutations spans."""

import numpy as np

from benchmark.program_spans import window

CHILDREN = ("parse", "mutations.filter", "mutations.assemble")


def read(run):
    from lapis_silo_torch import tracing
    if not all(name in tracing.NAMES for name in CHILDREN):
        return None
    rows = window(run)
    if rows is None:
        return None
    names, parents = rows["name"], rows["parent"]
    took = rows["end"] - rows["start"]
    requests = names == tracing.NAMES.index("request")
    ids = rows["id"][requests]
    for name in CHILDREN:
        ids = np.intersect1d(ids, parents[names == tracing.NAMES.index(name)])
    if not len(ids):
        return None
    total = float(took[requests & np.isin(rows["id"], ids)].sum())
    covered = float(sum(
        took[(names == tracing.NAMES.index(name)) & np.isin(parents, ids)]
        .sum() for name in CHILDREN))
    return 100.0 * (total - covered) / total
