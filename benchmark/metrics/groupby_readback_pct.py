"""groupby_readback_pct: the group-bys' key spaces as a share of what
their read-backs brought to the host, from the port's counters: the
groups of each query's key space (`group_key_cells`) over the cells of
its per-partition counts, partitions times the bucket's columns
(`group_cells_read`). Nothing from a port without the counters."""

NAMES = ("group_key_cells", "group_cells_read")


def counters(engine):
    if not all(hasattr(engine, name) for name in NAMES):
        return {}
    return {name: getattr(engine, name) for name in NAMES}


def read(run):
    if not all(name in run.counters for name in NAMES):
        return None
    keys, cells = (run.counter(name) for name in NAMES)
    return 100.0 * keys / cells if cells else None
