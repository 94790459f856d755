"""mutations_stream_read_pct: the stream entries K3 read in the window as a
share of what its launches would read if each read the whole CSR stream,
from the port's counters: the entries its launches read (each reads only
the query's alphabet in the partitions the filter reaches) and its
launches, times the stream's entries. Nothing from a port without the
counters."""

COUNTERS = ("mutation_sparse_entries_read", "mutation_sparse_launches")
NAMES = ("mutation_sparse_entries_read", "mutation_sparse_stream_entries")


def counters(engine):
    if not all(hasattr(engine, name) for name in COUNTERS):
        return {}
    entries = int(engine.sparse_idx.shape[0]) if engine.n_sparse else 0
    return {"mutation_sparse_entries_read":
            engine.mutation_sparse_entries_read,
            "mutation_sparse_stream_entries":
            engine.mutation_sparse_launches * entries}


def read(run):
    if not all(name in run.counters for name in NAMES):
        return None
    read_, whole = (run.counter(name) for name in NAMES)
    return 100.0 * read_ / whole if whole else None
