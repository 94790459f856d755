"""mutations_dense_read_pct: the bank words K2 read in the window as a
share of what its launches would read if each read every flat word of the
dense rows it reduced, from the port's counters: the words it read (each
launch reads only its partitions' own words in the partitions the filter
reaches) and the rows it reduced, times the flat words. Nothing from a
port without the counters."""

COUNTERS = ("mutation_dense_words_read", "mutation_dense_rows")
NAMES = ("mutation_dense_words_read", "mutation_dense_flat_words")


def counters(engine):
    if not all(hasattr(engine, name) for name in COUNTERS):
        return {}
    return {"mutation_dense_words_read": engine.mutation_dense_words_read,
            "mutation_dense_flat_words": (engine.mutation_dense_rows
                                          * engine.n_flat_words)}


def read(run):
    if not all(name in run.counters for name in NAMES):
        return None
    read_, whole = (run.counter(name) for name in NAMES)
    return 100.0 * read_ / whole if whole else None
