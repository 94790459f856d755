"""mutations_sparse_word_pct: the words K3 read from the CSR stream as a
share of all the words that the window's Mutations reductions read. K2
reads every word of each dense row it reduces, over the flat word axis; K3
reads every entry of the stream, one stored word each, in each launch. The
words come from the port's row counters and its sizes; nothing from a port
without the counters."""

ROWS = ("mutation_dense_rows", "mutation_sparse_rows")
NAMES = ("mutation_dense_words", "mutation_sparse_entries")


def counters(engine):
    if not all(hasattr(engine, name) for name in ROWS):
        return {}
    # each K3 launch reduces every sparse row and every entry
    launches = (engine.mutation_sparse_rows // engine.n_sparse
                if engine.n_sparse else 0)
    entries = int(engine.sparse_idx.shape[0]) if engine.n_sparse else 0
    return {"mutation_dense_words": (engine.mutation_dense_rows
                                     * engine.n_flat_words),
            "mutation_sparse_entries": launches * entries}


def read(run):
    if not all(name in run.counters for name in NAMES):
        return None
    dense, sparse = (run.counter(name) for name in NAMES)
    return 100.0 * sparse / (dense + sparse) if dense + sparse else None
