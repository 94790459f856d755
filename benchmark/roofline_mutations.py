"""The bytes of the lineage cell's Mutations reductions, counted from
the corpus whatever tiers the port picks, and the share of the card's
bandwidth the reductions reach (``mutations_roofline_pct``).

A Mutations query is charged, for each segment it names, every non-zero
word of every (symbol, position) row that is not its partition's majority
(SILO's stored rows, ``benchmark.lineage.stored_rows``), 4 bytes each, and
the filter once, 4 bytes a word of every partition. ``build_database``
counts the stored words per alphabet as it builds the partitions and keeps
these bytes on the database (``least_mutation_bytes``); the port's count of
the Mutations queries for which K2 or K3 launched, by alphabet, gives the
window's total.

The bytes are charged over every partition, whatever the filter selects:
a query whose filter is empty in a partition need not read that
partition's rows, and a lineage's filter is empty in most of them. So the
share is an upper bound on the reductions' share of the card's bandwidth.
"""

from __future__ import annotations

from benchmark.roofline import HBM_BYTES_PER_S

# K2 (the dense rows) and K3 (the sparse stream) on the card's timeline
KERNELS = ("mutation_counts_kernel", "sparse_counts_kernel")
COUNTER = "mutations_least_bytes"


def query_bytes(entries: dict, corpus) -> dict:
    """{alphabet: least bytes of one Mutations query}: 4 a stored word of
    the alphabet's segments (`entries`) and 4 a word of the filter."""
    filter_words = sum((int(hi - lo) + 31) // 32 for lo, hi in zip(
        corpus.bounds[:-1], corpus.bounds[1:]))
    return {kind: 4 * count + 4 * filter_words
            for kind, count in entries.items()}


def least_bytes(corpus) -> dict:
    """`query_bytes` counted afresh from the corpus' stored rows."""
    from benchmark.lineage import stored_rows
    entries = {"nuc": 0, "aa": 0}
    for p in range(corpus.n_partitions):
        for segment in corpus.segments:
            entries[segment.kind] += len(stored_rows(corpus, p, segment).bits)
    return query_bytes(entries, corpus)


def counters(engine) -> dict:
    """The bytes of the Mutations queries the port has reduced on the card
    so far, by its per-alphabet count; nothing where the port or the
    database lacks them."""
    queries = getattr(engine, "mutation_queries", None)
    least = getattr(engine.db, "least_mutation_bytes", None)
    if queries is None or least is None:
        return {}
    return {COUNTER: sum(int(queries.get(kind, 0)) * least[kind]
                         for kind in least)}


def mutations_roofline_pct(run):
    """The time of the window's Mutations reductions' bytes at the card's
    bandwidth over K2's and K3's time on the card, in %; None without a
    timeline, the counter or a reduction."""
    if (run.trace is None or not run.trace.device_events
            or COUNTER not in run.counters):
        return None
    kernel_s = sum(end - start for name, start, end in run.trace.device_events
                   if any(k in name for k in KERNELS)) / 1e9
    least = run.counter(COUNTER)
    if not kernel_s or not least:
        return None
    return 100.0 * least / HBM_BYTES_PER_S / kernel_s
