"""The bytes of a group-by's reduction, counted from the corpus whatever
implements it, and the share of the card's bandwidth K9 reaches
(``groupby_roofline_pct``).

A group-by by a column list is charged, per query, the filter once (4
bytes a word of every partition's own words), one code per genome at the
least width that holds the list's key space (1 byte up to 256 groups, 2 up
to 65,536, else 4), and 4 bytes of count per group of the key space. The
key space of a column is the distinct values the corpus holds in it; of a
list, their product. ``dashboard.build_database`` keeps these bytes on the
database by column list (``least_group_bytes``); the reader charges each
group-by answered inside the window its list's bytes.

The codes are charged for every genome, whatever the filter selects: a
filter that selects few genomes need not read the codes of the words it
leaves empty, and K9 does not. So the share is an upper bound on K9's
share of the card's bandwidth.
"""

from __future__ import annotations

import numpy as np

from benchmark.roofline import HBM_BYTES_PER_S

# K9 on the card's timeline
KERNEL = "group_counts_kernel"
# the columns a page groups by, and what the corpus holds in each
COLUMNS = ("date", "country")


def code_bytes(n_groups: int) -> int:
    """The least width of a code that tells `n_groups` groups apart."""
    return next(width for width in (1, 2, 4) if n_groups <= 1 << (8 * width))


def key_space(corpus, column: str) -> int:
    """The distinct values the corpus holds in `column`."""
    values = {"date": corpus.day, "country": corpus.country}[column]
    return len(np.unique(values))


def query_bytes(corpus, columns: tuple) -> int:
    """The least bytes of one group-by by `columns` over the corpus."""
    filter_words = sum((int(hi - lo) + 31) // 32 for lo, hi in zip(
        corpus.bounds[:-1], corpus.bounds[1:]))
    n_groups = int(np.prod([key_space(corpus, c) for c in columns]))
    return (4 * filter_words + corpus.n_rows * code_bytes(n_groups)
            + 4 * n_groups)


def least_bytes(corpus) -> dict:
    """{column: `query_bytes` of a group-by by that column alone}."""
    return {column: query_bytes(corpus, (column,)) for column in COLUMNS}


def groupby_roofline_pct(run, least: dict, grouped: dict):
    """The time of the window's group-bys' least bytes at the card's
    bandwidth over K9's time on the card, in %: `least` is
    ``least_group_bytes`` ({column: bytes}), `grouped` {column: group-bys
    answered inside the window}. None without a timeline, K9 time or a
    group-by."""
    if run.trace is None or not run.trace.device_events or not least:
        return None
    kernel_s = sum(end - start for name, start, end in run.trace.device_events
                   if KERNEL in name) / 1e9
    total = sum(least[column] * n for column, n in grouped.items())
    if not kernel_s or not total:
        return None
    return 100.0 * total / HBM_BYTES_PER_S / kernel_s
