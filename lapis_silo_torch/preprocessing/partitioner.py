"""Partitioning: group rows by the partitionBy key, bin-pack key groups.

Parity with the reference's recursive-CTE partitioner
(src/silo/preprocessing/preprocessor.cpp:146-253):

- distinct partition keys sorted ascending, NULLs first (DuckDB 0.8 default
  null ordering, empirically pinned by the e2e dateBetween corpus);
- allowed = total_rows / 32 (float division);
- greedy left-to-right merge: extend the current group while its accumulated
  count is still <= allowed, else start a new group.

Partitions are the unit the engine lays out on the card: each starts at a
word boundary of the flat word axis, and group-by counts per partition.
"""

from __future__ import annotations

TARGET_PARTITIONS = 32


def partition_keys(keys_with_counts: list[tuple[object, int]]) -> list[list[object]]:
    """keys_with_counts: (key, count) sorted by key (None first).
    Returns list of key groups (partitions) in order."""
    if not keys_with_counts:
        return []
    total = sum(c for _, c in keys_with_counts)
    allowed = total / TARGET_PARTITIONS
    groups: list[list[object]] = []
    current = [keys_with_counts[0][0]]
    acc = keys_with_counts[0][1]
    for key, count in keys_with_counts[1:]:
        if acc <= allowed:
            current.append(key)
            acc += count
        else:
            groups.append(current)
            current = [key]
            acc = count
    groups.append(current)
    return groups


def sort_key_nulls_first(value):
    """Sort key for partition-by values: None (NULL) first, then ascending
    by UTF-8 byte order (Python str ordering == UTF-8 byte order on
    codepoints, matching DuckDB's binary collation)."""
    return (value is not None, value if value is not None else "")
