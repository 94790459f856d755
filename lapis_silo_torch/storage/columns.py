"""Typed metadata columns (per-partition) and their cross-partition dictionaries.

Behavioral parity with reference src/silo/storage/column/*.cpp, re-shaped for
vectorized evaluation: every per-partition column exposes dense numpy arrays
(value ids or raw values) so filters evaluate as elementwise compares that
pack into u32 bitsets, and indexed columns precompute per-value packed
bitsets ready to upload to the device's dynamic plane bank.

Null conventions (identical to the reference, tuple.cpp:80-160):
- string-ish: empty string value <=> null in JSON output
- int: INT32_MIN; float: NaN; date: 0
"""

from __future__ import annotations

import numpy as np

from ..common.dates import string_to_date
from ..ops import bitset
from .pango_alias import PangoLineageAliasLookup

INT_NULL = -(2**31)


class Dictionary:
    """id <-> string value map shared across partitions of one column."""

    def __init__(self):
        self.values: list[str] = []
        self._ids: dict[str, int] | None = {}

    @property
    def ids(self) -> dict[str, int]:
        # snapshot load defers the reverse map (_ids = None): building
        # value -> id for a 10M-value primary-key column costs seconds and
        # most serving sessions never look a raw value up
        if self._ids is None:
            self._ids = {v: i for i, v in enumerate(self.values)}
        return self._ids

    def get_or_create(self, value: str) -> int:
        idx = self.ids.get(value)
        if idx is None:
            idx = len(self.values)
            self.values.append(value)
            self.ids[value] = idx
        return idx

    def get(self, value: str) -> int | None:
        return self.ids.get(value)

    def lookup(self, idx: int) -> str:
        return self.values[idx]


class StringColumnPartition:
    """Unindexed string column: dict-encoded int32 ids per row."""

    kind = "string"

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary
        self._ids: list[int] = []
        self.ids: np.ndarray | None = None  # finalized int32[N]

    def insert(self, value: str):
        self._ids.append(self.dictionary.get_or_create(value))

    def insert_null(self):
        self.insert("")

    def finalize(self):
        self.ids = np.asarray(self._ids, dtype=np.int32)

    def value_at(self, row: int) -> str | None:
        value = self.dictionary.lookup(int(self.ids[row]))
        return value if value else None

    def values_at(self, rows: np.ndarray) -> list[str | None]:
        return [v if (v := self.dictionary.lookup(int(i))) else None for i in self.ids[rows]]

    def value_at_id(self, vid: int) -> str | None:
        value = self.dictionary.lookup(vid)
        return value if value else None

    def load_ids(self, ids: np.ndarray):
        self._ids = list(ids)
        self.finalize()


class IndexedStringColumnPartition:
    """Low-cardinality string column: ids + per-value packed bitsets."""

    kind = "indexed_string"

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary
        self._ids: list[int] = []
        self.ids: np.ndarray | None = None
        self.value_bitmaps: dict[int, np.ndarray] = {}  # value id -> u32[W]

    def insert(self, value: str):
        self._ids.append(self.dictionary.get_or_create(value))

    def insert_null(self):
        self.insert("")

    def finalize(self):
        self.ids = np.asarray(self._ids, dtype=np.int32)
        n = len(self.ids)
        for vid in np.unique(self.ids):
            self.value_bitmaps[int(vid)] = bitset.pack_bool(self.ids == vid)
        self._n_rows = n

    def filter(self, value: str) -> np.ndarray | None:
        vid = self.dictionary.get(value)
        if vid is None:
            return None
        return self.value_bitmaps.get(vid)

    def value_at(self, row: int) -> str | None:
        value = self.dictionary.lookup(int(self.ids[row]))
        return value if value else None

    def values_at(self, rows: np.ndarray) -> list[str | None]:
        return [v if (v := self.dictionary.lookup(int(i))) else None for i in self.ids[rows]]

    def value_at_id(self, vid: int) -> str | None:
        value = self.dictionary.lookup(vid)
        return value if value else None

    def load_ids(self, ids: np.ndarray):
        self._ids = list(ids)
        self.finalize()


class IntColumnPartition:
    kind = "int"

    def __init__(self):
        self._values: list[int] = []
        self.values: np.ndarray | None = None  # int32[N]

    def insert(self, value: str):
        try:
            self._values.append(int(value) if value != "" else INT_NULL)
        except ValueError:
            self._values.append(INT_NULL)

    def insert_null(self):
        self._values.append(INT_NULL)

    def finalize(self):
        self.values = np.asarray(self._values, dtype=np.int32)

    def value_at(self, row: int):
        v = int(self.values[row])
        return None if v == INT_NULL else v

    def values_at(self, rows: np.ndarray):
        return [None if v == INT_NULL else int(v) for v in self.values[rows]]


class FloatColumnPartition:
    kind = "float"

    def __init__(self):
        self._values: list[float] = []
        self.values: np.ndarray | None = None  # float64[N]

    def insert(self, value: str):
        try:
            self._values.append(float(value) if value != "" else float("nan"))
        except ValueError:
            self._values.append(float("nan"))

    def insert_null(self):
        self._values.append(float("nan"))

    def finalize(self):
        self.values = np.asarray(self._values, dtype=np.float64)

    def value_at(self, row: int):
        v = float(self.values[row])
        return None if np.isnan(v) else v

    def values_at(self, rows: np.ndarray):
        return [None if np.isnan(v) else float(v) for v in self.values[rows]]


class DateColumnPartition:
    kind = "date"

    def __init__(self, is_sorted: bool):
        self.is_sorted = is_sorted
        self._values: list[int] = []
        self.values: np.ndarray | None = None  # uint32[N]

    def insert(self, value: str):
        self._values.append(string_to_date(value))

    def insert_null(self):
        self._values.append(0)

    def finalize(self):
        self.values = np.asarray(self._values, dtype=np.uint32)

    def value_at(self, row: int):
        from ..common.dates import date_to_string

        return date_to_string(int(self.values[row]))

    def values_at(self, rows: np.ndarray):
        from ..common.dates import date_to_string

        return [date_to_string(int(v)) for v in self.values[rows]]


class PangoLineageColumnPartition:
    """Lineage column with exact-value and sublineage-closure bitsets.

    Values are stored as *unaliased* lineage ids; output re-aliases
    (reference: pango_lineage_column.cpp:21-56, tuple.cpp:115-123).
    """

    kind = "indexed_pango_lineage"

    def __init__(self, alias_key: PangoLineageAliasLookup, unaliased_dict: Dictionary,
                 aliased_dict: Dictionary):
        self.alias_key = alias_key
        self.unaliased_dict = unaliased_dict
        self.aliased_dict = aliased_dict
        self._ids: list[int] = []
        self.ids: np.ndarray | None = None
        self.value_bitmaps: dict[int, np.ndarray] = {}
        self.sublineage_bitmaps: dict[int, np.ndarray] = {}
        self._sublineage_rows: dict[int, list[int]] = {}

    def insert(self, value: str):
        unaliased = self.alias_key.unalias(value)
        parents = PangoLineageAliasLookup.parent_lineages(unaliased)
        for parent in parents:
            pid = self.unaliased_dict.get_or_create(parent)
            self.aliased_dict.get_or_create(self.alias_key.alias(parent))
            self._sublineage_rows.setdefault(pid, []).append(len(self._ids))
        vid = self.unaliased_dict.get_or_create(unaliased)
        self.aliased_dict.get_or_create(self.alias_key.alias(unaliased))
        self._ids.append(vid)

    def insert_null(self):
        self.insert("")

    def finalize(self):
        self.ids = np.asarray(self._ids, dtype=np.int32)
        n = len(self.ids)
        for vid in np.unique(self.ids):
            self.value_bitmaps[int(vid)] = bitset.pack_bool(self.ids == vid)
        for pid, rows in self._sublineage_rows.items():
            self.sublineage_bitmaps[pid] = bitset.pack_ids(
                np.asarray(rows, dtype=np.int64), n
            )

    def filter(self, value: str) -> np.ndarray | None:
        vid = self.unaliased_dict.get(self.alias_key.unalias(value))
        if vid is None:
            return None
        return self.value_bitmaps.get(vid)

    def filter_including_sublineages(self, value: str) -> np.ndarray | None:
        vid = self.unaliased_dict.get(self.alias_key.unalias(value))
        if vid is None:
            return None
        return self.sublineage_bitmaps.get(vid)

    def load_ids(self, ids: np.ndarray):
        """Rebuild from snapshot: per-row unaliased value ids + the shared
        dictionaries; sublineage closures recomputed from parent prefixes."""
        self._ids = list(ids)
        self.ids = np.asarray(self._ids, dtype=np.int32)
        n = len(self.ids)
        self._sublineage_rows = {}
        for vid in np.unique(self.ids):
            mask = self.ids == vid
            self.value_bitmaps[int(vid)] = bitset.pack_bool(mask)
            rows = np.nonzero(mask)[0]
            unaliased = self.unaliased_dict.lookup(int(vid))
            for parent in PangoLineageAliasLookup.parent_lineages(unaliased):
                pid = self.unaliased_dict.get(parent)
                if pid is not None:
                    self._sublineage_rows.setdefault(pid, []).extend(rows.tolist())
        for pid, rows in self._sublineage_rows.items():
            self.sublineage_bitmaps[pid] = bitset.pack_ids(
                np.asarray(sorted(rows), dtype=np.int64), n
            )

    def _aliased(self, vid: int) -> str | None:
        value = self.alias_key.alias(self.unaliased_dict.lookup(vid))
        return value if value else None

    def value_at(self, row: int) -> str | None:
        return self._aliased(int(self.ids[row]))

    def value_at_id(self, vid: int) -> str | None:
        return self._aliased(vid)

    def values_at(self, rows: np.ndarray):
        return [self._aliased(int(i)) for i in self.ids[rows]]


class InsertionColumnPartition:
    """Insertion column: raw per-row value strings + per-sequence insertion
    indexes (built in storage/insertion_index.py)."""

    def __init__(self, dictionary: Dictionary, default_sequence_name: str | None,
                 alphabet, kind: str):
        from .insertion_index import InsertionIndex

        self.kind = kind  # "nuc_insertion" | "aa_insertion"
        self.dictionary = dictionary
        self.default_sequence_name = default_sequence_name
        self.alphabet = alphabet
        self._ids: list[int] = []
        self.ids: np.ndarray | None = None
        self.insertion_indexes: dict[str, InsertionIndex] = {}
        self._InsertionIndex = InsertionIndex

    def insert(self, value: str):
        if value == "":
            self.insert_null()
            return
        sequence_id = len(self._ids)
        standardized_parts = []
        for entry in value.split(","):
            parts = [p.replace('"', "") for p in entry.split(":")]
            if len(parts) == 2:
                if self.default_sequence_name is None:
                    raise ValueError(
                        f"Failed to parse insertion due to invalid format: {entry}"
                    )
                sequence_name, position, insertion = (
                    self.default_sequence_name, _parse_u32(parts[0], entry), parts[1])
            elif len(parts) == 3:
                sequence_name, position, insertion = (
                    parts[0], _parse_u32(parts[1], entry), parts[2])
            else:
                raise ValueError(
                    f"Failed to parse insertion due to invalid format: {entry}"
                )
            index = self.insertion_indexes.setdefault(
                sequence_name, self._InsertionIndex(self.alphabet)
            )
            index.add(position, insertion, sequence_id)
            if sequence_name == self.default_sequence_name:
                standardized_parts.append(f"{position}:{insertion}")
            else:
                standardized_parts.append(f"{sequence_name}:{position}:{insertion}")
        self._ids.append(self.dictionary.get_or_create(",".join(standardized_parts)))

    def insert_null(self):
        self._ids.append(self.dictionary.get_or_create(""))

    def finalize(self):
        self.ids = np.asarray(self._ids, dtype=np.int32)
        for index in self.insertion_indexes.values():
            index.build(len(self.ids))

    def search(self, sequence_name: str, position: int, pattern: str) -> np.ndarray:
        """Returns u32[W] bitset of rows with a matching insertion."""
        index = self.insertion_indexes.get(sequence_name)
        if index is None:
            return bitset.empty_mask(len(self.ids))
        return index.search(position, pattern, len(self.ids))

    def value_at(self, row: int) -> str | None:
        value = self.dictionary.lookup(int(self.ids[row]))
        return value if value else None

    def values_at(self, rows: np.ndarray):
        return [v if (v := self.dictionary.lookup(int(i))) else None for i in self.ids[rows]]

    def value_at_id(self, vid: int) -> str | None:
        value = self.dictionary.lookup(vid)
        return value if value else None

    def load_ids(self, ids: np.ndarray):
        """Rebuild from snapshot: per-row standardized value ids. The
        insertion indexes are reconstructed by parsing each distinct value
        once and fanning its rows out."""
        self._ids = list(ids)
        self.ids = np.asarray(self._ids, dtype=np.int32)
        self.insertion_indexes = {}
        for vid in np.unique(self.ids):
            value = self.dictionary.lookup(int(vid))
            if not value:
                continue
            rows = np.nonzero(self.ids == vid)[0]
            for entry in value.split(","):
                parts = entry.split(":")
                if len(parts) == 2:
                    sequence_name, position, insertion = (
                        self.default_sequence_name, int(parts[0]), parts[1])
                else:
                    sequence_name, position, insertion = parts[0], int(parts[1]), parts[2]
                index = self.insertion_indexes.setdefault(
                    sequence_name, self._InsertionIndex(self.alphabet)
                )
                for row in rows:
                    index.add(position, insertion, int(row))
        for index in self.insertion_indexes.values():
            index.build(len(self.ids))


def _parse_u32(text: str, entry: str) -> int:
    try:
        value = int(text)
    except ValueError as ex:
        raise ValueError(
            f"Failed to parse insertion due to invalid format: {entry}. Error: {ex}"
        ) from ex
    if value < 0:
        raise ValueError(f"Failed to parse insertion due to invalid format: {entry}")
    return value
