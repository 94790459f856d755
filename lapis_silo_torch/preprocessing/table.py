"""Columnar, dictionary-encoded metadata accumulation for streaming ingest.

The reference streams metadata through DuckDB tables (preprocessor.cpp:
87-144); the previous Python path kept a list of per-row dicts, which costs
~1.1 GB per million rows (15x the file size) and forces per-row Python
inserts downstream. A MetadataTable holds, per schema field, an int32 code
per row plus the unique value strings — RAM scales with distinct values,
and the database build vectorizes (numpy lexsort ordering, bulk column
loads via each column's snapshot path).
"""

from __future__ import annotations

from array import array

import numpy as np


def normalize_value(value) -> str:
    """JSON scalar -> the engine's canonical string form (preprocessor's
    _normalize: None -> "", bools -> true/false, else str)."""
    if value is None:
        return ""
    if isinstance(value, bool):
        return "true" if value else "false"
    return str(value)


class MetadataTable:
    """Per-field dictionary-encoded columns, built row by row from any
    streaming source (TSV reader, NDJSON records)."""

    def __init__(self, fields: list[str]):
        self.fields = list(fields)
        self._codes: dict[str, array] = {f: array("i") for f in self.fields}
        self._ids: dict[str, dict[str, int]] = {f: {} for f in self.fields}
        self.values: dict[str, list[str]] = {f: [] for f in self.fields}
        self.n_rows = 0

    def append(self, get):
        """Append one row; `get(field)` returns the raw value (any JSON
        scalar or None)."""
        for field in self.fields:
            value = normalize_value(get(field))
            ids = self._ids[field]
            code = ids.get(value)
            if code is None:
                code = len(self.values[field])
                self.values[field].append(value)
                ids[value] = code
            self._codes[field].append(code)
        self.n_rows += 1

    def append_row_dict(self, row: dict):
        self.append(row.get)

    def codes(self, field: str) -> np.ndarray:
        return np.frombuffer(self._codes[field], dtype=np.int32)

    def strings(self, field: str) -> np.ndarray:
        """Per-row value strings as a numpy object array (for lexsort)."""
        vals = np.asarray(self.values[field], dtype=object)
        return vals[self.codes(field)]

    @classmethod
    def from_rows(cls, rows: list[dict], fields: list[str]) -> "MetadataTable":
        table = cls(fields)
        for row in rows:
            table.append_row_dict(row)
        return table
