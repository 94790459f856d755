"""SILO's answers to a dashboard's variant page over the lineage corpus
(``benchmark/lineage.py``), computed plainly from its arrays, and the
control: the same a release behind.

``LineageReference`` answers ``PangoLineage``, ``DateBetween``, ``And`` and
both Mutations actions. This adds what the page sends beside them, with
LAPIS-SILO's semantics (github.com/GenSpectrum/LAPIS-SILO,
``src/silo/query_engine``):

- ``StringEquals`` on ``country``: the genomes holding the value (a value
  no genome holds selects none);
- ``Aggregated`` with no ``groupByFields``: one row, ``{"count": n}``, n the
  selected genomes (0 where none is);
- ``Aggregated`` grouped by ``date`` or by ``country``: one row per value
  held by a selected genome, ``{<column>: value, "count": n}``, with the
  date written as SILO writes a date column, ``YYYY-MM-DD``; no row for a
  value no selected genome holds. Without ``orderBy`` SILO's row order is
  its own: the comparison sorts both sides.

Nothing of the port is imported or read.
"""

from __future__ import annotations

import json

import numpy as np

from .lineage import LineageReference

COUNTRY_COLUMN = "country"


class DashboardReference(LineageReference):
    """`corpus` is a ``benchmark.lineage.Corpus``."""

    def select(self, node) -> np.ndarray:
        if node["type"] != "StringEquals":
            return super().select(node)
        if node["column"] != COUNTRY_COLUMN:
            raise ValueError(f"no string column {node['column']!r}")
        countries = self.corpus.countries
        if node["value"] not in countries:
            return np.zeros(self.n, dtype=bool)
        return self.corpus.country == countries.index(node["value"])

    def _aggregated(self, action, selected: np.ndarray) -> list[dict]:
        fields = action.get("groupByFields") or []
        if not fields:
            return [{"count": int(selected.sum())}]
        if len(fields) != 1:
            raise ValueError(f"the reference groups by one column, not "
                             f"{fields}")
        (field,) = fields
        if field == "date":
            counts = np.bincount(self.day[selected],
                                 minlength=self.corpus.n_days)
            text = self.corpus.date_text
        elif field == COUNTRY_COLUMN:
            counts = np.bincount(
                self.corpus.country[selected].astype(np.int64),
                minlength=len(self.corpus.countries))
            text = self.corpus.countries.__getitem__
        else:
            raise ValueError(f"the reference has no group column {field!r}")
        return [{field: text(int(value)), "count": int(counts[value])}
                for value in np.flatnonzero(counts)]

    def answer(self, query: str) -> list[dict]:
        """The ``queryResult`` rows of a JSON query."""
        data = json.loads(query)
        action = data["action"]
        if action["type"] != "Aggregated":
            return super().answer(query)
        return self._aggregated(action, self.select(data["filterExpression"]))


class StaleDashboardReference(DashboardReference):
    """The control of ``correct``: the configuration guarantees exact
    answers over the whole served snapshot, and this answers from the
    release before it, with every genome of the newest collection day
    missing (as ``lineage.StaleLineageReference`` does)."""

    def select(self, node) -> np.ndarray:
        return super().select(node) & (self.day < self.day.max())
