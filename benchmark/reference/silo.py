"""SILO's answers, computed plainly from the corpus arrays.

The semantics are LAPIS-SILO's (github.com/GenSpectrum/LAPIS-SILO,
``src/silo/query_engine``) for the filters and actions the benchmark's
traffic sends:

- ``NucleotideEquals``: the sequences holding the symbol at the position
  (``.`` names the reference's symbol);
- ``HasNucleotideMutation``: the sequences whose symbol differs from the
  reference. SILO builds it as an Or over A, C, G and T with the reference's
  symbol removed by ``std::remove`` without an erase (``has_mutation.cpp``),
  so T stays in the list: where the reference is T it matches every
  sequence;
- ``StringEquals`` on ``country``, ``DateBetween`` on ``date`` (both bounds
  inclusive, the date column being sorted), ``And``, ``Or``, ``Not``,
  ``N-Of``, ``True``, ``False``;
- ``Aggregated`` (a count, or counts grouped by ``date`` or ``country``),
  ``Mutations`` (for every position and non-reference symbol, the count
  among the filter's sequences when it exceeds ``ceil(total * minProportion)
  - 1``, with ``total`` the filter's size), and ``Details`` of the metadata
  fields, ordered by date, with a limit.

Every genome holds exactly one of A, C, G, T at every position, as the
corpus draws them. A filter's result is a set of sequences held as the
sorted list of its members or of its non-members (``Rows``), or, for a
metadata predicate, as its test (``Test``): a mutation selects a few
hundred of a million sequences, and the answers take a fraction of the
window's time. ``benchmark/tests/test_bench_reference.py`` holds them to a
plain evaluation over one boolean per sequence.
"""

from __future__ import annotations

import json
import math

import numpy as np

SYMBOLS = "-ACGT"


class Rows:
    """`rows` (sorted, distinct), or with `neg` every sequence but them."""

    __slots__ = ("rows", "neg")

    def __init__(self, rows, neg: bool = False):
        self.rows = np.asarray(rows, dtype=np.int64)
        self.neg = neg

    def contains(self, x: np.ndarray) -> np.ndarray:
        at = np.searchsorted(self.rows, x)
        hit = self.rows[np.minimum(at, len(self.rows) - 1)] == x if len(
            self.rows) else np.zeros(len(x), dtype=bool)
        return hit ^ self.neg

    def invert(self) -> "Rows":
        return Rows(self.rows, not self.neg)


class Test:
    """A metadata predicate, by its test of sequence numbers."""

    __slots__ = ("test", "neg")

    def __init__(self, test, neg: bool = False):
        self.test = test
        self.neg = neg

    def contains(self, x: np.ndarray) -> np.ndarray:
        return self.test(x) ^ self.neg

    def invert(self) -> "Test":
        return Test(self.test, not self.neg)


def _date_code(text: str) -> int:
    year, month, day = (int(part) for part in text.split("-"))
    return year * 10000 + month * 100 + day


class Reference:
    """The corpus' sequences as flat arrays, indexed by position and by
    sequence. `corpus` needs ``reference`` (symbol ids 1..4 per position)
    and ``partitions``, each with ``row_base``, ``n_rows``, ``days``,
    ``country``, and its mutations' ``rows``, ``positions``, ``symbols``
    in (row, position) order and ``by_position``, their order by (position,
    symbol, row); the metadata's constants are ``countries``, ``year`` and
    ``month``."""

    def __init__(self, corpus, countries, year: int, month: int):
        self.parts = corpus.partitions
        self.reference = np.asarray(corpus.reference, dtype=np.int64)
        self.length = len(self.reference)
        self.n = sum(p.n_rows for p in self.parts)
        self.countries = list(countries)
        self.year, self.month = year, month
        self.day = np.concatenate([p.days for p in self.parts]).astype(
            np.int64)
        self.country = np.concatenate([p.country for p in self.parts]).astype(
            np.int64)
        self.pos_start = []  # per partition: entries of a position
        self.row_start = []  # per partition: entries of a sequence
        for p in self.parts:
            for starts, values, size in ((self.pos_start, p.positions,
                                          self.length),
                                         (self.row_start, p.rows, p.n_rows)):
                offsets = np.zeros(size + 1, dtype=np.int64)
                np.cumsum(np.bincount(values, minlength=size),
                          out=offsets[1:])
                starts.append(offsets)
        self._all_counts = None

    # -- filters -------------------------------------------------------------

    def _at(self, position: int):
        """The sequences mutated at `position` and their symbols, in
        (partition, symbol, sequence) order."""
        rows, symbols = [], []
        for p, starts in zip(self.parts, self.pos_start):
            take = p.by_position[starts[position]:starts[position + 1]]
            rows.append(p.rows[take] + p.row_base)
            symbols.append(p.symbols[take])
        return np.concatenate(rows), np.concatenate(symbols)

    def _leaf(self, node):
        kind = node["type"]
        if kind == "NucleotideEquals":
            position = node["position"] - 1
            ref = int(self.reference[position])
            symbol = node["symbol"]
            sym = ref if symbol == "." else SYMBOLS.index(symbol)
            rows, symbols = self._at(position)
            if sym == ref:
                return Rows(np.sort(rows), neg=True)
            return Rows(rows[symbols == sym])  # sorted within a partition
        if kind == "HasNucleotideMutation":
            position = node["position"] - 1
            if SYMBOLS[int(self.reference[position])] == "T":
                return Rows([], neg=True)
            return Rows(np.sort(self._at(position)[0]))
        if kind == "StringEquals":
            if node["column"] != "country":
                raise ValueError(f"no string column {node['column']!r}")
            if node["value"] not in self.countries:
                return Rows([])
            value = self.countries.index(node["value"])
            return Test(lambda x: self.country[x] == value)
        if kind == "DateBetween":
            if node["column"] != "date":
                raise ValueError(f"no date column {node['column']!r}")
            lo = (_date_code(node["from"]) if node["from"] is not None
                  else -1)
            hi = _date_code(node["to"]) if node["to"] is not None else 1 << 62
            base = self.year * 10000 + self.month * 100

            def test(x):
                code = base + self.day[x]
                return (code >= lo) & (code <= hi)
            return Test(test)
        if kind == "True":
            return Rows([], neg=True)
        if kind == "False":
            return Rows([])
        raise ValueError(f"the reference has no filter {kind!r}")

    def _rows(self, part) -> Rows:
        if isinstance(part, Rows):
            return part
        members = np.flatnonzero(part.test(np.arange(self.n)))
        return Rows(members, neg=part.neg)

    def _and(self, parts) -> Rows:
        members = [p for p in parts if isinstance(p, Rows) and not p.neg]
        if not members:
            tests = [p for p in parts if isinstance(p, Test) and not p.neg]
            if tests:
                members = [self._rows(tests[0])]
                parts = [members[0]] + [p for p in parts if p is not tests[0]]
        if members:
            base = min(members, key=lambda p: len(p.rows))
            out = base.rows
            for p in parts:
                if p is not base:
                    out = out[p.contains(out)]
            return Rows(out)
        # every part excludes a list: the result excludes their union
        excluded = [self._rows(p).rows for p in parts]
        return Rows(np.unique(np.concatenate(excluded)) if excluded else [],
                    neg=True)

    def _n_of(self, parts, want: int, exactly: bool) -> Rows:
        parts = [self._rows(p) for p in parts]
        listed = np.unique(np.concatenate([p.rows for p in parts]))
        hits = np.zeros(len(listed), dtype=np.int64)
        for p in parts:
            hits += p.contains(listed)
        # a sequence no part lists is in every excluding part and no other

        def meets(count):
            return count == want if exactly else count >= want
        if meets(sum(p.neg for p in parts)):
            return Rows(listed[~meets(hits)], neg=True)
        return Rows(listed[meets(hits)])

    def _select(self, node):
        kind = node["type"]
        if kind == "And":
            return self._and([self._select(c) for c in node["children"]])
        if kind == "Or":
            return self._and([self._select(c).invert()
                              for c in node["children"]]).invert()
        if kind == "Not":
            return self._select(node["child"]).invert()
        if kind == "N-Of":
            return self._n_of([self._select(c) for c in node["children"]],
                              node["numberOfMatchers"], node["matchExactly"])
        return self._leaf(node)

    def select(self, node) -> Rows:
        """The sequences a filter expression selects."""
        return self._rows(self._select(node))

    def members(self, selected: Rows) -> np.ndarray:
        if not selected.neg:
            return selected.rows
        keep = np.ones(self.n, dtype=bool)
        keep[selected.rows] = False
        return np.flatnonzero(keep)

    def size(self, selected: Rows) -> int:
        return self.n - len(selected.rows) if selected.neg else len(
            selected.rows)

    # -- actions -------------------------------------------------------------

    def _date_text(self, day: int) -> str:
        return f"{self.year:04d}-{self.month:02d}-{day:02d}"

    def _counts_of(self, rows: np.ndarray) -> np.ndarray:
        """int64 [length, 5]: the mutations of the sequences `rows` by
        position and symbol."""
        keys = []
        for p, starts in zip(self.parts, self.row_start):
            local = rows[(rows >= p.row_base)
                         & (rows < p.row_base + p.n_rows)] - p.row_base
            lo, hi = starts[local], starts[local + 1]
            lengths = hi - lo
            take = np.repeat(lo - np.cumsum(lengths) + lengths, lengths) + (
                np.arange(int(lengths.sum())))
            keys.append(p.positions[take] * 5 + p.symbols[take])
        return np.bincount(np.concatenate(keys).astype(np.int64),
                           minlength=self.length * 5).reshape(self.length, 5)

    def _mutation_counts(self, selected: Rows) -> np.ndarray:
        if not selected.neg:
            return self._counts_of(selected.rows)
        if self._all_counts is None:
            self._all_counts = np.bincount(
                np.concatenate([p.positions * 5 + p.symbols
                                for p in self.parts]),
                minlength=self.length * 5).reshape(self.length, 5)
        return self._all_counts - self._counts_of(selected.rows)

    def _mutations(self, action, selected: Rows) -> list[dict]:
        if action.get("sequenceName") not in (None, "main", ["main"]):
            raise ValueError("the corpus has the one sequence 'main'")
        total = self.size(selected)
        if total == 0:
            return []
        proportion = float(action["minProportion"])
        threshold = 0 if proportion == 0 else math.ceil(total * proportion) - 1
        counts = self._mutation_counts(selected)
        positions, symbols = np.nonzero(counts > threshold)
        return [{"mutation": (SYMBOLS[int(self.reference[p])] + str(int(p) + 1)
                              + SYMBOLS[s]),
                 "sequenceName": "main",
                 "proportion": int(counts[p, s]) / total,
                 "count": int(counts[p, s])}
                for p, s in zip(positions, symbols)]

    def _aggregated(self, action, selected: Rows) -> list[dict]:
        fields = action.get("groupByFields", [])
        if not fields:
            return [{"count": self.size(selected)}]
        rows = self.members(selected)
        if fields == ["date"]:
            counts = np.bincount(self.day[rows], minlength=32)
            return [{"date": self._date_text(d), "count": int(c)}
                    for d, c in enumerate(counts) if c]
        if fields == ["country"]:
            counts = np.bincount(self.country[rows],
                                 minlength=len(self.countries))
            return [{"country": self.countries[i], "count": int(c)}
                    for i, c in enumerate(counts) if c]
        raise ValueError(f"the reference groups by date or country, "
                         f"not {fields}")

    def details_row(self, row: int, fields) -> dict:
        values = {"key": f"SEQ_{row}",
                  "date": self._date_text(int(self.day[row])),
                  "country": self.countries[int(self.country[row])]}
        return {name: values[name] for name in fields}

    def _details(self, action, selected: Rows) -> list[dict]:
        """One answer that SILO may give: the selected sequences in
        (order-by fields, sequence) order, limited. SILO breaks ties as its
        heap leaves them; ``check_details`` accepts any such order."""
        fields, order_by, limit = _details_shape(action)
        rows = self.members(selected)
        if order_by:
            rows = rows[np.argsort(self.day[rows], kind="stable")]
        return [self.details_row(int(r), fields) for r in rows[:limit]]

    def answer(self, query: str) -> list[dict]:
        """The ``queryResult`` rows of a JSON query."""
        data = json.loads(query)
        selected = self.select(data["filterExpression"])
        action = data["action"]
        kind = action["type"]
        if kind == "Aggregated":
            return self._aggregated(action, selected)
        if kind == "Mutations":
            return self._mutations(action, selected)
        if kind == "Details":
            return self._details(action, selected)
        raise ValueError(f"the reference has no action {kind!r}")

    def check_details(self, query: str, rows) -> bool:
        """Whether `rows` are a Details answer to `query`: the limit's
        number of distinct selected sequences, each row its sequence's
        fields, ordered by date, and their dates the smallest of the
        selection (SILO's order among equal dates is its own)."""
        data = json.loads(query)
        fields, order_by, limit = _details_shape(data["action"])
        chosen = self.members(self.select(data["filterExpression"]))
        if not isinstance(rows, list) or len(rows) != min(limit, len(chosen)):
            return False
        seen = []
        for row in rows:
            if not isinstance(row, dict) or set(row) != set(fields):
                return False
            key = row.get("key")
            if not (isinstance(key, str) and key.startswith("SEQ_")
                    and key[4:].isdigit()):
                return False
            seq = int(key[4:])
            if seq >= self.n or row != self.details_row(seq, fields):
                return False
            seen.append(seq)
        seen = np.asarray(seen, dtype=np.int64)
        if len(np.unique(seen)) != len(seen) or not Rows(chosen).contains(
                seen).all():
            return False
        days = self.day[seen]
        if order_by and (np.diff(days) < 0).any():
            return False
        smallest = np.sort(self.day[chosen])[:len(seen)]
        return bool(not order_by or (np.sort(days) == smallest).all())


def _details_shape(action):
    fields = action.get("fields")
    order_by = action.get("orderByFields", [])
    if (not fields or order_by not in ([], ["date"])
            or "limit" not in action):
        raise ValueError("the reference takes Details of named fields, "
                         "ordered by date or not, with a limit")
    return fields, order_by, action["limit"]
