"""Per-(sequence, position) insertion index with a 3-mer inverted index.

Behavioral parity with reference src/silo/storage/column/insertion_index.cpp:
`search(position, pattern)` regex-*searches* (substring semantics,
std::regex_search) the pattern over the distinct insertion values stored at
that position and unions the row-id sets of matching values.

The 3-mer inverted index is the reference's pruning structure
(insertion_index.cpp:145-223 buildThreeMerIndex — ALL overlapping 3-mers of
each distinct value of length >= 3 map to sorted insertion-id postings;
:33-56 extractThreeMers — the search pattern splits on the literal ".*" and
contributes NON-overlapping 3-mers per chunk, stride 3; :59-127
searchWithThreeMerIndex — k-way postings intersection selects candidates,
which are then regex-confirmed). Any value matching the pattern contains
every chunk as a substring, hence every chunk 3-mer, so pruning never
changes the result — it makes search cost sublinear in the number of
distinct insertion values. Patterns with no complete 3-mer fall back to the
full regex scan (:130-141 searchWithRegex).
"""

from __future__ import annotations

import re

import numpy as np

from ..ops import bitset


class _PositionIndex:
    """Built (immutable) search structures for one position."""

    __slots__ = ("values", "rows", "three_mers")

    def __init__(self, values, rows, three_mers):
        self.values: list[str] = values           # distinct insertion values
        self.rows: list[list[int]] = rows         # row ids per value
        # 3-mer -> int64[k] ascending insertion-id postings
        self.three_mers: dict[str, np.ndarray] = three_mers


class InsertionIndex:
    def __init__(self, alphabet):
        self.alphabet = alphabet
        self._symbols = frozenset(alphabet.iteration_chars)
        # position -> {insertion value -> list[row id]} (ingest-order)
        self.positions: dict[int, dict[str, list[int]]] = {}
        self._built: dict[int, _PositionIndex] | None = None

    def add(self, position: int, insertion: str, sequence_id: int):
        self.positions.setdefault(position, {}).setdefault(insertion, []).append(sequence_id)
        self._built = None

    def build(self, n_rows: int):
        """Validate values and build the per-position 3-mer postings
        (reference buildThreeMerIndex: illegal symbols in a value of
        length >= 3 fail preprocessing)."""
        built: dict[int, _PositionIndex] = {}
        for position, insertions in self.positions.items():
            values = list(insertions.keys())
            rows = list(insertions.values())
            three_mers: dict[str, list[int]] = {}
            for insertion_id, value in enumerate(values):
                if len(value) < 3:
                    continue
                bad = self.alphabet.find_illegal_char(value)
                if bad is not None:
                    raise ValueError(
                        f"Illegal {self.alphabet.name_lower} character '{bad}' "
                        f"in insertion: {value}"
                    )
                # every overlapping 3-mer, once per value; the outer loop
                # runs in ascending insertion_id order so postings stay
                # sorted for the intersection
                for i in range(len(value) - 2):
                    mer = value[i : i + 3]
                    postings = three_mers.setdefault(mer, [])
                    if not postings or postings[-1] != insertion_id:
                        postings.append(insertion_id)
            built[position] = _PositionIndex(
                values, rows,
                {m: np.asarray(p, dtype=np.int64) for m, p in three_mers.items()},
            )
        self._built = built

    def _search_three_mers(self, pattern: str) -> list[str]:
        """Non-overlapping 3-mers per ".*"-separated chunk (reference
        extractThreeMers, stride 3). The query layer restricts patterns to
        alphabet symbols + ".*"; anything else here mirrors the reference's
        hard error (insertion_index.cpp:41-46 "Wrong symbol ... in
        pattern")."""
        mers: dict[str, None] = {}
        for chunk in pattern.split(".*"):
            for ch in chunk:
                if ch not in self._symbols:
                    raise ValueError(f"Wrong symbol '{ch}' in pattern: {pattern}")
            for i in range(0, len(chunk) - 2, 3):
                mers[chunk[i : i + 3]] = None
        return list(mers)

    def search(self, position: int, pattern: str, n_rows: int) -> np.ndarray:
        if self._built is None:
            self.build(n_rows)
        pos = self._built.get(position)
        if pos is None:
            return bitset.empty_mask(n_rows)
        # reference order: extractThreeMers before the regex constructor, so
        # a wrong symbol reports before an invalid-regex error (e.g. an AA
        # '*' placed where the regex grammar rejects it)
        mers = self._search_three_mers(pattern)
        regex = re.compile(pattern)
        rows: list[int] = []
        if not mers:
            # no complete 3-mer in the pattern: full regex scan
            for value, ids in zip(pos.values, pos.rows):
                if regex.search(value):
                    rows.extend(ids)
        else:
            candidates: np.ndarray | None = None
            for mer in mers:
                postings = pos.three_mers.get(mer)
                if postings is None:
                    return bitset.empty_mask(n_rows)  # some 3-mer matches nothing
                if candidates is None:
                    candidates = postings
                else:
                    candidates = np.intersect1d(postings, candidates,
                                                assume_unique=True)
                    if candidates.size == 0:
                        return bitset.empty_mask(n_rows)
            for insertion_id in candidates:
                if regex.search(pos.values[insertion_id]):
                    rows.extend(pos.rows[insertion_id])
        return bitset.pack_ids(np.asarray(rows, dtype=np.int64), n_rows)
