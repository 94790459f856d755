"""SILO's Mutations answers over the lineage corpus (``benchmark/lineage.py``),
computed plainly from its arrays, and the control: the same a release
behind.

The semantics are LAPIS-SILO's (github.com/GenSpectrum/LAPIS-SILO,
``src/silo/query_engine``) for what the lineage cell sends:

- ``PangoLineage``: the value upper-cased and its leading alias expanded
  (an alias of one target; ``pango_lineage_alias.cpp``); the genomes of
  that lineage, or with ``includeSublineages`` of it and every lineage
  whose name continues it at a dot (``BA.1`` takes ``BA.1.1`` but not
  ``BA.10``);
- ``DateBetween`` on the sorted date column, both bounds inclusive, a
  null bound open; ``And``;
- ``Mutations`` and ``AminoAcidMutations`` (``mutations.cpp``): for each
  named segment of the alphabet (all of them, by name, when none is
  named), each position and each valid symbol other than the reference's,
  the count among the selected genomes when it exceeds ``ceil(total *
  minProportion) - 1`` (every count above 0 at ``minProportion`` 0), with
  ``total`` the selected genomes holding a valid symbol there: N and X
  (missing) are not counted. The proportion is count / total.

A genome's symbols are its lineage's path mutations, its private
mutations and its run of the missing symbol (the corpus module's
docstring). The counts come straight from those arrays: the path's
symbols weighted by how many selected genomes each lineage has, each
private mutation of a selected genome adding its symbol and taking away
the one it replaced, and each run of a selected genome counting as missing
and taking away the path mutations it covers. Nothing of the port is
imported or read.
"""

from __future__ import annotations

import json

import numpy as np


class LineageReference:
    """`corpus` is a ``benchmark.lineage.Corpus``."""

    def __init__(self, corpus):
        self.corpus = corpus
        tree = corpus.tree
        self.alias_key = tree.alias_key
        self.unaliased = np.asarray(tree.unaliased, dtype=object)
        self.lineage = corpus.lineage.astype(np.int64)
        self.day = corpus.day.astype(np.int64)
        self.n = corpus.n_rows
        self.segments = {s.name: s for s in corpus.segments}

    # -- filters -------------------------------------------------------------

    def _unalias(self, value: str) -> str:
        prefix, dot, rest = value.partition(".")
        targets = self.alias_key.get(prefix)
        if targets is None or len(targets) != 1:
            return value
        return targets[0] + dot + rest

    def _lineages(self, value: str, sublineages: bool) -> np.ndarray:
        """bool [lineages]: the lineages a PangoLineage value names."""
        name = self._unalias(value.upper())
        exact = self.unaliased == name
        if not sublineages:
            return exact
        under = np.array([u.startswith(name + ".") for u in self.unaliased],
                         dtype=bool)
        return exact | under

    def _day(self, text: str) -> int:
        return int((np.datetime64(text, "D")
                    - np.datetime64(self.corpus.first_day, "D")).astype(int))

    def select(self, node) -> np.ndarray:
        """bool [genomes]: the genomes a filter expression selects."""
        kind = node["type"]
        if kind == "And":
            out = np.ones(self.n, dtype=bool)
            for child in node["children"]:
                out &= self.select(child)
            return out
        if kind == "PangoLineage":
            if node["column"] != "pangoLineage":
                raise ValueError(f"no lineage column {node['column']!r}")
            return self._lineages(node["value"],
                                  node["includeSublineages"])[self.lineage]
        if kind == "DateBetween":
            if node["column"] != "date":
                raise ValueError(f"no date column {node['column']!r}")
            out = np.ones(self.n, dtype=bool)
            if node.get("from") is not None:
                out &= self.day >= self._day(node["from"])
            if node.get("to") is not None:
                out &= self.day <= self._day(node["to"])
            return out
        raise ValueError(f"the reference has no filter {kind!r}")

    # -- Mutations -------------------------------------------------------------

    def counts(self, name: str, selected: np.ndarray) -> tuple:
        """(counts int64 [length, symbols], missing int64 [length]) of the
        selected genomes in segment `name`; the reference symbol's column
        is not counted."""
        segment = self.segments[name]
        corpus = self.corpus
        s_count, length = len(segment.chars), segment.length
        size = length * s_count
        per_lineage = np.bincount(self.lineage[selected],
                                  minlength=len(self.unaliased))
        path_lineage, path_position, path_symbol = corpus.paths[name]
        path_key = path_position * s_count + path_symbol
        counts = np.rint(np.bincount(path_key, weights=per_lineage[
            path_lineage], minlength=size)).astype(np.int64)
        genome, position, symbol, base = corpus.private[name]
        pick = selected[genome]
        counts += np.bincount(position[pick] * s_count + symbol[pick],
                              minlength=size)
        counts -= np.bincount(position[pick] * s_count + base[pick],
                              minlength=size)
        run_genome, run_start, run_end = corpus.runs[name]
        pick = selected[run_genome]
        starts, ends = run_start[pick], run_end[pick]
        missing = np.zeros(length + 1, dtype=np.int64)
        np.add.at(missing, starts, 1)
        np.add.at(missing, ends, -1)
        missing = np.cumsum(missing)[:length]
        # the path mutations each run covers
        lineages = self.lineage[run_genome[pick]]
        line_key = path_lineage * length + path_position
        lo = np.searchsorted(line_key, lineages * length + starts)
        hi = np.searchsorted(line_key, lineages * length + ends)
        lengths = hi - lo
        covered = (np.repeat(lo - np.cumsum(lengths) + lengths, lengths)
                   + np.arange(int(lengths.sum())))
        counts -= np.bincount(path_key[covered], minlength=size)
        return counts.reshape(length, s_count), missing

    def _mutations(self, action, selected: np.ndarray) -> list[dict]:
        kind = "nuc" if action["type"] == "Mutations" else "aa"
        names = action.get("sequenceName")
        if names is None:
            names = sorted(s.name for s in self.segments.values()
                           if s.kind == kind)
        elif isinstance(names, str):
            names = [names]
        proportion = float(action["minProportion"])
        chosen = int(selected.sum())
        out = []
        for name in names:
            segment = self.segments[name]
            if segment.kind != kind:
                raise ValueError(f"{name!r} is not a {kind} segment")
            if not chosen:
                continue
            counts, missing = self.counts(name, selected)
            totals = chosen - missing
            threshold = (np.zeros(segment.length) if proportion == 0
                         else np.ceil(totals * proportion) - 1)
            valid = len(segment.chars) - 1  # the missing symbol is last
            counts = counts[:, :valid].copy()
            counts[np.arange(segment.length),
                   segment.reference.astype(np.int64)] = 0
            hit = (counts > threshold[:, None]) & (totals > 0)[:, None]
            for position, symbol in zip(*np.nonzero(hit)):
                count, total = int(counts[position, symbol]), int(
                    totals[position])
                out.append({
                    "mutation": (segment.chars[segment.reference[position]]
                                 + str(int(position) + 1)
                                 + segment.chars[symbol]),
                    "sequenceName": name,
                    "proportion": count / total,
                    "count": count})
        return out

    def answer(self, query: str) -> list[dict]:
        """The ``queryResult`` rows of a JSON query."""
        data = json.loads(query)
        selected = self.select(data["filterExpression"])
        action = data["action"]
        if action["type"] not in ("Mutations", "AminoAcidMutations"):
            raise ValueError(f"the reference has no action {action['type']!r}")
        return self._mutations(action, selected)


class StaleLineageReference(LineageReference):
    """The control of ``correct``: the configuration guarantees exact
    answers over the whole served snapshot, and this answers from the
    release before it, with every genome of the newest collection day
    missing (as ``control.StaleReference`` does for the other corpus)."""

    def select(self, node) -> np.ndarray:
        return super().select(node) & (self.day < self.day.max())

