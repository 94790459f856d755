"""Pango lineage alias table.

Behavioral parity with reference src/silo/storage/pango_lineage_alias.cpp:
`unalias` expands a leading alias segment ("BA.5" -> "B.1.1.529.5"),
`alias` re-compresses the longest >3-element prefix that equals an alias
target. Multi-target aliases (recombinants) are never expanded.
"""

from __future__ import annotations

import json
import os


class PangoLineageAliasLookup:
    def __init__(self, alias_key: dict[str, list[str]] | None = None):
        self.alias_key: dict[str, list[str]] = alias_key or {}
        # alias target -> alias name, for single-target aliases only
        self._reverse: dict[str, str] = {}
        for alias, values in self.alias_key.items():
            if len(values) == 1:
                self._reverse.setdefault(values[0], alias)

    def unalias(self, pango_lineage: str) -> str:
        prefix, dot, suffix = pango_lineage.partition(".")
        values = self.alias_key.get(prefix)
        if values is None or len(values) != 1:
            return pango_lineage
        if not dot:
            return values[0]
        return values[0] + "." + suffix

    def alias(self, unaliased: str) -> str:
        elements = unaliased.split(".")
        for i in range(len(elements), 3, -1):
            search_value = ".".join(elements[: i - 1])
            alias = self._reverse.get(search_value)
            if alias is not None:
                leftover = ".".join(elements[i - 1 :])
                return alias + "." + leftover if leftover else alias
        return unaliased

    @staticmethod
    def parent_lineages(unaliased: str) -> list[str]:
        """All prefixes at dot boundaries, including the value itself.
        'B.1.1' -> ['B', 'B.1', 'B.1.1']; '' -> ['']."""
        parents = []
        pos = 0
        while True:
            idx = unaliased.find(".", pos + 1)
            if idx == -1:
                parents.append(unaliased)
                return parents
            parents.append(unaliased[:idx])
            pos = idx

    @classmethod
    def read_from_file(cls, path) -> "PangoLineageAliasLookup":
        if not os.path.exists(path):
            raise FileNotFoundError(f"Alias key file {path} does not exist")
        if not str(path).endswith(".json"):
            raise ValueError(f"Alias key file {path} is not a json file")
        with open(path) as f:
            raw = json.load(f)
        alias_key: dict[str, list[str]] = {}
        for key, value in raw.items():
            if isinstance(value, list):
                alias_key[key] = value
            elif isinstance(value, str) and value:
                alias_key[key] = [value]
        return cls(alias_key)

    def to_dict(self) -> dict:
        return dict(self.alias_key)
