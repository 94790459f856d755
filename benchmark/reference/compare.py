"""Whether a served answer says what the reference says.

Aggregated and Mutations rows come in SILO's own order when the query names
no order, so both sides' rows are compared as sorted lists, exactly (a
Mutations proportion is the same quotient of two integers on both sides).
A Details answer is judged by ``Reference.check_details``.
"""

from __future__ import annotations

import json


def _canonical(rows) -> list[str]:
    return sorted(json.dumps(row, sort_keys=True) for row in rows)


def agrees(reference, query: str, response) -> bool:
    """`response` is what ``Database.execute_query(query)`` returned."""
    if not isinstance(response, dict) or set(response) != {"queryResult"}:
        return False
    rows = response["queryResult"]
    if not isinstance(rows, list):
        return False
    if json.loads(query)["action"]["type"] == "Details":
        return reference.check_details(query, rows)
    return _canonical(rows) == _canonical(reference.answer(query))
