"""Query error types.

QueryParseError -> HTTP 400 ("Bad request"); any other exception -> 500.
Parity with reference include/silo/query_engine/query_parse_exception.h.
"""


class QueryParseError(Exception):
    pass


class QueryCompilationError(Exception):
    pass


def check_query(condition, message: str):
    if not condition:
        raise QueryParseError(message)
