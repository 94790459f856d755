"""Shared HTTP request routing for the Python and native servers.

One routing function implements the reference's handler chain
(src/silo_api/request_handler_factory.cpp:20-39 routes /info and /query,
rest_resource.cpp answers 405 for disallowed methods, error_request_handler
converts any exception into a JSON 500) for BOTH front-ends: the pure-Python
http.server fallback and the native epoll server (native/silo_http.cpp).
"""

from __future__ import annotations

import logging
from urllib.parse import parse_qs, urlparse

from ..query.errors import QueryParseError

logger = logging.getLogger(__name__)


class DatabaseBackend:
    """Resolves a consistent snapshot per request from a DatabaseMutex
    (reference database_mutex.cpp: readers bundle the shared lock into a
    FixedDatabase handle — here the snapshot is immutable, so holding the
    object reference is the lock)."""

    def __init__(self, database_mutex):
        self._mutex = database_mutex
        # exposed so the native server's count fast path (server/fastpath.py)
        # can track snapshot swaps; CoordinatorBackend deliberately has none
        self.database_mutex = database_mutex

    def resolve(self):
        return _DatabaseView(self._mutex.get_database())


class _DatabaseView:
    def __init__(self, database):
        self._database = database

    def info(self, detailed: bool, tpu: bool) -> dict:
        if tpu:
            return self._database.tpu_info()
        return self._database.detailed_info() if detailed else self._database.info()

    def execute_query(self, query: str) -> dict:
        return self._database.execute_query(query)

    @property
    def data_version(self) -> str:
        return self._database.data_version.value


class CoordinatorBackend:
    """The same protocol answered by a multi-host Coordinator (fan-out +
    merge, parallel/multihost.py). The data-version is the slice's
    consistent version."""

    def __init__(self, coordinator):
        self._coordinator = coordinator

    def resolve(self):
        return _CoordinatorView(self._coordinator)


class _CoordinatorView:
    def __init__(self, coordinator):
        self._coordinator = coordinator

    def info(self, detailed: bool, tpu: bool) -> dict:
        return (self._coordinator.detailed_info() if detailed
                else self._coordinator.info())

    def execute_query(self, query: str) -> dict:
        return self._coordinator.execute_query(query)

    @property
    def data_version(self) -> str:
        return self._coordinator.database.data_version.value


def _not_found(path: str):
    return 404, {"error": "Not found",
                 "message": f"Resource {path} does not exist"}, None


def _method_not_allowed(method: str, path: str):
    return (405,
            {"error": "Method not allowed",
             "message": f"{method} is not allowed on resource {path}"},
            None)


def route_request(backend, method: str, target: str, body: bytes):
    """(status, payload dict, data-version | None) for one HTTP request.

    `backend` is a DatabaseBackend or CoordinatorBackend; a snapshot is
    resolved per request so info/query and the data-version header always
    come from the same version (the watcher may swap mid-flight)."""
    parsed = urlparse(target)
    path = parsed.path
    if method == "GET":
        if path == "/info":
            try:
                view = backend.resolve()
                params = parse_qs(parsed.query)
                detailed = params.get("details", ["false"])[0] == "true"
                tpu = params.get("tpu", ["false"])[0] == "true"
                info = view.info(detailed=detailed, tpu=tpu)
                return 200, info, view.data_version
            except Exception as ex:  # noqa: BLE001 — parity: JSON 500
                logger.exception("info failed")
                return (500, {"error": "Internal server error",
                              "message": str(ex)}, None)
        if path == "/query":
            return _method_not_allowed(method, path)
        return _not_found(path)
    if method == "POST":
        if path == "/info":
            return _method_not_allowed(method, path)
        if path != "/query":
            return _not_found(path)
        # errors="replace": the reference's nlohmann parser consumes raw
        # bytes and fails AT the invalid byte; the replica parser renders
        # such bytes as U+FFFD (see PARITY_NOTES.md #2), so decoding must
        # not raise before it runs.
        query = body.decode("utf-8", "replace")
        try:
            view = backend.resolve()
            result = view.execute_query(query)
            return 200, result, view.data_version
        except QueryParseError as ex:
            logger.info("Query is invalid: %s", query)
            return 400, {"error": "Bad request", "message": str(ex)}, None
        except Exception as ex:  # noqa: BLE001 — parity: 500, keep serving
            logger.exception("query failed")
            # The reference's QueryHandler catches its own exceptions and
            # titles the body "Internal Server Error" (query_handler.cpp:
            # 51-70); only the outer ErrorRequestHandler — the /info path
            # above — uses lowercase (error_request_handler.cpp:28).
            return (500, {"error": "Internal Server Error",
                          "message": str(ex)}, None)
    # any other method on any path (reference rest_resource.cpp)
    return _method_not_allowed(method, path)
