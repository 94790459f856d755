"""ctypes wrapper for the native epoll HTTP server (native/silo_http.cpp).

The C++ side owns sockets, HTTP parsing, keep-alive, and response framing;
each worker thread calls back into route_request() for the actual routing.
The callback blocks on the device micro-batcher with the GIL released, so
workers pipeline under concurrent load. Interface-compatible with the
Python ThreadingHTTPServer: serve_forever(), shutdown(), server_address.
"""

from __future__ import annotations

import ctypes
import json
import logging
import os
import threading

from ..native import get_named_lib
from .router import route_request

logger = logging.getLogger(__name__)

_HANDLER_CFUNC = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_char), ctypes.c_int64,
)

_lib = None
_lib_tried = False
_lib_lock = threading.Lock()


def _get_lib():
    global _lib, _lib_tried
    with _lib_lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        lib = get_named_lib("libsilo_http.so")
        if lib is None:
            return None
        lib.silo_http_create_ex.restype = ctypes.c_int
        lib.silo_http_create_ex.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, _HANDLER_CFUNC,
            ctypes.c_int,
        ]
        lib.silo_http_port.restype = ctypes.c_int
        lib.silo_http_port.argtypes = [ctypes.c_int]
        lib.silo_http_respond.restype = None
        lib.silo_http_respond.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p,
        ]
        lib.silo_http_stop.restype = None
        lib.silo_http_stop.argtypes = [ctypes.c_int]
        _lib = lib
        return _lib


def native_http_available() -> bool:
    return _get_lib() is not None


_FALLBACK_500 = json.dumps(
    {"error": "Internal server error", "message": "unhandled error"}
).encode("utf-8")


class NativeHTTPServer:
    """Epoll HTTP server fronting a router: either a backend object
    (server/router.py DatabaseBackend | CoordinatorBackend, routed through
    route_request) or a callable `router(method, target, body) ->
    (status, payload, data_version | None)` for custom protocols (the
    multi-host worker control plane, parallel/multihost.py). A payload of
    bytes goes out as it is; any other payload as JSON."""

    def __init__(self, backend=None, port: int = 8081,
                 n_workers: int | None = None, router=None,
                 reuse_port: bool = False):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native HTTP library unavailable")
        if router is None:
            if backend is None:
                raise ValueError("need a backend or a router")

            def router(method, target, body):
                return route_request(backend, method, target, body)
        self._lib = lib
        self._stopped = threading.Event()
        if n_workers is None:
            # Workers spend their life WAITING (micro-batcher events, with
            # the GIL released) — and the device micro-batch can only be as
            # deep as the number of concurrently blocked requests, so the
            # pool must cover the target batch width, not the CPU count.
            n_workers = int(os.environ.get("SILO_HTTP_WORKERS", "128"))

        self._fastpath = None  # set after the server id exists

        def handle(req, method, target, body_ptr, body_len):
            try:
                body = (ctypes.string_at(body_ptr, body_len)
                        if body_len else b"")
                method_s = method.decode("ascii", "replace")
                target_s = target.decode("utf-8", "replace")
                status, payload, data_version = router(
                    method_s, target_s, body)
                # bytes payloads pass through untouched (binary partial
                # frames on the multi-host control plane); the rest is JSON
                if isinstance(payload, (bytes, bytearray)):
                    encoded = bytes(payload)
                else:
                    encoded = json.dumps(
                        payload, ensure_ascii=False).encode("utf-8")
                lib.silo_http_respond(
                    req, status, encoded, len(encoded),
                    data_version.encode("ascii") if data_version is not None
                    else None,
                )
                # Count fast path: teach the C++ matcher this body AFTER the
                # response went out (first hit is slow-path, repeats are
                # native). Exact-path only — the C++ matcher compares the
                # raw target, so /query?x=y stays on the slow path.
                fastpath = self._fastpath
                if (fastpath is not None and status == 200
                        and method_s == "POST" and target_s == "/query"):
                    fastpath.maybe_register(body)
            except Exception:  # noqa: BLE001 — a worker must always respond
                logger.exception("native HTTP handler failed")
                lib.silo_http_respond(
                    req, 500, _FALLBACK_500, len(_FALLBACK_500), None)

        # the CFUNCTYPE object must outlive the server: C++ workers hold
        # the raw pointer
        self._callback = _HANDLER_CFUNC(handle)
        self._id = lib.silo_http_create_ex(
            b"0.0.0.0", port, n_workers, self._callback,
            1 if reuse_port else 0)
        if self._id < 0:
            raise OSError(f"could not bind native HTTP server on port {port}")
        self.server_address = ("0.0.0.0", lib.silo_http_port(self._id))
        # the count fast path answers from a database mutex: a router, or
        # a coordinator's backend, has none
        mutex = getattr(backend, "database_mutex", None)
        if mutex is not None:
            from .fastpath import CountFastPath

            self._fastpath = CountFastPath(lib, self._id, mutex)
        # C++ workers must never call back into a finalizing interpreter:
        # stop (and join) the native threads before Python tears down.
        import atexit

        atexit.register(self.shutdown)

    def serve_forever(self):
        """Blocks until shutdown() — the native threads do all the work;
        this just matches the ThreadingHTTPServer calling convention."""
        self._stopped.wait()

    def shutdown(self):
        if not self._stopped.is_set():
            self._lib.silo_http_stop(self._id)
            self._stopped.set()
            if self._fastpath is not None:
                # silo_http_stop makes the drainer's wait return -1; join it
                # so no daemon thread sits in a ctypes call at interpreter
                # exit (pthread_exit unwinding through C++ aborts)
                self._fastpath.stop()

    # ThreadingHTTPServer interface parity (cli.py calls server_close on
    # the way out; the native server's stop covers both)
    server_close = shutdown

    def __del__(self):
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
