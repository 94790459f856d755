"""siloApi-equivalent CLI of the port: --api.

Parity with reference src/silo_api/api.cpp:99-260 (runtime config with
--dataDirectory override). The port serves snapshots; it does not ingest
yet, so --preprocessing, --worker and --coordinator are refused (exit 2).

  python -m lapis_silo_torch.cli --api --dataDirectory ./output

Snapshots are served on every visible CUDA card, or on the device that
SILO_TORCH_DEVICE names (``SILO_TORCH_DEVICE=cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def setup_logging():
    """Two-channel logging, parity with reference src/silo_api/logging.cpp:
    daily-rotated logs/silo.log + stdout for the main channel, and a
    dedicated performance logger into logs/performance.log. Level via the
    SPDLOG_LEVEL env var like the reference."""
    from logging.handlers import TimedRotatingFileHandler

    fmt = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"
    logging.basicConfig(
        level=os.environ.get("SPDLOG_LEVEL", "info").upper(), format=fmt
    )
    os.makedirs("logs", exist_ok=True)
    silo_log = TimedRotatingFileHandler("logs/silo.log", when="midnight",
                                        backupCount=14)
    silo_log.setFormatter(logging.Formatter(fmt))
    logging.getLogger().addHandler(silo_log)
    perf = logging.getLogger("lapis_silo_torch.performance")
    handler = logging.FileHandler("logs/performance.log")
    handler.setFormatter(logging.Formatter("[%(asctime)s] %(message)s"))
    perf.addHandler(handler)
    perf.propagate = False


def _graceful_sigterm():
    """SIGTERM unwinds like Ctrl-C so `finally` blocks stop the server and
    watcher (reference: Poco waitForTerminationRequest handles SIGTERM).
    One-shot: a second SIGTERM (e.g. the whole process group being
    signaled) must not re-raise inside the cleanup `finally` and abort it —
    but a THIRD falls through to SIG_DFL, so a hung cleanup can still be
    stopped by plain SIGTERM rather than requiring SIGKILL."""
    import signal

    def _ignore_once(_signum, _frame):
        signal.signal(signal.SIGTERM, signal.SIG_DFL)

    def _term(_signum, _frame):
        _TERM_OBSERVED[0] = True
        signal.signal(signal.SIGTERM, _ignore_once)
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:  # not the main thread (embedded use)
        pass


# set by the SIGTERM handler and the callers' KeyboardInterrupt catches:
# _graceful_exit only hard-exits when a termination signal was actually in
# play (the follow-up-signal-during-finalization hazard below); a clean,
# signal-free return goes back to the caller normally (atexit handlers,
# coverage, embedders all see an ordinary return).
_TERM_OBSERVED = [False]


def _graceful_exit():
    """Cleanup is DONE — exit 0 NOW, skipping interpreter finalization.

    CPython restores SIG_DFL for caught signals within ~50 ms of entering
    finalization, but module teardown (torch/numpy state) keeps the process
    alive for hundreds of ms after that; a process-group supervisor's
    follow-up SIGTERM landing in that window killed the process with
    status -15 despite a fully graceful unwind. Blocking via
    pthread_sigmask cannot close the window either: a process-directed
    SIGTERM is delivered to ANY thread with the signal unblocked (the
    server's worker threads), and only the caller's thread can be masked. The
    callers' `finally` blocks have already stopped the watcher/server and
    flushed state, so skipping finalization loses nothing. A hung cleanup
    still honors the `_graceful_sigterm` escalation chain (third SIGTERM
    -> SIG_DFL); error paths bypass this and exit nonzero as usual."""
    import logging
    import os
    import sys
    import threading

    if not _TERM_OBSERVED[0]:
        # no termination signal in play — the hazard this guards against
        # cannot occur, so return normally (atexit, coverage, embedders)
        return
    if threading.current_thread() is not threading.main_thread():
        # embedded use (the same case _graceful_sigterm tolerates): the
        # host process is not ours to kill — return 0 to the caller
        return
    logging.shutdown()
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:  # noqa: BLE001 — broken pipes must not mask exit 0
        pass
    os._exit(0)


def handle_api(args) -> int:
    import os

    n_procs = args.apiProcesses or 1
    is_child = os.environ.get("SILO_API_CHILD") == "1"
    if n_procs > 1 and not is_child:
        return _supervise_api(args, n_procs)

    from .server.http_server import DatabaseMutex, make_server
    from .server.runtime_config import RuntimeConfig
    from .server.watcher import DatabaseDirectoryWatcher

    _graceful_sigterm()

    runtime = RuntimeConfig.read(args.runtimeConfig)
    if args.dataDirectory:
        runtime.data_directory = args.dataDirectory
    if args.port:
        runtime.port = args.port

    mutex = DatabaseMutex()
    watcher = DatabaseDirectoryWatcher(runtime.data_directory, mutex)
    server = None
    # startup (snapshot load + warm-up) can run minutes — SIGTERM during
    # that window must unwind gracefully too, so it is inside the try
    try:
        watcher.start()
        server = make_server(mutex, runtime.port, reuse_port=is_child)
        logging.getLogger(__name__).info(
            "listening on :%d, watching %s", runtime.port,
            runtime.data_directory)
        server.serve_forever()
    except KeyboardInterrupt:
        _TERM_OBSERVED[0] = True  # SIGINT carries the same follow-up hazard
    finally:
        watcher.stop()
        if server is not None:
            server.server_close()
    _graceful_exit()
    return 0


def _supervise_api(args, n_procs: int) -> int:
    """Scale the API front-end past one interpreter's GIL: N identical
    server processes share the port via SO_REUSEPORT (the kernel load-
    balances connections), each with its own watcher, snapshot, and device
    engine. The supervisor restarts any child that dies (the per-process
    analog of the reference's keep-serving resilience, SURVEY §5.3)."""
    import os
    import subprocess
    import sys
    import time

    _graceful_sigterm()
    cmd = [sys.executable, "-m", "lapis_silo_torch.cli", "--api"]
    for flag in ("runtimeConfig", "dataDirectory"):
        value = getattr(args, flag)
        if value:
            cmd += [f"--{flag}", str(value)]
    if args.port:
        cmd += ["--port", str(args.port)]
    env = dict(os.environ, SILO_API_CHILD="1")
    # children must resolve the package no matter the supervisor's cwd
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    log = logging.getLogger(__name__)

    def spawn():
        return subprocess.Popen(cmd, env=env)

    children = [spawn() for _ in range(n_procs)]
    log.info("api supervisor: %d processes sharing port (SO_REUSEPORT)",
             n_procs)
    try:
        while True:
            for i, child in enumerate(children):
                code = child.poll()
                if code is not None:
                    log.warning("api process %d exited with %s; restarting",
                                child.pid, code)
                    children[i] = spawn()
            time.sleep(1.0)
    except KeyboardInterrupt:
        _TERM_OBSERVED[0] = True  # SIGINT carries the same follow-up hazard
    finally:
        for child in children:
            if child.poll() is None:
                child.terminate()
        deadline = time.time() + 10.0
        for child in children:
            try:
                child.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                child.kill()
    _graceful_exit()
    return 0


def main(argv=None) -> int:
    setup_logging()
    parser = argparse.ArgumentParser(prog="lapis-silo-torch")
    parser.add_argument("--api", action="store_true", help="run the HTTP API server")
    for mode in ("preprocessing", "worker", "coordinator"):
        parser.add_argument(f"--{mode}", action="store_true",
                            help="not available in this package yet")
    parser.add_argument("--runtimeConfig", default=None)
    parser.add_argument("--dataDirectory", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--apiProcesses", type=int, default=None,
                        help="run N API server processes sharing the port "
                             "via SO_REUSEPORT (default 1)")
    args = parser.parse_args(argv)

    for mode in ("preprocessing", "worker", "coordinator"):
        if getattr(args, mode):
            parser.error(f"--{mode} is not available in lapis_silo_torch yet; "
                         f"it serves snapshots with --api")
    if args.api:
        return handle_api(args)
    parser.error("specify --api")
    return 2


if __name__ == "__main__":
    sys.exit(main())
