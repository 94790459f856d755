"""siloApi-equivalent CLI of the port: --preprocessing | --api | --worker |
--coordinator.

Parity with reference src/silo_api/api.cpp:99-260 (two execution modes,
layered preprocessing config, runtime config with --dataDirectory
override), plus the JAX package's multi-host modes: a --worker serves its
shard's snapshots on /internal/* (port 8082 by default), and the
--coordinator answers the public /query and /info over its --workerUrls and
its own shard, flipping all hosts to a new snapshot version together
(parallel/multihost.py).

  python -m lapis_silo_torch.cli --preprocessing \
      --preprocessingConfig cfg.yaml --databaseConfig db.yaml
  python -m lapis_silo_torch.cli --api --dataDirectory ./output
  python -m lapis_silo_torch.cli --worker --dataDirectory ./shard1 --port 8082
  python -m lapis_silo_torch.cli --coordinator --dataDirectory ./shard0 \
      --workerUrls http://host1:8082,http://host2:8082

Ingest is host work and needs no card. Snapshots are served on every
visible CUDA card, or on the device that SILO_TORCH_DEVICE names
(``SILO_TORCH_DEVICE=cpu`` for the CPU).
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


def handle_preprocessing(args) -> int:
    from .config.database_config import get_validated_config
    from .preprocessing.preprocessing_config import read_layered
    from .preprocessing.preprocessor import Preprocessor
    from .storage.snapshot import save_database

    pcfg = read_layered(args.preprocessingConfig)
    database_config_path = args.databaseConfig or os.path.join(
        pcfg.input_directory, "database_config.yaml"
    )
    dbconf = get_validated_config(database_config_path)
    n_shards = args.ingestShards or 1
    if n_shards > 1:
        # multi-process sharded ingest: the metadata pass runs once here,
        # N worker processes split the sequence compression + index build
        # by partition (preprocessing/sharded.py)
        from .preprocessing.sharded import sharded_preprocess

        database = sharded_preprocess(pcfg, dbconf, n_shards)
    else:
        database = Preprocessor(pcfg, dbconf).preprocess()
    path = save_database(database, pcfg.output_directory)
    logging.getLogger(__name__).info("snapshot written to %s", path)
    return 0


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


def handle_worker(args) -> int:
    """One host of a slice: serves /internal/* (partials, version, commit)
    over its shard's data directory; snapshot versions go live only when
    the coordinator's FlipController commits them."""
    import time

    from .parallel.multihost import start_replicated_worker
    from .server.runtime_config import RuntimeConfig

    _graceful_sigterm()

    runtime = RuntimeConfig.read(args.runtimeConfig)
    if args.dataDirectory:
        runtime.data_directory = args.dataDirectory
    port = args.port or 8082
    server = watcher = None
    try:
        server, watcher, _mutex = start_replicated_worker(
            runtime.data_directory, port)
        logging.getLogger(__name__).info(
            "worker on :%d, staging snapshots from %s", port,
            runtime.data_directory)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        _TERM_OBSERVED[0] = True  # SIGINT carries the same follow-up hazard
    finally:
        if watcher is not None:
            watcher.stop()
        if server is not None:
            server.shutdown()
    _graceful_exit()
    return 0


def handle_coordinator(args) -> int:
    """The slice's front end: public /query + /info fan out to the workers
    (plus this host's own shard from its data directory); the embedded
    FlipController keeps all hosts on one snapshot version."""
    from .parallel.multihost import (
        Coordinator,
        FlipController,
        StagedSnapshotWatcher,
    )
    from .server.http_server import DatabaseMutex, make_coordinator_server
    from .server.runtime_config import RuntimeConfig

    _graceful_sigterm()

    worker_urls = [u.strip() for u in (args.workerUrls or "").split(",")
                   if u.strip()]
    if not worker_urls:
        raise SystemExit("--coordinator requires --workerUrls url1,url2,...")
    runtime = RuntimeConfig.read(args.runtimeConfig)
    if args.dataDirectory:
        runtime.data_directory = args.dataDirectory
    if args.port:
        runtime.port = args.port

    mutex = DatabaseMutex()
    local_watcher = controller = server = None
    try:
        if runtime.data_directory:
            local_watcher = StagedSnapshotWatcher(runtime.data_directory, mutex)
            local_watcher.start()
        controller = FlipController(worker_urls, local_watcher=local_watcher)
        controller.start()
        coordinator = Coordinator(mutex, worker_urls,
                                  include_local=local_watcher is not None)
        server = make_coordinator_server(coordinator, runtime.port)
        logging.getLogger(__name__).info(
            "coordinator on :%d over %d workers%s", runtime.port,
            len(worker_urls),
            f" + local shard {runtime.data_directory}" if local_watcher else "")
        server.serve_forever()
    except KeyboardInterrupt:
        _TERM_OBSERVED[0] = True  # SIGINT carries the same follow-up hazard
    finally:
        if controller is not None:
            controller.stop()
        if local_watcher is not None:
            local_watcher.stop()
        if server is not None:
            server.server_close()
    _graceful_exit()
    return 0


def main(argv=None) -> int:
    setup_logging()
    parser = argparse.ArgumentParser(prog="lapis-silo-torch")
    parser.add_argument("--api", action="store_true", help="run the HTTP API server")
    parser.add_argument("--preprocessing", action="store_true",
                        help="ingest input data and write a snapshot")
    parser.add_argument("--worker", action="store_true",
                        help="run a multi-host shard worker (staged hot reload, "
                             "flips committed by the coordinator)")
    parser.add_argument("--coordinator", action="store_true",
                        help="run the multi-host coordinator: public /query + "
                             "/info over all workers (and this host's own shard)")
    parser.add_argument("--workerUrls", default=None,
                        help="comma-separated worker base URLs (coordinator mode)")
    parser.add_argument("--preprocessingConfig", default=None)
    parser.add_argument("--ingestShards", type=int, default=None,
                        help="split --preprocessing sequence work over N "
                             "worker processes (NDJSON input only)")
    parser.add_argument("--databaseConfig", default=None)
    parser.add_argument("--runtimeConfig", default=None)
    parser.add_argument("--dataDirectory", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--apiProcesses", type=int, default=None,
                        help="run N API server processes sharing the port "
                             "via SO_REUSEPORT (default 1)")
    args = parser.parse_args(argv)

    if args.preprocessing:
        return handle_preprocessing(args)
    if args.api:
        return handle_api(args)
    if args.worker:
        return handle_worker(args)
    if args.coordinator:
        return handle_coordinator(args)
    parser.error("specify --api, --preprocessing, --worker or --coordinator")
    return 2


if __name__ == "__main__":
    sys.exit(main())
