"""The port's coordinator over HTTP, its coordinated version flip, and the
``--worker`` / ``--coordinator`` modes of its CLI.

The port's copies of ``tests/test_coordinator_server.py`` (the public /query
and /info of a coordinator over replicated workers, with the single-host
server's protocol details) and ``tests/test_multihost_flip.py`` (every host
stages a new snapshot version, the FlipController commits the slice only
when all hosts hold it, a restarted host re-stages and rejoins, a torn flip
is retried and healed), over snapshots the port saves itself and served on
the CPU (``SILO_TORCH_DEVICE=cpu``). Then the CLI end to end: two
``--worker`` processes and a ``--coordinator`` answer a count and a
Mutations query over HTTP as the host oracle does, and each exits 0 on
SIGTERM. The worker's native control plane (where ``libsilo_http.so``
builds) sends a Mutations partial as the binary frame it encoded."""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

import lapis_silo_torch
from lapis_silo_torch import testing
from lapis_silo_torch.parallel import multihost
from lapis_silo_torch.query.engine import QueryEngine
from lapis_silo_torch.server import http_server, native_http
from lapis_silo_torch.server.http_server import (
    DatabaseMutex,
    make_coordinator_server,
)
from lapis_silo_torch.storage.database import DataVersion
from lapis_silo_torch.storage.snapshot import save_database

from .test_torch_server import _free_port

REPO = Path(__file__).resolve().parents[1]
COUNT_QUERY = json.dumps(
    {"action": {"type": "Aggregated"}, "filterExpression": {"type": "True"}}
)


@pytest.fixture(autouse=True)
def _serve_on_the_cpu(monkeypatch):
    monkeypatch.setenv("SILO_TORCH_DEVICE", "cpu")


def _get(url):
    with urllib.request.urlopen(url) as resp:
        return json.loads(resp.read()), dict(resp.headers)


def _post(url, payload: str):
    req = urllib.request.Request(url, data=payload.encode(), method="POST")
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read()), dict(resp.headers)


# -- the coordinator's public HTTP surface (test_coordinator_server.py) ------


@pytest.fixture()
def coordinator_http(tmp_path):
    # three shard directories: coordinator-local + two workers
    dbs = [testing.synthetic_database(n_rows=32, length=64, n_partitions=1,
                                      seed=s) for s in range(3)]
    dirs = [str(tmp_path / f"host{i}") for i in range(3)]
    for db, d in zip(dbs, dirs):
        db.data_version = DataVersion("1000000001")
        save_database(db, d)

    workers = [multihost.start_replicated_worker(d, start_watcher=False)
               for d in dirs[1:]]
    urls = [f"http://127.0.0.1:{s.server_address[1]}" for s, _w, _m in workers]
    mutex = DatabaseMutex()
    local_watcher = multihost.StagedSnapshotWatcher(dirs[0], mutex)
    local_watcher.check_once()
    for _s, w, _m in workers:
        w.check_once()
    controller = multihost.FlipController(urls, local_watcher=local_watcher)
    assert controller.check_once() == "1000000001"

    coordinator = multihost.Coordinator(mutex, urls, include_local=True)
    server = make_coordinator_server(coordinator, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield base
    server.shutdown()
    for s, _w, _m in workers:
        s.shutdown()


def test_coordinator_query_and_info(coordinator_http):
    base = coordinator_http
    result, headers = _post(base + "/query", COUNT_QUERY)
    assert result == {"queryResult": [{"count": 3 * 32}]}
    assert headers["data-version"] == "1000000001"

    info, headers = _get(base + "/info")
    assert info["sequenceCount"] == 3 * 32
    assert headers["data-version"] == "1000000001"

    detailed, _ = _get(base + "/info?details=true")
    # reference detailed-info shape; numeric leaves sum across the 3 hosts
    assert set(detailed) == {"bitmapSizePerSymbol",
                             "bitmapContainerSizePerGenomeSection"}
    assert all(v > 0 for v in detailed["bitmapSizePerSymbol"].values())


def test_coordinator_protocol_errors(coordinator_http):
    base = coordinator_http
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base + "/query", "{not json")
    assert err.value.code == 400
    body = json.loads(err.value.read())
    assert body["error"] == "Bad request"

    with pytest.raises(urllib.error.HTTPError) as err:
        _get(base + "/query")
    assert err.value.code == 405

    with pytest.raises(urllib.error.HTTPError) as err:
        _get(base + "/nope")
    assert err.value.code == 404


def test_coordinator_mutations_and_groupby(coordinator_http):
    base = coordinator_http
    result, _ = _post(base + "/query", json.dumps({
        "action": {"type": "Mutations", "minProportion": 0.05,
                   "orderByFields": ["mutation"], "limit": 5},
        "filterExpression": {"type": "True"},
    }))
    assert len(result["queryResult"]) == 5
    result, _ = _post(base + "/query", json.dumps({
        "action": {"type": "Aggregated", "groupByFields": ["country"],
                   "orderByFields": ["country"]},
        "filterExpression": {"type": "True"},
    }))
    assert sum(r["count"] for r in result["queryResult"]) == 3 * 32


# -- the coordinated version flip (test_multihost_flip.py) -------------------


def _make_db(counts_tag: str):
    """A tiny single-partition database whose content differs per tag (so
    the test can tell which version answered)."""
    n_rows = {"v1": 48, "v2": 64}[counts_tag]
    return testing.synthetic_database(n_rows=n_rows, length=64,
                                      n_partitions=1)


def _save(db, directory: str, version: str) -> None:
    db.data_version = DataVersion(version)
    save_database(db, directory)


@pytest.fixture()
def two_host_slice(tmp_path):
    dirs = [str(tmp_path / "hostA"), str(tmp_path / "hostB")]
    workers = [
        multihost.start_replicated_worker(d, start_watcher=False) for d in dirs
    ]
    urls = [f"http://127.0.0.1:{s.server_address[1]}"
            for s, _w, _m in workers]
    yield dirs, workers, urls
    for server, _w, _m in workers:
        server.shutdown()


def test_coordinated_flip(two_host_slice):
    dirs, workers, urls = two_host_slice
    watchers = [w for _s, w, _m in workers]
    controller = multihost.FlipController(urls)
    # schema context for merging; no local partitions
    coordinator = multihost.Coordinator(_make_db("v1"), urls,
                                        include_local=False, flip_retries=2,
                                        flip_retry_seconds=0.05)

    # nothing staged anywhere: no flip
    assert controller.check_once() is None

    # v1 lands on both hosts -> staged, then committed together
    for d, w in zip(dirs, watchers):
        _save(_make_db("v1"), d, "1000000001")
        w.check_once()
        assert w.versions() == {"serving": "", "staged": "1000000001"}
    assert controller.check_once() == "1000000001"
    assert all(w.versions()["serving"] == "1000000001" for w in watchers)
    result = coordinator.execute_query(COUNT_QUERY)
    assert result["queryResult"] == [{"count": 2 * 48}]

    # v2 lands on host A only: staged there, but the slice must NOT flip
    _save(_make_db("v2"), dirs[0], "1000000002")
    watchers[0].check_once()
    assert controller.check_once() is None
    assert watchers[0].versions() == {"serving": "1000000001",
                                      "staged": "1000000002"}
    # queries still answer consistently from v1
    result = coordinator.execute_query(COUNT_QUERY)
    assert result["queryResult"] == [{"count": 2 * 48}]

    # v2 lands on host B too -> the slice flips together
    _save(_make_db("v2"), dirs[1], "1000000002")
    watchers[1].check_once()
    assert controller.check_once() == "1000000002"
    assert all(w.versions()["serving"] == "1000000002" for w in watchers)
    result = coordinator.execute_query(COUNT_QUERY)
    assert result["queryResult"] == [{"count": 2 * 64}]

    # idempotent: nothing new -> no further flips
    assert controller.check_once() is None


def test_failed_host_reload(two_host_slice):
    """A worker that lost its in-memory state (restart) re-stages the newest
    snapshot and rejoins the serving version on the next controller poll."""
    dirs, workers, urls = two_host_slice
    watchers = [w for _s, w, _m in workers]
    controller = multihost.FlipController(urls)
    for d, w in zip(dirs, watchers):
        _save(_make_db("v1"), d, "1000000001")
        w.check_once()
    assert controller.check_once() == "1000000001"

    # "restart" host B: fresh worker process over the same shard directory
    workers[1][0].shutdown()
    server, watcher, mutex = multihost.start_replicated_worker(
        dirs[1], start_watcher=False)
    try:
        urls[1] = f"http://127.0.0.1:{server.server_address[1]}"
        controller = multihost.FlipController(urls)
        watcher.check_once()  # re-stages 1000000001
        assert watcher.versions() == {"serving": "", "staged": "1000000001"}
        assert controller.check_once() == "1000000001"
        assert watcher.versions()["serving"] == "1000000001"
        assert mutex.get_database().partitions  # actually serving data
    finally:
        server.shutdown()


def test_mid_flip_version_mismatch_retries(two_host_slice):
    """If a query lands in the inconsistency window (one host flipped, the
    other not yet), the coordinator retries and then surfaces a clear
    error rather than merging mixed-version partials."""
    dirs, workers, urls = two_host_slice
    watchers = [w for _s, w, _m in workers]
    controller = multihost.FlipController(urls)
    for d, w in zip(dirs, watchers):
        _save(_make_db("v1"), d, "1000000001")
        w.check_once()
    assert controller.check_once() == "1000000001"
    for d, w in zip(dirs, watchers):
        _save(_make_db("v2"), d, "1000000002")
        w.check_once()
    # simulate a torn flip: commit only host A
    assert watchers[0].commit("1000000002")
    coordinator = multihost.Coordinator(_make_db("v1"), urls,
                                        include_local=False, flip_retries=2,
                                        flip_retry_seconds=0.01)
    with pytest.raises(RuntimeError, match="disagree on data version"):
        coordinator.execute_query(COUNT_QUERY)
    # the controller heals the tear (re-commit is idempotent) ...
    assert controller.check_once() == "1000000002"
    # ... and queries work again
    result = coordinator.execute_query(COUNT_QUERY)
    assert result["queryResult"] == [{"count": 2 * 64}]


# -- the CLI's --worker and --coordinator -----------------------------------


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.getheader("data-version"), resp.read()
    finally:
        conn.close()


def test_cli_worker_and_coordinator_serve_a_slice(tmp_path):
    """python -m lapis_silo_torch.cli --worker twice and --coordinator
    --workerUrls over them, on the CPU: once the slice has flipped to its
    version, /info counts the whole corpus, a count and a Mutations query
    answer as the host oracle over the whole corpus, and SIGTERM ends each
    process with exit code 0. --coordinator without --workerUrls refuses."""
    db = testing.synthetic_database(n_rows=96, length=64, n_partitions=3,
                                    seed=5)
    version = "1000000007"
    dirs = [tmp_path / f"host{i}" for i in range(3)]
    testing.save_shards(db, [[0], [1], [2]], dirs, version)
    queries = [COUNT_QUERY, testing.sample_count_queries(db, 3, seed=2)[2],
               json.dumps({"action": {"type": "Mutations",
                                      "minProportion": 0.05},
                           "filterExpression": {
                               "type": "HasNucleotideMutation",
                               "position": 9}})]
    oracle = QueryEngine(db, use_device=False)
    want = [oracle.execute(q) for q in queries]

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), SILO_TORCH_DEVICE="cpu")
    cli = [sys.executable, "-m", "lapis_silo_torch.cli"]
    refused = subprocess.run(cli + ["--coordinator"], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=120)
    assert refused.returncode == 1
    assert "--coordinator requires --workerUrls" in refused.stderr
    worker_ports = [_free_port(), _free_port()]
    procs = [subprocess.Popen(cli + ["--worker", "--dataDirectory",
                                     str(d), "--port", str(p)],
                              cwd=tmp_path, env=env)
             for d, p in zip(dirs[1:], worker_ports)]
    port = _free_port()
    procs.append(subprocess.Popen(
        cli + ["--coordinator", "--dataDirectory", str(dirs[0]),
               "--workerUrls", ",".join(f"http://127.0.0.1:{p}"
                                        for p in worker_ports),
               "--port", str(port)], cwd=tmp_path, env=env))
    try:
        info = None
        deadline = time.time() + 120
        while time.time() < deadline:
            time.sleep(1)
            try:
                status, _version, body = _request(port, "GET", "/info")
            except OSError:  # still starting
                continue
            info = json.loads(body)
            if status == 200 and info["sequenceCount"] == 96:
                break
        assert info == db.info()
        for query, expected in zip(queries, want):
            status, got_version, body = _request(port, "POST", "/query",
                                                 query)
            assert (status, got_version) == (200, version), query
            assert json.loads(body) == expected, query
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        assert [proc.wait(timeout=60) for proc in procs] == [0, 0, 0]
        procs = []
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()


def _control_plane_db():
    db = testing.synthetic_database(n_rows=64, length=64, n_partitions=1,
                                    seed=2)
    lapis_silo_torch.install(db, torch.device("cpu"))
    return db


def _check_control_plane(server, db):
    mutations = json.dumps({"action": {"type": "Mutations",
                                       "minProportion": 0.1},
                            "filterExpression": {"type": "True"}})
    try:
        port = server.server_address[1]
        status, _version, body = _request(port, "POST", "/internal/partial",
                                          mutations)
        assert status == 200 and body.startswith(b"SILOPART1\n")
        assert body == multihost.encode_partial(
            multihost.execute_partial(db, mutations))
        status, _version, body = _request(port, "POST", "/internal/partial",
                                          COUNT_QUERY)
        assert (status, json.loads(body)) == (200, {
            "kind": "count", "count": 64,
            "dataVersion": db.data_version.value})
        status, _version, body = _request(
            port, "POST", "/internal/partial_batch",
            json.dumps([mutations, "{ not json"]))
        assert status == 200
        assert body == multihost.execute_partial_batch(
            db, [mutations, "{ not json"])
        assert [s for s, _ in multihost.decode_partial_batch(body)] == [
            200, 400]
        status, _version, body = _request(port, "GET", "/internal/version")
        assert json.loads(body) == {"serving": db.data_version.value,
                                    "staged": ""}
        status, _version, body = _request(port, "GET", "/internal/nowhere")
        assert status == 404
    finally:
        server.shutdown()
        server.server_close()


def test_worker_native_control_plane_sends_binary_partials(monkeypatch):
    """The worker's native server (the router callable of the native HTTP
    server): /internal/partial answers a Mutations query with the SILOPART1
    frame encoded on the worker, byte for byte, and a count as JSON;
    /internal/partial_batch with a SILOBATCH1 frame."""
    if not native_http.native_http_available():
        pytest.skip("native HTTP library unavailable")
    monkeypatch.delenv("SILO_HTTP_IMPL", raising=False)
    db = _control_plane_db()
    server = multihost.start_worker(db)
    assert isinstance(server, native_http.NativeHTTPServer)
    _check_control_plane(server, db)


def test_worker_python_control_plane_sends_binary_partials(monkeypatch):
    """The same control plane on the Python server (SILO_HTTP_IMPL=python,
    or no native library): the same router, the same bytes on the wire."""
    monkeypatch.setenv("SILO_HTTP_IMPL", "python")
    db = _control_plane_db()
    server = multihost.start_worker(db)
    assert isinstance(server, http_server.SiloHTTPServer)
    _check_control_plane(server, db)
