"""The port's persistence and its `--api` mode against the JAX package's.

A snapshot saved by either package (``storage/snapshot.py``, one format)
loads in the other, and both answer a seeded query set equally, Fasta over
the unaligned stores included. The port's Python server and, where
``libsilo_http.so`` builds (from ``native/`` into ``build/native/``), its
native server with the count fast path answer the same status, JSON bodies
and data-version as the JAX package's server over the same snapshot, for
counts, group-by, Details, Mutations, Fasta, /info and the protocol errors.
The port's watcher installs the port's device engine before a snapshot goes
live (on the CPU through ``SILO_TORCH_DEVICE=cpu``; with no card and no such
variable the load fails and the empty database stays), keeps the old
snapshot on a bad one, and the CLI (``python -m lapis_silo_torch.cli
--api``) starts, answers and exits 0 on SIGTERM. ``--preprocessing`` of the
CLI ingests generated files into a snapshot that the JAX package reads and
``--api`` serves with the JAX package's answers. The completion pump answers a batch submitted after it
stopped, and a snapshot swap answers the old generation's queued tasks with
the old snapshot before its table retires. The same server on the card is
marked `cuda`."""

import http.client
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import lapis_silo_torch
from lapis_silo_tpu import testing as ref_testing
from lapis_silo_tpu.query.engine import QueryEngine as RefQueryEngine
from lapis_silo_tpu.server import http_server as ref_http
from lapis_silo_tpu.server.router import DatabaseBackend as RefBackend
from lapis_silo_tpu.server.watcher import (
    DatabaseDirectoryWatcher as RefWatcher,
)
from lapis_silo_tpu.storage import snapshot as ref_snapshot
from lapis_silo_tpu.storage.unaligned import (
    UnalignedPartitionStore as RefUnalignedStore,
)
from lapis_silo_torch import testing
from lapis_silo_torch.ops import kernels
from lapis_silo_torch.query.engine import QueryEngine
from lapis_silo_torch.server import fastpath, http_server, native_http
from lapis_silo_torch.server.router import DatabaseBackend
from lapis_silo_torch.server.watcher import DatabaseDirectoryWatcher
from lapis_silo_torch.storage import snapshot
from lapis_silo_torch.storage.unaligned import UnalignedPartitionStore

REPO = Path(__file__).resolve().parents[1]
CORPUS = dict(n_rows=1500, length=160, n_partitions=3, seed=13, rich=True)
VERSION = "1700000000"


def _with_unaligned(db, store_cls):
    """Seeded unaligned sequences (a tenth missing) for segment "main"."""
    rng = np.random.default_rng(3)
    reference = db.reference_genomes.raw_nucleotide_sequences["main"]
    stores = []
    for partition in db.partitions:
        store = store_cls(reference)
        for _ in range(partition.sequence_count):
            if rng.random() < 0.1:
                store.add(None)
                continue
            seq = np.frombuffer(reference.encode(), dtype=np.uint8).copy()
            seq[rng.integers(0, len(seq), size=3)] = ord("N")
            store.add(seq.tobytes().decode()[: len(seq) - int(rng.integers(0, 5))])
        stores.append(store)
    db.unaligned_nuc_sequences["main"] = stores
    db.data_version.value = VERSION
    return db


def _queries(db) -> list[str]:
    """Counts, group-by, Details, Mutations, Fasta and Insertions."""
    counts = testing.sample_count_queries(db, 12, seed=4)
    few = {"type": "And", "children": [
        {"type": "HasNucleotideMutation", "position": 40},
        {"type": "IntBetween", "column": "age", "from": 20, "to": 60}]}
    actions = [
        {"type": "Aggregated", "groupByFields": ["date"]},
        {"type": "Aggregated", "groupByFields": ["country"]},
        {"type": "Aggregated", "groupByFields": ["date", "country"],
         "orderByFields": ["count"], "limit": 7},
        {"type": "Aggregated", "groupByFields": ["age"]},
        {"type": "Details", "fields": ["key", "age", "qc_value"],
         "orderByFields": ["key"], "limit": 40},
        {"type": "Mutations", "minProportion": 0.02},
        {"type": "AminoAcidMutations", "minProportion": 0.005},
        {"type": "Fasta", "sequenceName": "main", "orderByFields": ["key"]},
        {"type": "Insertions"},
    ]
    return counts + [json.dumps({"action": a, "filterExpression": f})
                     for a in actions for f in (few, {"type": "True"})
                     if not (a["type"] == "Fasta" and f["type"] == "True")]


@pytest.fixture(scope="module")
def dbs():
    return (_with_unaligned(testing.synthetic_database(**CORPUS),
                            UnalignedPartitionStore),
            _with_unaligned(ref_testing.synthetic_database(**CORPUS),
                            RefUnalignedStore))


@pytest.fixture(scope="module")
def snapshots(dbs, tmp_path_factory):
    """{"port": dir, "ref": dir}: each package's corpus saved by itself."""
    port_db, ref_db = dbs
    out = tmp_path_factory.mktemp("snapshots")
    return {"port": snapshot.save_database(port_db, str(out / "port")),
            "ref": ref_snapshot.save_database(ref_db, str(out / "ref"))}


@pytest.fixture(scope="module")
def answers(dbs):
    """The port's host oracle over its own corpus."""
    port_db, _ref_db = dbs
    queries = _queries(port_db)
    host = QueryEngine(port_db, use_device=False)
    return queries, [host.execute(q) for q in queries]


def test_snapshots_load_across_packages(dbs, snapshots, answers):
    """The port loads the JAX package's snapshot and the JAX package the
    port's; every loaded database answers as the port's corpus does, and the
    JAX package's own answers agree."""
    queries, want = answers
    _port_db, ref_db = dbs
    ref_host = RefQueryEngine(ref_db, use_device=False)
    assert [ref_host.execute(q) for q in queries] == want
    for label, path in snapshots.items():
        port_loaded = snapshot.load_database(path)
        ref_loaded = ref_snapshot.load_database(path)
        assert port_loaded.data_version.value == VERSION, label
        assert type(port_loaded).__module__.startswith("lapis_silo_torch.")
        assert len(port_loaded.unaligned_nuc_sequences["main"]) == 3
        port_host = QueryEngine(port_loaded, use_device=False)
        ref_loaded_host = RefQueryEngine(ref_loaded, use_device=False)
        for query, expected in zip(queries, want):
            assert port_host.execute(query) == expected, (label, query)
            assert ref_loaded_host.execute(query) == expected, (label, query)
        assert port_loaded.info() == ref_loaded.info()
        assert port_loaded.detailed_info() == ref_loaded.detailed_info()


def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"} if body
                     else {})
        resp = conn.getresponse()
        return (resp.status, resp.getheader("data-version"), resp.read())
    finally:
        conn.close()


def _requests(queries) -> list[tuple]:
    return ([("POST", "/query", q) for q in queries]
            + [("GET", "/info", None), ("GET", "/info?details=true", None),
               ("POST", "/query", "{ not json"),
               ("POST", "/query", json.dumps({"action": {"type": "Nope"},
                                              "filterExpression": {
                                                  "type": "True"}})),
               ("GET", "/query", None), ("GET", "/nope", None),
               ("POST", "/info", None)])


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


@pytest.fixture(scope="module")
def ref_server(snapshots):
    """The JAX package's Python server over the JAX package's snapshot."""
    mutex = ref_http.DatabaseMutex()
    RefWatcher(os.path.dirname(snapshots["ref"]), mutex,
               poll_seconds=3600).check_once()
    assert mutex.get_database().data_version.value == VERSION
    server = _serve(ref_http._python_server(RefBackend(mutex), 0))
    yield server
    server.shutdown()


def _port_mutex(data_dir, monkeypatch) -> http_server.DatabaseMutex:
    monkeypatch.setenv("SILO_TORCH_DEVICE", "cpu")
    mutex = http_server.DatabaseMutex()
    DatabaseDirectoryWatcher(data_dir, mutex, poll_seconds=3600).check_once()
    assert mutex.get_database().data_version.value == VERSION
    return mutex


def test_python_server_answers_as_the_jax_server(snapshots, ref_server,
                                                 answers, monkeypatch):
    """The port's Python server over the port's snapshot answers byte-equal
    bodies, statuses and data-versions, through the port's device engine."""
    queries, _want = answers
    mutex = _port_mutex(os.path.dirname(snapshots["port"]), monkeypatch)
    server = _serve(http_server._python_server(DatabaseBackend(mutex), 0))
    before = kernels.GROUP_COUNTS.plain_launches
    try:
        for method, path, body in _requests(queries):
            got = _request(server.server_address[1], method, path, body)
            want = _request(ref_server.server_address[1], method, path, body)
            assert got == want, (method, path, body)
    finally:
        server.shutdown()
    assert kernels.GROUP_COUNTS.plain_launches > before


def test_native_server_and_fast_path_answer_as_the_jax_server(
        snapshots, ref_server, answers, monkeypatch):
    """The port's native server (where it builds) answers as the JAX
    package's Python server, and repeated counts go through the fast path:
    no slow-path resolve, the same bytes."""
    if not native_http.native_http_available():
        pytest.skip("native HTTP library unavailable")
    queries, _want = answers

    class CountingBackend(DatabaseBackend):
        resolves = 0

        def resolve(self):
            type(self).resolves += 1
            return super().resolve()

    mutex = _port_mutex(os.path.dirname(snapshots["port"]), monkeypatch)
    server = native_http.NativeHTTPServer(CountingBackend(mutex), port=0)
    assert server._fastpath is not None
    port, ref_port = server.server_address[1], ref_server.server_address[1]
    try:
        for method, path, body in _requests(queries):
            assert _request(port, method, path, body) == _request(
                ref_port, method, path, body), (method, path, body)
        deadline = time.time() + 30
        fast = 0
        while time.time() < deadline and fast < len(queries[:12]):
            fast = 0
            for body in queries[:12]:  # the counts
                before = CountingBackend.resolves
                got = _request(port, "POST", "/query", body)
                assert got == _request(ref_port, "POST", "/query", body)
                fast += CountingBackend.resolves == before
        assert fast == 12, "the fast path never answered every count"
    finally:
        server.shutdown()


def test_native_libraries_build_into_their_own_directory():
    """The port builds native/'s libraries into build/native/ (its own
    copies: no build of the port writes where the JAX package loads from);
    an unknown library is None."""
    from lapis_silo_torch import native

    lib = native.get_named_lib("libsilo_http.so")
    if lib is None:
        pytest.skip("no C++ toolchain")
    assert Path(lib._name).parent == REPO / "build" / "native"
    assert native.get_named_lib("libsilo_nothing.so") is None


def test_watcher_installs_the_port_engine(snapshots, monkeypatch):
    mutex = _port_mutex(os.path.dirname(snapshots["ref"]), monkeypatch)
    database = mutex.get_database()
    engine = database.device_engine
    assert isinstance(engine, lapis_silo_torch.DeviceEngine)
    assert engine.device == torch.device("cpu")
    assert database._engine._use_device
    before = kernels.GROUP_COUNTS.plain_launches
    database.execute_query(json.dumps({
        "action": {"type": "Aggregated", "groupByFields": ["country"]},
        "filterExpression": {"type": "True"}}))
    assert kernels.GROUP_COUNTS.plain_launches == before + 1


def test_watcher_without_a_device_fails_the_load(snapshots, monkeypatch,
                                                 caplog):
    """No CUDA and no SILO_TORCH_DEVICE: the load fails loudly (logged) and
    the empty database stays; /info answers from it."""
    monkeypatch.delenv("SILO_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mutex = http_server.DatabaseMutex()
    with caplog.at_level(logging.ERROR):
        DatabaseDirectoryWatcher(os.path.dirname(snapshots["port"]), mutex,
                                 poll_seconds=3600).check_once()
    assert "snapshot load failed" in caplog.text
    assert "SILO_TORCH_DEVICE" in caplog.text
    database = mutex.get_database()
    assert database.info()["sequenceCount"] == 0
    assert getattr(database, "device_engine", None) is None


def test_watcher_keeps_the_old_snapshot_on_a_bad_one(dbs, tmp_path,
                                                     monkeypatch):
    """Invalid snapshot directories are skipped, a corrupt newer one keeps
    the old snapshot live, and a newer valid one swaps in with an engine of
    its own."""
    monkeypatch.setenv("SILO_TORCH_DEVICE", "cpu")
    port_db, _ref_db = dbs
    data = tmp_path / "data"
    data.mkdir()
    mutex = http_server.DatabaseMutex()
    watcher = DatabaseDirectoryWatcher(str(data), mutex, poll_seconds=3600)
    watcher.check_once()
    assert mutex.get_database().info()["sequenceCount"] == 0
    (data / "not_a_version").mkdir()
    (data / "1111111111").mkdir()
    (data / "1111111111" / snapshot.DATA_VERSION_FILE).write_text("2")
    watcher.check_once()
    assert mutex.get_database().info()["sequenceCount"] == 0
    snapshot.save_database(port_db, str(data))
    watcher.check_once()
    first = mutex.get_database()
    assert first.info()["sequenceCount"] == 1500
    newer = data / "1800000000"
    newer.mkdir()
    (newer / snapshot.DATA_VERSION_FILE).write_text("1800000000")
    (newer / "manifest.json").write_text("{ corrupt")
    watcher.check_once()
    assert mutex.get_database() is first
    port_db.data_version.value = "1900000000"
    try:
        snapshot.save_database(port_db, str(data))
    finally:
        port_db.data_version.value = VERSION
    watcher.check_once()
    second = mutex.get_database()
    assert second.data_version.value == "1900000000"
    assert second.device_engine is not first.device_engine
    assert second.execute_query(json.dumps({
        "action": {"type": "Aggregated"},
        "filterExpression": {"type": "True"}})) == {
            "queryResult": [{"count": 1500}]}


class _Answers:
    """A stand-in for CountFastPath on the pump's side: records answers."""

    def __init__(self):
        self.completed = []

    def _complete(self, batch):
        self.completed.append(list(batch))
        del batch[:]

    def _respond_error(self, keys, status, payload):
        raise AssertionError("no error expected")


def test_pump_answers_a_batch_submitted_after_stop():
    answers = _Answers()
    pump = fastpath._CompletionPump(answers, capacity=2)
    pump.submit([("table", [1], [0], None)])
    pump.drain()
    assert answers.completed == [[("table", [1], [0], None)]]
    pump.stop(timeout=5)
    assert not pump._thread.is_alive()
    done = threading.Event()

    def late():
        pump.submit([("table", [2], [0], None)])
        done.set()

    threading.Thread(target=late, daemon=True).start()
    assert done.wait(5), "submit after stop hung"
    assert answers.completed[-1] == [("table", [2], [0], None)]
    assert pump.idle()


def _fake_lib(queue: list, log: list):
    """The C functions the fast path calls, in Python: the first wait stops
    the drainer thread (the test drives the fast path itself); later waits
    pop `queue`."""
    state = {"started": False}

    def wait(sid, keys, handles, cap, timeout_ms):
        if not state["started"]:
            state["started"] = True
            return -1
        n = min(len(queue), cap)
        for i in range(n):
            keys[i], handles[i] = queue.pop(0)
        return n

    def respond_counts(sid, keys, vals, n, version):
        log.append(("counts", [keys[i] for i in range(n)],
                    [vals[i] for i in range(n)], version))

    def respond_error(sid, keys, n, status, body, size):
        log.append(("error", [keys[i] for i in range(n)], status))

    return types.SimpleNamespace(
        silo_fastpath_wait=wait,
        silo_fastpath_register=lambda sid, body, size, handle: log.append(
            ("register", bytes(body), handle)),
        silo_fastpath_clear=lambda sid: log.append(("clear",)),
        silo_fastpath_respond_counts=respond_counts,
        silo_fastpath_respond_error=respond_error)


def test_swap_answers_queued_tasks_from_the_old_snapshot():
    """A snapshot swap retires the old generation: the C++ map is cleared,
    every task still queued for the old generation is answered with the old
    snapshot's count and data-version, and only then is its table dropped;
    the new snapshot gets a generation of its own."""
    old = testing.synthetic_database(600, 100, n_partitions=2, seed=1)
    new = testing.synthetic_database(700, 100, n_partitions=2, seed=2)
    old.data_version.value, new.data_version.value = "100", "200"
    for db in (old, new):
        lapis_silo_torch.install(db, torch.device("cpu"))
    queue, log = [], []
    mutex = http_server.DatabaseMutex(old)
    fp = fastpath.CountFastPath(_fake_lib(queue, log), 0, mutex)
    fp._thread.join(5)
    state = fp._ensure_state()
    body = json.dumps({"action": {"type": "Aggregated"},
                       "filterExpression": {"type": "True"}}).encode()
    fp.maybe_register(body)
    handle = log[-1][2]
    assert log[-1][0] == "register" and handle >> 20 == state.gen
    queue.extend([(11, handle), (12, handle)])
    mutex.set_database(new)  # the swap listener clears the map at once
    assert log[-1] == ("clear",)
    fp._retire(state)
    answered = [entry for entry in log if entry[0] == "counts"]
    assert answered == [("counts", [11, 12], [600, 600], b"100")]
    assert log.index(answered[0]) > log.index(("clear",))
    assert fp._tables == {} and fp._state is None
    assert fp._ensure_state().database is new
    assert set(fp._tables) == {state.gen + 1}


def test_cli_api_serves_and_exits_on_sigterm(snapshots, tmp_path):
    """python -m lapis_silo_torch.cli --api: the watcher loads the snapshot
    on the device SILO_TORCH_DEVICE names, the server answers, SIGTERM
    unwinds with exit code 0; with no mode the CLI refuses with exit code 2
    and names the four (tests/test_torch_coordinator.py runs --worker and
    --coordinator)."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), SILO_TORCH_DEVICE="cpu")
    refused = subprocess.run(
        [sys.executable, "-m", "lapis_silo_torch.cli"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert refused.returncode == 2
    assert ("specify --api, --preprocessing, --worker or --coordinator"
            in refused.stderr)
    proc = subprocess.Popen(
        [sys.executable, "-m", "lapis_silo_torch.cli", "--api",
         "--dataDirectory", os.path.dirname(snapshots["port"]),
         "--port", str(port)], cwd=tmp_path, env=env)
    try:
        body = json.dumps({"action": {"type": "Aggregated"},
                           "filterExpression": {"type": "True"}})
        got = None
        for _ in range(90):
            time.sleep(1)
            try:
                got = _request(port, "POST", "/query", body)
                break
            except OSError:  # still starting
                pass
        assert got is not None, "server never came up"
        assert got[:2] == (200, VERSION)
        assert json.loads(got[2]) == {"queryResult": [{"count": 1500}]}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        proc = None
    finally:
        if proc is not None:
            proc.kill()
            proc.wait()


def test_cli_preprocessing_writes_a_snapshot_the_api_serves(tmp_path):
    """python -m lapis_silo_torch.cli --preprocessing, run in the input
    directory (./preprocessing_config.yaml, and database_config.yaml of the
    input directory), writes a snapshot; the JAX package's load_database
    reads it and ``--api`` on the CPU serves it, both with the answers of
    the JAX package's ingest of the same files."""
    from lapis_silo_tpu.config.database_config import get_validated_config
    from lapis_silo_tpu.preprocessing.preprocessing_config import (
        read_preprocessing_config,
    )
    from lapis_silo_tpu.preprocessing.preprocessor import Preprocessor

    from .test_torch_ingest import queries

    inputs = testing.write_ingest_inputs(
        tmp_path / "in", 240, 300, gene_length=40, p_unaligned=0.5, seed=4,
        intermediate_directory=tmp_path / "inter",
        output_directory=tmp_path / "out")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), SILO_TORCH_DEVICE="cpu")
    done = subprocess.run(
        [sys.executable, "-m", "lapis_silo_torch.cli", "--preprocessing"],
        cwd=inputs.directory, env=env, capture_output=True, text=True,
        timeout=300)
    assert done.returncode == 0, done.stderr
    assert "with the native scanner" in done.stderr or (
        "with the Python loop" in done.stderr)
    (version,) = os.listdir(tmp_path / "out")
    pcfg = read_preprocessing_config(inputs.preprocessing_config)
    pcfg.intermediate_results_directory = str(tmp_path / "ref_inter")
    ref = Preprocessor(pcfg, get_validated_config(
        inputs.database_config)).preprocess()
    battery = queries(inputs)
    want = [RefQueryEngine(ref, use_device=False).execute(q) for q in battery]
    loaded = ref_snapshot.load_database(str(tmp_path / "out" / version))
    assert loaded.data_version.value == version
    assert loaded.info() == ref.info()
    host = RefQueryEngine(loaded, use_device=False)
    assert [host.execute(q) for q in battery] == want

    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "lapis_silo_torch.cli", "--api",
         "--dataDirectory", str(tmp_path / "out"), "--port", str(port)],
        cwd=tmp_path, env=env)
    try:
        info = None
        for _ in range(90):
            time.sleep(1)
            try:
                info = json.loads(_request(port, "GET", "/info")[2])
            except OSError:  # still starting
                continue
            if info["sequenceCount"]:
                break
        assert info == ref.info()
        for query, expected in zip(battery, want):
            status, got_version, body = _request(port, "POST", "/query",
                                                 query)
            assert (status, got_version) == (200, version), query
            assert json.loads(body) == expected, query
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        proc = None
    finally:
        if proc is not None:
            proc.kill()
            proc.wait()


@pytest.mark.cuda
def test_server_on_card_answers_as_the_host(snapshots, answers, monkeypatch):
    """The watcher's default devices are the visible cards: the snapshot is
    served on `cuda`, every answer equal to the host oracle, the VM (K1,
    or K6 where there are several cards) and K9 launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.delenv("SILO_TORCH_DEVICE", raising=False)
    queries, want = answers
    mutex = http_server.DatabaseMutex()
    DatabaseDirectoryWatcher(os.path.dirname(snapshots["ref"]), mutex,
                             poll_seconds=3600).check_once()
    database = mutex.get_database()
    assert database.device_engine.device.type == "cuda"
    server = _serve(http_server._python_server(DatabaseBackend(mutex), 0))
    kernels.reset_counts()
    try:
        for query, expected in zip(queries, want):
            status, version, data = _request(server.server_address[1],
                                             "POST", "/query", query)
            assert (status, version) == (200, VERSION)
            assert json.loads(data) == expected, query
    finally:
        server.shutdown()
    assert kernels.VM_RUN.launches + kernels.VM_RUN_SHARDED.launches > 0
    assert kernels.GROUP_COUNTS.launches > 0
