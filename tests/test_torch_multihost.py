"""The port's multi-host slice against the JAX package's.

One seeded corpus (3 partitions, the rich column set, unaligned sequences)
is served by a slice of 3 hosts, one per partition: the coordinator's own
shard plus 2 ``start_worker`` hosts on port 0. The port's slice serves the
port's corpus, each shard with the port's engine installed on the CPU; the
JAX package's slice serves the JAX package's corpus built from the same
seed. Every body, and each invalid query's message, equals between the two
slices and the port's single-host answer; the concurrent batched fan-out
answers as the sequential one. The wire frames (``SILOPART1``,
``SILOBATCH1``) are byte-equal to the JAX package's, each package decodes
the other's, and a port coordinator over one JAX worker and one port worker
answers the same. A port worker answers its partials through the device
engine's routes (the micro-batcher, group counts, the Mutations reduction)
and never through the host evaluator; the staged watcher installs the
port's engine, or fails the staging and keeps what it serves. Every value
is an integer or an exact float of the reference: the tolerance is
equality."""

import json
import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import lapis_silo_torch
from lapis_silo_tpu import testing as ref_testing
from lapis_silo_tpu.parallel import multihost as ref_multihost
from lapis_silo_tpu.query.errors import QueryParseError as RefQueryParseError
from lapis_silo_tpu.storage.database import DataVersion as RefDataVersion
from lapis_silo_tpu.storage.unaligned import (
    UnalignedPartitionStore as RefUnalignedStore,
)
from lapis_silo_torch import testing
from lapis_silo_torch.ops.device_engine import DeviceEngine
from lapis_silo_torch.parallel import multihost
from lapis_silo_torch.query import engine as engine_mod
from lapis_silo_torch.query.errors import QueryParseError
from lapis_silo_torch.server.http_server import DatabaseMutex
from lapis_silo_torch.storage.database import DataVersion
from lapis_silo_torch.storage.unaligned import UnalignedPartitionStore

from .test_multihost import _shard_database as ref_shard_database
from .test_torch_server import _with_unaligned

CPU = torch.device("cpu")
CORPUS = dict(n_rows=1500, length=160, n_partitions=3, seed=13, rich=True)
VERSION = "1700000000"
FEW = {"type": "And", "children": [
    {"type": "HasNucleotideMutation", "position": 40},
    {"type": "IntBetween", "column": "age", "from": 20, "to": 60}]}


def _queries(db) -> list[str]:
    """Counts, group-by with order, limit and offset, Details with order and
    limit, Fasta, Mutations, AminoAcidMutations and Insertions."""
    actions = [
        {"type": "Aggregated", "groupByFields": ["country"],
         "orderByFields": ["count", "country"], "limit": 3, "offset": 1},
        {"type": "Aggregated", "groupByFields": ["date", "country"],
         "orderByFields": [{"field": "date", "order": "descending"},
                           "country"], "limit": 7},
        {"type": "Aggregated", "groupByFields": ["age"], "offset": 500},
        {"type": "Aggregated", "groupByFields": ["pango_lineage"]},
        {"type": "Details", "fields": ["key", "age", "qc_value"],
         "orderByFields": ["age", "key"], "limit": 25, "offset": 3},
        {"type": "Details", "fields": ["key", "date"]},
        {"type": "Fasta", "sequenceName": "main", "orderByFields": ["key"]},
        {"type": "Mutations", "minProportion": 0.02},
        {"type": "Mutations", "minProportion": 0.3,
         "orderByFields": ["proportion", "mutation"], "limit": 5},
        {"type": "AminoAcidMutations", "minProportion": 0.005},
        {"type": "Insertions"},
        {"type": "AminoAcidInsertions"},
    ]
    return testing.sample_count_queries(db, 12, seed=4) + [
        json.dumps({"action": a, "filterExpression": f})
        for a in actions for f in (FEW, {"type": "True"})
        if not (a["type"] in ("Fasta", "Details") and f["type"] == "True")]


INVALID = [
    "{ not json",
    json.dumps({"action": {"type": "Aggregated"},
                "filterExpression": {"type": "NoSuchFilter"}}),
    json.dumps({"action": {"type": "Aggregated", "groupByFields": ["nope"]},
                "filterExpression": {"type": "True"}}),
    json.dumps({"action": {"type": "Aggregated", "groupByFields": ["country"],
                           "orderByFields": ["age"]},
                "filterExpression": {"type": "True"}}),
    json.dumps({"action": {"type": "Mutations", "sequenceNames": ["nope"]},
                "filterExpression": {"type": "True"}}),
    json.dumps({"action": {"type": "Details", "fields": ["nope"]},
                "filterExpression": {"type": "True"}}),
]


def _slice(shards, start_worker, coordinator_cls):
    servers = [start_worker(shard) for shard in shards[1:]]
    urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
    return coordinator_cls(shards[0], urls, include_local=True), servers


@pytest.fixture(scope="module")
def corpora():
    port_db = _with_unaligned(testing.synthetic_database(**CORPUS),
                              UnalignedPartitionStore)
    ref_db = _with_unaligned(ref_testing.synthetic_database(**CORPUS),
                             RefUnalignedStore)
    port_db.data_version = DataVersion(VERSION)
    ref_db.data_version = RefDataVersion(VERSION)
    return port_db, ref_db


@pytest.fixture(scope="module")
def slices(corpora):
    """(port coordinator, JAX coordinator, port shards, JAX shards): one
    host per partition, each port shard on the port's CPU engine."""
    port_db, ref_db = corpora
    port_shards = [testing.shard_database(port_db, [i]) for i in range(3)]
    for shard in port_shards:
        lapis_silo_torch.install(shard, CPU)
    ref_shards = [ref_shard_database(ref_db, [i]) for i in range(3)]
    port, port_servers = _slice(port_shards, multihost.start_worker,
                                multihost.Coordinator)
    ref, ref_servers = _slice(ref_shards, ref_multihost.start_worker,
                              ref_multihost.Coordinator)
    yield port, ref, port_shards, ref_shards
    for server in port_servers + ref_servers:
        server.shutdown()


@pytest.fixture(scope="module")
def single(corpora):
    """The port's single host over the whole corpus, on its CPU engine."""
    port_db, _ref_db = corpora
    lapis_silo_torch.install(port_db, CPU)
    return port_db


def test_slice_answers_as_the_jax_slice_and_the_single_host(slices, single):
    port, ref, _port_shards, _ref_shards = slices
    queries = _queries(single)
    for query in queries:
        want = single.execute_query(query)
        assert port.execute_query(query) == want, query
        assert ref.execute_query(query) == want, query
    assert port.info() == ref.info() == single.info()
    assert port.detailed_info() == ref.detailed_info() == single.detailed_info()


@pytest.mark.parametrize("query", INVALID, ids=range(len(INVALID)))
def test_invalid_query_message(slices, single, query):
    port, ref, _port_shards, _ref_shards = slices
    with pytest.raises(QueryParseError) as got:
        port.execute_query(query)
    with pytest.raises(RefQueryParseError) as want:
        ref.execute_query(query)
    with pytest.raises(QueryParseError) as alone:
        single.execute_query(query)
    assert str(got.value) == str(want.value) == str(alone.value)


def test_concurrent_queries_batch_fanout(slices, monkeypatch):
    """32 concurrent public queries through the port's coordinator: the
    doorbell batcher coalesces them into partial_batch worker requests;
    every response matches its sequential result, and an invalid query
    fails alone without poisoning its batch-mates."""
    port, _ref, _port_shards, _ref_shards = slices
    queries = [
        json.dumps({"action": {"type": "Aggregated"},
                    "filterExpression": {"type": "NucleotideEquals",
                                         "position": p, "symbol": s}})
        for p in (21, 22, 23, 24) for s in ("A", "C", "G", "T")
    ] + [
        json.dumps({"action": {"type": "Mutations", "minProportion": 0.5},
                    "filterExpression": {"type": "True"}}),
        json.dumps({"action": {"type": "Aggregated",
                               "groupByFields": ["country"]},
                    "filterExpression": {"type": "True"}}),
    ]
    sequential = [port.execute_query(q) for q in queries]
    bad = json.dumps({"action": {"type": "Aggregated"},
                      "filterExpression": {"type": "NoSuchFilter"}})
    widths = []
    batch_fanout = multihost.Coordinator._batch_fanout

    def recording(self, db, entries):
        widths.append(len(entries))
        return batch_fanout(self, db, entries)

    monkeypatch.setattr(multihost.Coordinator, "_batch_fanout", recording)

    def run(q):
        try:
            return port.execute_query(q)
        except QueryParseError as ex:
            return ("parse_error", str(ex))

    with ThreadPoolExecutor(max_workers=16) as pool:
        mixed = list(queries) * 2 + [bad] * 4
        results = list(pool.map(run, mixed))
    want = sequential * 2
    for got, expect in zip(results[: len(want)], want):
        assert got == expect
    for got in results[len(want):]:
        assert got[0] == "parse_error" and "NoSuchFilter" in got[1]
    assert sum(widths) == len(mixed) and len(widths) <= len(mixed)


def _mutations_partial() -> dict:
    rng = np.random.default_rng(3)
    return {
        "kind": "mutation_counts", "alphabet": "nuc",
        "dataVersion": "1234567890",
        "counts": {
            "main": rng.integers(0, 1 << 40, size=(16, 300)).astype(np.int64),
            "seg2": rng.integers(0, 1 << 40, size=(16, 4)).astype(np.int64),
        },
    }


def _assert_partials_equal(got: dict, want: dict) -> None:
    assert {k: v for k, v in got.items() if k != "counts"} == {
        k: v for k, v in want.items() if k != "counts"}
    assert list(got["counts"]) == list(want["counts"])
    for name in want["counts"]:
        np.testing.assert_array_equal(got["counts"][name],
                                      want["counts"][name])


def test_partial_frame_is_the_jax_frame():
    """SILOPART1: byte-equal to the JAX package's encoding of the same
    partial, and each package decodes the other's; a non-array partial
    passes through as the dict."""
    partial = _mutations_partial()
    wire = multihost.encode_partial(partial)
    assert isinstance(wire, bytes) and wire.startswith(b"SILOPART1\n")
    assert wire == ref_multihost.encode_partial(partial)
    _assert_partials_equal(ref_multihost.decode_partial(wire), partial)
    _assert_partials_equal(multihost.decode_partial(
        ref_multihost.encode_partial(partial)), partial)
    plain = {"kind": "count", "count": 7, "dataVersion": "1234567890"}
    assert multihost.encode_partial(plain) is plain
    assert multihost.decode_partial(json.dumps(plain).encode()) == plain


def test_batch_frame_is_the_jax_frame():
    """SILOBATCH1: byte-equal for the same items (a binary partial, a JSON
    partial, an error body), and each package decodes the other's."""
    items = [(200, multihost.encode_partial(_mutations_partial())),
             (200, {"kind": "count", "count": 7, "dataVersion": "1"}),
             (400, {"error": "Bad request", "message": "no"})]
    wire = multihost.encode_partial_batch(items)
    assert wire.startswith(b"SILOBATCH1\n")
    assert wire == ref_multihost.encode_partial_batch(items)
    assert (multihost.decode_partial_batch(wire)
            == ref_multihost.decode_partial_batch(wire))
    decoded = ref_multihost.decode_partial_batch(wire)
    assert [status for status, _ in decoded] == [200, 200, 400]
    _assert_partials_equal(multihost.decode_partial(decoded[0][1]),
                           _mutations_partial())
    assert json.loads(decoded[2][1])["message"] == "no"


def test_port_coordinator_over_a_jax_worker_and_a_port_worker(slices, single):
    """The mixed slice: the port's coordinator (its own shard, partition 0)
    over a JAX worker (partition 1 of the JAX corpus) and a port worker
    (partition 2) answers as the single host."""
    _port, _ref, port_shards, ref_shards = slices
    servers = [ref_multihost.start_worker(ref_shards[1]),
               multihost.start_worker(port_shards[2])]
    try:
        mixed = multihost.Coordinator(
            port_shards[0],
            [f"http://127.0.0.1:{s.server_address[1]}" for s in servers])
        for query in _queries(single):
            assert mixed.execute_query(query) == single.execute_query(query), \
                query
        assert mixed.info() == single.info()
        with pytest.raises(QueryParseError) as got:
            mixed.execute_query(INVALID[1])
        with pytest.raises(QueryParseError) as want:
            single.execute_query(INVALID[1])
        assert str(got.value) == str(want.value)
    finally:
        for server in servers:
            server.shutdown()


def test_partials_take_the_device_routes(slices, monkeypatch):
    """On each port host, a count partial goes through the micro-batcher, a
    group-by through group_counts with every group unsorted and unsliced,
    Mutations through mutation_counts_many, and the host evaluator is never
    reached while the engine is installed."""
    _port, _ref, port_shards, _ref_shards = slices
    calls = []
    for name in ("count_coalesced", "group_counts", "mutation_counts_many"):
        real = getattr(DeviceEngine, name)

        def spy(self, *args, _name=name, _real=real, **kwargs):
            calls.append((_name, self.db))
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(DeviceEngine, name, spy)

    class NoHost:
        def __init__(self, *_args):
            raise AssertionError("the host evaluator was reached")

    monkeypatch.setattr(engine_mod, "HostEvaluator", NoHost)
    count = testing.sample_count_queries(port_shards[0], 2, seed=9)[1]
    group = json.dumps({"action": {"type": "Aggregated",
                                   "groupByFields": ["country"],
                                   "orderByFields": ["count"], "limit": 1,
                                   "offset": 1},
                        "filterExpression": {"type": "True"}})
    muts = json.dumps({"action": {"type": "Mutations", "minProportion": 0.1},
                       "filterExpression": FEW})
    details = json.dumps({"action": {"type": "Details", "fields": ["key"],
                                     "limit": 3},
                          "filterExpression": FEW})
    for shard in port_shards:
        calls.clear()
        assert multihost.execute_partial(shard, count)["kind"] == "count"
        groups = multihost.execute_partial(shard, group)
        n_countries = len({shard.partitions[0].columns["country"].value_at_id(
            int(i)) for i in shard.partitions[0].columns["country"].ids})
        assert len(groups["rows"]) == n_countries > 2
        assert multihost.execute_partial(shard, muts)["counts"]
        assert multihost.execute_partial(shard, details)["rows"]
        assert [name for name, db in calls if db is shard] == [
            "count_coalesced", "group_counts", "mutation_counts_many"]


def test_staged_watcher_installs_the_port_engine(corpora, tmp_path,
                                                 monkeypatch, caplog):
    """With SILO_TORCH_DEVICE=cpu the staged database carries the port's
    engine before it is committed; with no card and no SILO_TORCH_DEVICE
    the next staging fails, is logged, and the host keeps serving the
    committed version."""
    port_db, _ref_db = corpora
    directory = tmp_path / "host"
    testing.save_shards(port_db, [[0]], [directory], "1000000001")
    monkeypatch.setenv("SILO_TORCH_DEVICE", "cpu")
    mutex = DatabaseMutex()
    watcher = multihost.StagedSnapshotWatcher(str(directory), mutex)
    watcher.check_once()
    staged = watcher._staged[1]
    assert isinstance(staged.device_engine, lapis_silo_torch.DeviceEngine)
    assert staged.device_engine.device == CPU and staged._engine._use_device
    assert watcher.commit("1000000001")
    assert mutex.get_database() is staged

    testing.save_shards(port_db, [[0]], [directory], "1000000002")
    monkeypatch.delenv("SILO_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with caplog.at_level(logging.ERROR):
        watcher.check_once()
    assert "staging snapshot failed" in caplog.text
    assert "SILO_TORCH_DEVICE" in caplog.text
    assert watcher.versions() == {"serving": "1000000001", "staged": ""}
    assert mutex.get_database() is staged


@pytest.mark.cuda
def test_slice_on_the_card_answers_as_the_host(corpora, single):
    """The port's slice with every shard's engine on the first card: every
    body equal to the single host's (the CPU engine's), K1, K2 and K9
    launched on the card and no plain version ran for a card's tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from lapis_silo_torch.ops import kernels

    port_db, _ref_db = corpora
    card = torch.device("cuda", 0)
    shards = [testing.shard_database(port_db, [i]) for i in range(3)]
    for shard in shards:
        lapis_silo_torch.install(shard, card)
    queries = _queries(single)
    want = [single.execute_query(q) for q in queries]
    coordinator, servers = _slice(shards, multihost.start_worker,
                                  multihost.Coordinator)
    kernels.reset_counts()
    try:
        for query, expected in zip(queries, want):
            assert coordinator.execute_query(query) == expected, query
    finally:
        for server in servers:
            server.shutdown()
    for k in (kernels.VM_RUN, kernels.MUTATION_COUNTS, kernels.GROUP_COUNTS):
        assert k.launches > 0, k.name
    assert not any(k.plain_launches for k in kernels.KERNELS)
