"""The port's spans (``lapis_silo_torch.tracing``) on the count path, on the
CPU: off with the performance logger below INFO, one request tree per
answered count and one batch tree per launch when on, the collector's
passes, the ring's refusal of a window it has lost, the operator's summary
line, and the clock shared with ``torch.profiler``."""

import gc
import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import lapis_silo_torch
from lapis_silo_torch import tracing
from lapis_silo_torch.testing import sample_count_queries, synthetic_database

CPU = torch.device("cpu")
FOREVER = (0, 2 ** 63 - 1)


@pytest.fixture(scope="module")
def db():
    db = synthetic_database(600, 200, n_partitions=2, seed=3)
    lapis_silo_torch.install(db, CPU)
    return db


@pytest.fixture
def recorder(monkeypatch):
    """A fresh ring in place of the module's, the performance logger as it
    was afterwards, and the collector's callback taken out again."""
    ring = tracing.Recorder(1 << 14)
    monkeypatch.setattr(tracing, "RECORDER", ring)
    logger = tracing.PERFORMANCE_LOGGER
    level = logger.level
    yield ring
    logger.setLevel(level)
    ring.collect(False)


def _switch(on: bool) -> None:
    tracing.PERFORMANCE_LOGGER.setLevel(logging.INFO if on
                                        else logging.WARNING)


def _serve(db, queries, clients=8):
    with ThreadPoolExecutor(clients) as pool:
        return list(pool.map(db.execute_query, queries))


def _by_name(rows, name):
    return {k: v[rows["name"] == tracing.NAMES.index(name)]
            for k, v in rows.items()}


def test_off_records_nothing_and_installs_no_callback(db, recorder):
    _switch(False)
    callbacks = list(gc.callbacks)
    answers = _serve(db, sample_count_queries(db, 24, seed=5))
    assert all(a["queryResult"][0]["count"] >= 0 for a in answers)
    gc.collect()
    assert gc.callbacks == callbacks
    assert len(recorder.spans(*FOREVER)["id"]) == 0


def test_each_count_has_its_request_tree_and_each_batch_its_launch(db,
                                                                   recorder):
    queries = sample_count_queries(db, 48, seed=6)
    _switch(False)
    want = _serve(db, queries)
    _switch(True)
    assert _serve(db, queries) == want
    rows = recorder.spans(*FOREVER)
    requests = _by_name(rows, "request")
    assert len(requests["id"]) == len(queries)
    for name in ("parse", "batcher.enqueue", "batcher.wait", "batcher.wake"):
        children = _by_name(rows, name)
        assert sorted(children["parent"]) == sorted(requests["id"]), name
        at = np.searchsorted(requests["id"], children["parent"],
                             sorter=np.argsort(requests["id"]))
        order = np.argsort(requests["id"])[at]
        assert (children["start"] >= requests["start"][order]).all(), name
        assert (children["end"] <= requests["end"][order]).all(), name
        assert (children["start"] <= children["end"]).all(), name
    wait, wake = _by_name(rows, "batcher.wait"), _by_name(rows, "batcher.wake")
    wait_end = dict(zip(wait["parent"].tolist(), wait["end"].tolist()))
    assert all(wait_end[p] <= s for p, s in zip(wake["parent"].tolist(),
                                                 wake["start"].tolist()))
    # the enqueue runs from the parse's end to the wait's start
    parse, enqueue = _by_name(rows, "parse"), _by_name(rows, "batcher.enqueue")
    parse_end = dict(zip(parse["parent"].tolist(), parse["end"].tolist()))
    wait_start = dict(zip(wait["parent"].tolist(), wait["start"].tolist()))
    assert all(parse_end[p] == s and wait_start[p] == e for p, s, e in zip(
        enqueue["parent"].tolist(), enqueue["start"].tolist(),
        enqueue["end"].tolist()))

    batches = _by_name(rows, "batch")
    assert set(wake["n"].tolist()) == set(batches["id"].tolist())
    assert batches["n"].sum() == len(queries)
    lower, count = _by_name(rows, "batch.lower"), _by_name(rows, "batch.count")
    for child in (lower, count):
        assert sorted(child["parent"]) == sorted(batches["id"])
        assert child["n"].sum() == len(queries)
    readback = _by_name(rows, "batch.readback")
    assert sorted(readback["parent"]) == sorted(count["id"])
    threads = set(batches["thread"].tolist())
    assert len(threads) == 1
    assert set(lower["thread"].tolist()) == threads
    assert not threads & set(requests["thread"].tolist())


def test_the_performance_log_reads_the_spans_stamps(db, recorder, caplog):
    """A route that writes the log (Details) times its filter and action
    from the parse's end on, inside its request span."""
    _switch(True)
    query = json.dumps({"action": {"type": "Details", "fields": ["key"],
                                   "limit": 2},
                        "filterExpression": {"type": "True"}})
    with caplog.at_level(logging.INFO, logger=tracing.PERFORMANCE_LOGGER.name):
        tracing.PERFORMANCE_LOGGER.addHandler(caplog.handler)
        try:
            db.execute_query(query)
        finally:
            tracing.PERFORMANCE_LOGGER.removeHandler(caplog.handler)
    filter_us, action_us = next(
        r.args for r in caplog.records
        if r.name == tracing.PERFORMANCE_LOGGER.name)
    rows = recorder.spans(*FOREVER)
    request, parse = _by_name(rows, "request"), _by_name(rows, "parse")
    assert len(request["id"]) == len(parse["id"]) == 1
    assert filter_us + action_us <= (request["end"][0] - parse["end"][0]) / 1e3


def test_a_forced_collection_is_a_gc_span_of_generation_2(recorder):
    _switch(True)
    assert tracing.enabled()
    assert recorder._on_gc in gc.callbacks
    before = time.time_ns()
    gc.collect()
    passes = _by_name(recorder.spans(before, time.time_ns()), "gc")
    assert 2 in passes["n"].tolist()
    assert (passes["end"] >= passes["start"]).all()
    _switch(False)
    assert not tracing.enabled()
    assert recorder._on_gc not in gc.callbacks


def test_a_ring_wrapped_past_the_window_returns_none():
    ring = tracing.Recorder(8)
    for i in range(20):
        ring.record(tracing.PARSE, 10 * i, 10 * i + 5, ring.new_id())
    # rows 0-11 are gone, the oldest kept ended at 125 (the first read
    # takes row 20, the slot of row 12)
    assert ring.spans(100, 1000) is None
    kept = ring.spans(150, 1000)
    assert kept["start"].tolist() == [150, 160, 170, 180, 190]
    assert kept["end"].tolist() == [155, 165, 175, 185, 195]


def test_a_read_takes_no_row_of_the_ring():
    ring = tracing.Recorder(8)
    for i in range(7):
        ring.record(tracing.PARSE, 10 * i, 10 * i + 5, ring.new_id())
    assert ring.spans(0, 1000)["start"].tolist() == list(range(0, 70, 10))
    for i in range(7, 9):  # row 8 overwrites row 0
        ring.record(tracing.PARSE, 10 * i, 10 * i + 5, ring.new_id())
    assert ring.spans(0, 1000) is None  # the oldest kept ended at 15
    assert ring.spans(15, 1000)["start"].tolist() == list(range(20, 90, 10))


def test_the_summary_line_counts_the_spans_since_the_last(monkeypatch,
                                                         caplog):
    ring = tracing.Recorder(64)
    second = 10 ** 9
    ring.tick(1 * second, ring.record(tracing.REQUEST, 0, 1, ring.new_id()))
    for i in range(3):  # the line after the first counts these
        ring.record(tracing.PARSE, i * second, i * second + 2_000_000,
                    ring.new_id())
    ring.record(tracing.BATCH, 0, 4_000_000, ring.new_id(), 0, 32)
    with caplog.at_level(logging.INFO, logger=tracing.log.name):
        ring.tick(30 * second, ring.record(tracing.GC, 0, 1_000_000,
                                           ring.new_id(), 0, 2))
        assert not caplog.records  # not yet due
        ring.tick(61 * second, ring.record(tracing.GC, 0, 3_000_000,
                                           ring.new_id(), 0, 2))
        ring.tick(125 * second, ring.record(tracing.GC, 0, 1_000_000,
                                            ring.new_id(), 0, 1))
    lines = [r.getMessage() for r in caplog.records]
    assert lines == [
        "spans in the last 60.0 s: parse 3 x 2.000 ms, batch 1 x 4.000 ms, "
        "gc 2 x 2.000 ms, 32.0 queries a batch",
        "spans in the last 64.0 s: gc 1 x 1.000 ms"]
    # more rows than the ring holds since the last line: the lost ones said
    first = ring.record(tracing.PARSE, 0, 1_000_000, ring.new_id())
    for _ in range(69):
        last = ring.record(tracing.PARSE, 0, 1_000_000, ring.new_id())
    assert ring.summary(first, last + 1, 1.0) == (
        "spans in the last 1.0 s: parse 64 x 1.000 ms, 6 rows lost")


def test_a_span_encloses_the_profilers_event_on_its_clock(recorder):
    """Spans and the profiler's events share time.time_ns()'s clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        start = time.time_ns()
        with record_function("tracing.clock_probe"):
            for _ in range(20):
                x = x @ x / 256
        end = time.time_ns()
    recorder.record(tracing.BATCH, start, end, recorder.new_id())
    span = _by_name(recorder.spans(*FOREVER), "batch")
    probe = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "tracing.clock_probe"
             and e.device_type() == DeviceType.CPU]
    assert len(probe) == 1
    assert span["start"][0] <= probe[0].start_ns()
    assert probe[0].start_ns() + probe[0].duration_ns() <= span["end"][0]
