"""The idle share, the card's time per query, the gaps' labels and the
roofline's bytes, on hand-made timelines, queries and port spans."""

import json
from pathlib import Path

import pytest

from benchmark.load import Record
from benchmark.roofline import HBM_BYTES_PER_S, launch_bytes, leaves
from benchmark.run import Run, metric_entries, reader, records_timeline
from benchmark.tracing import RING_LOST, Trace, breakdown, busy, busy_s, gaps
from lapis_silo_torch import tracing

MS = 1_000_000  # ns


def _trace(events, launches=()):
    trace = Trace()
    trace.t0_ns, trace.t1_ns = 0, 100 * MS
    trace.device_events = list(events)
    trace.launches = list(launches)
    return trace


def test_busy_is_the_union_inside_the_window():
    events = [("k", 10 * MS, 20 * MS), ("copy", 15 * MS, 25 * MS),  # overlap
              ("k", 30 * MS, 31 * MS), ("k", -5 * MS, 2 * MS),  # clipped
              ("k", 99 * MS, 120 * MS)]
    assert busy(events, 0, 100 * MS) == [(0, 2 * MS), (10 * MS, 25 * MS),
                                         (30 * MS, 31 * MS),
                                         (99 * MS, 100 * MS)]
    assert busy_s(events, 0, 100 * MS) == pytest.approx(0.019)
    assert gaps(events, 0, 100 * MS)[0] == (31 * MS, 99 * MS)
    assert sum(b - a for a, b in gaps(events, 0, 100 * MS)) == 81 * MS


def test_idle_share_reader():
    trace = _trace([("k", 10 * MS, 20 * MS), ("k", 50 * MS, 60 * MS)])
    run = Run([], 0.0, 0.1, 60.0, 1.0, 1, trace=trace)
    assert reader("device_idle_pct.sat")(run) == pytest.approx(80.0)
    assert reader("device_idle_pct.sat")(
        Run([], 0.0, 0.1, 60.0, 1.0, 1,
            trace=_trace([]))) is None


def _ring(spans, capacity=64):
    """A port recorder holding `spans` ((name, start, end) in ns)."""
    ring = tracing.Recorder(capacity)
    for name, start, end in spans:
        ring.record(tracing.NAMES.index(name), start, end, ring.new_id())
    return ring


def test_gaps_are_named_by_the_span_open_last(monkeypatch, capsys):
    """The port's span that opened last names a gap; where the port's ring
    lost the window, every gap is named ``RING_LOST``, and standard error
    says so."""
    events = [("k", 0, 30 * MS), ("m", 35 * MS, 36 * MS),
              ("k", 70 * MS, 100 * MS)]
    monkeypatch.setattr(tracing, "RECORDER", _ring([
        ("request", 0, 90 * MS), ("batch.lower", 40 * MS, 60 * MS)]))
    out = breakdown(_trace(events))
    assert out["device_ops"] == [["k", 0.06], ["m", 0.001]]
    # gaps 36-70 ms (middle 53), 30-35 (32.5)
    assert out["idle_gaps"] == [["batch.lower", 0.034], ["request", 0.005]]
    assert capsys.readouterr().err == ""
    trace = _trace(events)
    lost = _ring([("batch", t * MS, t * MS + 1) for t in range(8)], 4)
    assert lost.spans(trace.t0_ns, trace.t1_ns) is None
    monkeypatch.setattr(tracing, "RECORDER", lost)
    out = breakdown(trace)
    assert out["idle_gaps"] == [[RING_LOST, 0.034], [RING_LOST, 0.005]]
    assert "ring lost part of the window" in capsys.readouterr().err


def test_gaps_are_named_by_the_port_spans_gc_first(monkeypatch, capsys):
    """A collector pass open at a gap's middle names it, though a request
    that started later covers it too; else the port's span that started
    last."""
    ring = _ring([("request", 0, 90 * MS),
                  ("gc", 31 * MS, 64 * MS),
                  ("request", 45 * MS, 80 * MS),  # later than the gc
                  ("batch", 60 * MS, 69 * MS),
                  ("batch.count", 61 * MS, 68 * MS)])
    monkeypatch.setattr(tracing, "RECORDER", ring)
    trace = _trace([("k", 0, 30 * MS), ("m", 60 * MS, 61 * MS),
                    ("k", 70 * MS, 92 * MS)])
    out = breakdown(trace)
    # gaps 30-60 ms (middle 45), 61-70 (65.5), 92-100 (96)
    assert out["idle_gaps"] == [["gc", 0.03], ["batch.count", 0.009],
                                ["no span", 0.008]]
    assert capsys.readouterr().err == ""


def _count(node):
    return json.dumps(node, sort_keys=True)


def test_roofline_bytes_count_distinct_inputs_once():
    eq = {"type": "NucleotideEquals", "position": 5, "symbol": "A"}
    has = {"type": "HasNucleotideMutation", "position": 5}
    country = {"type": "StringEquals", "column": "country", "value": "Italy"}
    queries = [_count(eq), _count({"type": "And", "children": [eq, has]}),
               _count({"type": "Or", "children": [
                   has, {"type": "Not", "child": country}]}),
               _count({"type": "N-Of", "numberOfMatchers": 2,
                       "matchExactly": False, "children": [eq, has, country]})]
    assert len(leaves(json.loads(queries[3]))) == 3
    # three distinct inputs of 4 x 1,000 bytes, four counts of 4 bytes
    assert launch_bytes(queries, 1000) == 3 * 4000 + 4 * 4


@pytest.mark.parametrize("name", ["vm_roofline_pct", "vm_roofline_pct.hot"])
def test_roofline_reader_takes_the_window_launches_and_vm_time(name):
    eq = _count({"type": "NucleotideEquals", "position": 5, "symbol": "A"})
    flat_words = 32768
    trace = _trace([("void vm_run_kernel<4, false>(...)", 10 * MS, 10 * MS
                     + 2000), ("Memcpy HtoD", 20 * MS, 21 * MS)],
                   launches=[(5 * MS, [eq, eq]), (200 * MS, [eq])])
    run = Run([], 0.0, 0.1, 60.0, 1.0, flat_words,
              trace=trace)
    least = (4 * flat_words + 8) / HBM_BYTES_PER_S
    assert reader(name)(run) == pytest.approx(100 * least / 2e-6)


def test_card_time_per_query_is_the_busy_union_over_the_answers():
    trace = _trace([("k", 10 * MS, 20 * MS), ("copy", 15 * MS, 25 * MS),
                    ("k", 90 * MS, 130 * MS)])  # clipped at the close
    records = [Record(i, "count", 0.0, 0.0, end=0.01 * (i + 1))
               for i in range(12)]  # the last two end after the close
    records[3].error = "boom"
    run = Run(records, 0.0, 0.1, 60.0, 1.0, 1, trace=trace)
    assert reader("card_us_per_query")(run) == pytest.approx(
        1e6 * 0.025 / 9)
    assert reader("card_us_per_query")(
        Run(records, 0.0, 0.1, 60.0, 1.0, 1, trace=_trace([]))) is None


def test_an_untraced_run_records_the_timeline_its_metrics_read():
    spec = json.loads((Path(__file__).resolve().parents[2]
                       / "BENCHMARK.json").read_text())
    for cell in spec["workloads"]:
        name = cell["name"]
        reads = any(m["source"] == "device_trace"
                    for m in metric_entries(spec, name, False))
        assert records_timeline(spec, name, False) == reads
        assert records_timeline(spec, name, True)
    assert records_timeline(spec, "twotier2m.hot", False)
    assert records_timeline(spec, "dense1m.counts", False)
    host_only = dict(spec, end_to_end=[m for m in spec["end_to_end"]
                                       if m["source"] != "device_trace"])
    assert not records_timeline(host_only, "dense1m.counts", False)
    assert records_timeline(host_only, "dense1m.counts", True)
