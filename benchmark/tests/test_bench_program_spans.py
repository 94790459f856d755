"""The readers of the port's own spans, on hand-made spans in a ring of the
port's recorder: each metric's value, nothing where the ring has lost
part of the window, and nothing from a port without the recorder."""

import builtins

import pytest

from benchmark.run import Run, reader
from benchmark.tracing import Trace
from lapis_silo_torch import tracing

MS = 1_000_000  # ns
US = 1_000
T0 = 10_000 * MS

# (name, start, end, parent, n), times from the window's start
SPANS = [
    ("parse", -2 * MS, -1 * MS, 0, 0),  # before the window
    ("request", 0, 10 * MS, 0, 0),
    ("parse", 0, 40 * US, 1, 0),
    ("parse", 500 * US, 560 * US, 2, 0),
    ("batcher.wait", 1 * MS, 2 * MS, 1, 0),
    ("batcher.wait", 1 * MS, 4 * MS, 2, 0),
    ("batcher.wake", 6 * MS, 6 * MS + 200 * US, 1, 10),
    ("batcher.wake", 8 * MS, 8 * MS + 400 * US, 2, 11),
    ("batch", 2 * MS, 6 * MS, 0, 2),
    ("batch", 6 * MS, 8 * MS, 0, 1),
    ("batch.lower", 2 * MS, 3 * MS, 10, 2),
    ("batch.lower", 6 * MS, 6 * MS + 500 * US, 11, 1),
    ("batch.count", 3 * MS, 5 * MS, 10, 2),
    ("batch.count", 6 * MS, 7 * MS, 11, 1),
    ("batch.readback", 4 * MS, 4 * MS + 500 * US, 12, 0),
    ("batch.readback", 6 * MS, 6 * MS + 100 * US, 13, 0),
    ("gc", 10 * MS, 20 * MS, 0, 0),
    ("gc", 15 * MS, 25 * MS, 0, 1),  # overlaps the one before
    ("gc", 95 * MS, 105 * MS, 0, 2),  # cut at the window's end
    ("batch", 100 * MS, 150 * MS, 0, 5),  # after the window
    ("batcher.enqueue", 40 * US, 1 * MS, 1, 0),
    ("batcher.enqueue", 560 * US, 1 * MS, 2, 0),
    ("request", 30 * MS, 31 * MS, 0, 0),  # no children: not a count
]

EXPECTED = {
    "parse_us": 50.0,
    "batcher_wait_ms": 2.0,
    "wake_ms": 0.3,
    "dispatcher_us_per_query": 2000.0,
    "lower_us_per_query": 500.0,
    "batch_launch_ms": 1.5,
    "readback_ms": 0.3,
    "gc_pause_pct": 20.0,
    "enqueue_ms": 0.7,
    # request 2 (0-10 ms): parse 60 us and 1-8.4 ms from its wait's start
    # to its wake's end cover 7.46 ms
    "request_uncovered_pct": 25.4,
}


def _run(capacity, spans=SPANS):
    ring = tracing.Recorder(capacity)
    for name, start, end, parent, n in spans:
        ring.record(tracing.NAMES.index(name), T0 + start, T0 + end,
                    ring.new_id(), parent, n)
    trace = Trace()
    trace.t0_ns, trace.t1_ns = T0, T0 + 100 * MS
    return ring, Run([], 0.0, 0.1, 60.0, 1.0, 1, trace=trace)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name, monkeypatch):
    ring, run = _run(64)
    monkeypatch.setattr(tracing, "RECORDER", ring)
    assert reader(name)(run) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_wrapped_ring_reads_nothing(name, monkeypatch, capsys):
    ring, run = _run(8)
    monkeypatch.setattr(tracing, "RECORDER", ring)
    assert ring.spans(run.trace.t0_ns, run.trace.t1_ns) is None
    assert reader(name)(run) is None
    assert "ring lost part of the window" in capsys.readouterr().err


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_port_without_the_recorder_reads_nothing(name, monkeypatch):
    """As in a run of a port from before the recorder: nothing, no error."""
    _ring, run = _run(64)
    real = builtins.__import__

    def without_tracing(module, globals=None, locals=None, fromlist=(),
                        level=0):
        if module == "lapis_silo_torch" and "tracing" in (fromlist or ()):
            raise ImportError("cannot import name 'tracing'")
        return real(module, globals, locals, fromlist, level)
    monkeypatch.setattr(builtins, "__import__", without_tracing)
    assert reader(name)(run) is None


def test_no_collector_pass_reads_zero_and_no_spans_read_nothing(monkeypatch):
    ring, run = _run(64, [s for s in SPANS if s[0] != "gc"])
    monkeypatch.setattr(tracing, "RECORDER", ring)
    assert reader("gc_pause_pct")(run) == 0.0
    ring, run = _run(64, [])
    monkeypatch.setattr(tracing, "RECORDER", ring)
    assert reader("gc_pause_pct")(run) is None
    assert reader("parse_us")(Run([], 0.0, 0.1, 60.0, 1.0, 1)) is None
