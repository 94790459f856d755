"""Percentiles over every request of the window, from when it was due; the
closed loop's records; spreads."""

import gc
import statistics

import numpy as np
import pytest

from benchmark.load import Record, closed
from benchmark.run import Run, reader
from benchmark.stats import latencies_ms, percentile, spread
from benchmark.traffic.generator import Generator, Request, load_mix


def _run(records):
    return Run(records, t0=100.0, t1=110.0, grace_s=60.0,
               setup_s=1.0, flat_words=1)


def test_percentiles_are_nearest_rank():
    values = list(range(1, 101))
    assert percentile(values, 50) == 50
    assert percentile(values, 95) == 95
    assert percentile([3.0], 95) == 3.0
    assert percentile([1, 2], 50) == 1


def test_latency_runs_from_the_due_time_and_keeps_every_request():
    records = [Record(i, "count", due=100.0 + i * 0.1, start=100.0 + i * 0.1,
                      end=100.0 + i * 0.1 + 0.002) for i in range(99)]
    # one request waited in the queue for a stalled worker: its latency
    # counts from when it was due, not from when it started
    records[10].start = records[10].due + 0.5
    records[10].end = records[10].due + 0.503
    # one failed, one never answered within the grace
    records[20].error = "RuntimeError: boom"
    records[20].end = records[20].due + 0.004
    records.append(Record(99, "count", due=109.9, start=109.9, end=None))
    run = _run(records)
    times = latencies_ms(run)
    assert len(times) == 100
    assert max(times) == pytest.approx((170.0 - 109.9) * 1e3)
    assert percentile(times, 50) == pytest.approx(2.0)
    # 95th of 100: the 95th smallest; the stalled and the unanswered are
    # the two largest
    assert percentile(times, 95) == pytest.approx(2.0)
    assert sorted(times)[-2] == pytest.approx(503.0)


def test_a_stall_moves_the_tail():
    records = [Record(i, "count", due=100.0 + i * 0.1, start=100.0 + i * 0.1,
                      end=100.0 + i * 0.1 + 0.002) for i in range(100)]
    for record in records[40:50]:  # a 1 s stall: ten requests wait for it
        record.end = 105.0
    assert percentile(latencies_ms(_run(records)), 95) == pytest.approx(
        (105.0 - records[45].due) * 1e3)


@pytest.mark.parametrize("name", ["qps.counts", "qps.hot"])
def test_qps_counts_answers_inside_the_window(name):
    records = [Record(i, "count", 100.0, 100.0, end=100.0 + i * 0.11)
               for i in range(100)]  # the last ten end after 110
    records[5].error = "boom"
    assert reader(name)(_run(records)) == pytest.approx(
        (91 - 1) / 10)


def test_spread_is_the_quartile_distance_over_the_median():
    values = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, median, q3 = statistics.quantiles(values, n=4)
    assert spread(values) == pytest.approx((q3 - q1) / median)



class _Endless:
    def __getitem__(self, i):
        return Request("count", str(i))


def test_a_closed_loop_holds_only_the_answers_it_may_check():
    def execute(request):
        i = int(request.body)
        if i % 7 == 3:
            raise RuntimeError("boom")
        return {"queryResult": [{"count": i}]}

    records, t0, t1 = closed(execute, _Endless(), 3, 0.2,
                             hold=lambda i: i % 5 == 0)
    assert records and t1 == pytest.approx(t0 + 0.2)
    assert sorted(r.index for r in records) == list(range(len(records)))
    for r in records:
        assert r.end is not None and r.start <= r.end
        assert r.held == (r.index % 5 == 0)
        if r.index % 7 == 3:
            assert r.error == "RuntimeError: boom" and r.response is None
        elif r.held:
            assert r.response == {"queryResult": [{"count": r.index}]}
        else:
            assert r.response is None


def test_the_request_stream_adds_nothing_for_the_collector():
    """Requests drawn ahead sit in lists of strings: the collector's passes,
    which the program pays for, do not grow with them."""
    generator = Generator(load_mix("counts"), np.ones(500, dtype=np.int64),
                          ["A"], 2021, 3, 27, 1)
    gc.collect()
    before = len(gc.get_objects())
    stream = generator.stream(chunk=5000)
    stream.prefetch(20000)
    gc.collect()
    assert len(gc.get_objects()) - before < 100
