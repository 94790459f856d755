"""mutations_dense_read_pct (``benchmark/metrics/mutations_dense_read_pct.py``)
on engine stubs built by hand: the words K2 read over the rows it reduced
times the flat words, between the window's open and close, and nothing from
a port without the counter."""

from types import SimpleNamespace

import pytest

from benchmark import run


def _window(opened: dict, closed: dict):
    window = SimpleNamespace(counters={name: (opened[name], closed[name])
                                       for name in opened})
    window.counter = lambda name: (window.counters[name][1]
                                   - window.counters[name][0])
    return window


def test_the_dense_read_share_reads_the_words_k2_read_by_hand():
    reader = run.metric_module("mutations_dense_read_pct")
    engine = SimpleNamespace(mutation_dense_words_read=5_000,
                             mutation_dense_rows=10, n_flat_words=2_000)
    opened = reader.counters(engine)
    assert opened == {"mutation_dense_words_read": 5_000,
                      "mutation_dense_flat_words": 20_000}
    # 237 rows more, of which K2 read 500 words each
    engine.mutation_dense_rows += 237
    engine.mutation_dense_words_read += 237 * 500
    closed = reader.counters(engine)
    assert reader.read(_window(opened, closed)) == pytest.approx(25.0)
    # a window in which K2 never launched gives no value
    assert reader.read(_window(opened, opened)) is None


def test_a_port_without_the_counter_gives_no_dense_read_share():
    reader = run.metric_module("mutations_dense_read_pct")
    parent = SimpleNamespace(mutation_dense_rows=10, n_flat_words=2_000)
    assert reader.counters(parent) == {}
    assert reader.read(SimpleNamespace(counters={})) is None
