"""The variant-page deployment (``benchmark/dashboard.py``) as the harness
uses it: the corpus module honours the contract, the generator's pages,
the reference on a corpus built by hand, each new reader on hand-made spans,
counters and timelines, the least bytes of ``groupby_roofline_pct``, and a
small run of ``lineage1m_dash.variant_page`` that is correct and that the
control fails."""

import datetime
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import control, dashboard, lineage, run
from benchmark.load import Record
from benchmark.roofline import HBM_BYTES_PER_S
from benchmark.roofline_groupby import code_bytes, least_bytes, query_bytes
from benchmark.run import Run
from benchmark.tracing import Trace
from lapis_silo_torch import tracing

CPU = torch.device("cpu")
CELL = "lineage1m_dash.variant_page"
KINDS = ["count_variant", "count_baseline", "date_variant", "date_baseline",
         "country_variant", "nucleotide", "amino_acid"]


def _small() -> dict:
    config, _ = run.cell_files(run.load_spec(), CELL)
    return {"config": {
        "n_sequences": 4096, "max_partitions": 8,
        "nucleotide_segments": {"main": 900},
        "genes": {name: max(8, length // 30)
                  for name, length in config["genes"].items()},
        "lineages": dict(config["lineages"], count=150)},
        "mix": {"warmup_requests": 16, "prefetch_per_s": 200,
                "loop": {"kind": "closed", "clients": 4},
                "check": {kind: 8 for kind in KINDS}}}


def test_the_configuration_names_this_module_of_the_contract():
    config, mix = run.cell_files(run.load_spec(), CELL)
    assert run.corpus_module(config) is dashboard
    lineage_config, _ = run.cell_files(run.load_spec(),
                                       "lineage1m.mutations")
    # lineage1m's corpus, scale and seeds
    for key in ("n_sequences", "nucleotide_segments", "genes", "lineages",
                "countries", "country_weights", "n_days", "max_partitions"):
        assert config[key] == lineage_config[key], key
    assert list(config["reduced"]) == ["n_sequences"]
    assert [kind["name"] for kind in mix["kinds"]] == KINDS
    assert mix["check"] == {kind: 64 for kind in KINDS}
    assert mix["warmup_requests"] == 256
    assert mix["loop"] == {"kind": "closed", "clients": 16}


# -- the generator -----------------------------------------------------------------

@pytest.fixture(scope="module")
def drawn():
    config, mix = run.cell_files(run.load_spec(), CELL, _small())
    corpus = dashboard.draw_for(config, 2 ** 31 + 9)
    return corpus, mix


def test_pages_come_in_order_and_no_variant_is_sent_twice(drawn):
    corpus, mix = drawn
    generator = dashboard.generator_for(mix, corpus, 2 ** 31 + 9)
    stream = generator.stream(chunk=50)  # pages straddle the parts
    stream.prefetch(7 * 40)
    window = [stream[i] for i in range(7 * 40)]
    warm = generator.requests(mix["warmup_requests"], stream=2)
    assert [r.kind for r in window] == KINDS * 40
    assert [r.kind for r in warm] == (KINDS * 3)[:16]
    reference = dashboard.reference_for(corpus)
    newest = corpus.date_text(int(corpus.day.max()))
    variants, baselines = [], set()
    for j in range(40):
        page = [json.loads(r.body) for r in window[7 * j:7 * j + 7]]
        filters = [p["filterExpression"] for p in page]
        variant, baseline = filters[0], filters[1]
        assert filters[2:] == [variant, baseline, variant, variant, variant]
        assert variant["children"][0]["type"] == "PangoLineage"
        assert baseline == {"type": "And", "children": variant["children"][1:]}
        assert [p["action"] for p in page] == [k["action"]
                                               for k in mix["kinds"]]
        # every second page ends on the newest day; two of every four
        # name a country
        if j % 2 == 0:
            assert variant["children"][1]["to"] == newest
        assert (len(variant["children"]) == 3) == (j // 2 % 2 == 0)
        assert reference.select(variant).sum() > 0
        variants.append(json.dumps(variant))
        baselines.add(json.dumps(baseline))
    assert len(set(variants)) == len(variants)
    assert len(baselines) < len(variants)  # baselines repeat
    warm_variants = {json.dumps(json.loads(r.body)["filterExpression"])
                     for r in warm if r.kind == "count_variant"}
    assert warm_variants and not warm_variants & set(variants)
    # the same seed draws the same requests afresh
    again = dashboard.generator_for(mix, corpus, 2 ** 31 + 9).stream(chunk=64)
    assert [again[i].body for i in range(7 * 40)] == [r.body for r in window]


# -- the reference on a corpus built by hand ---------------------------------------

def _hand_corpus():
    """43 genomes in two partitions: 0-35 of A.1, 36-42 of A; genome i on
    day i mod 3 and in country X (even i) or Y (odd); no genome in Z."""
    tree = lineage.Tree(
        unaliased=["A", "A.1"], names=["A", "A.1"],
        parent=np.array([-1, 0]), alias_key={},
        start=np.array([0, 0]), end=np.array([9, 9]),
        genomes=np.array([7, 36]), n_nuc=np.array([0, 0]),
        aa_genes=[np.array([], np.int64), np.array([], np.int64)])
    main = lineage.Segment("nuc", "main", np.array([1, 2], np.uint8))
    i64 = lambda *v: np.array(v, dtype=np.int64)  # noqa: E731
    u8 = lambda *v: np.array(v, dtype=np.uint8)  # noqa: E731
    genomes = np.arange(43)
    return lineage.Corpus(
        [main], tree, datetime.date(2021, 1, 1), 10, ["X", "Y", "Z"],
        i64(0, 33, 43), np.array([1] * 36 + [0] * 7, dtype=np.int32),
        (genomes % 3).astype(np.int32), (genomes % 2).astype(np.int8),
        paths={"main": (i64(), i64(), u8())},
        private={"main": (i64(), i64(), u8(), u8())},
        runs={"main": (i64(), i64(), i64())})


def _lineage(value, sub=True):
    return {"type": "PangoLineage", "column": "pangoLineage", "value": value,
            "includeSublineages": sub}


def _country(value):
    return {"type": "StringEquals", "column": "country", "value": value}


def _ask(reference, node, fields=None):
    action = {"type": "Aggregated"}
    if fields:
        action["groupByFields"] = fields
    return reference.answer(json.dumps({"action": action,
                                        "filterExpression": node}))


def test_the_reference_counts_a_hand_built_corpus():
    reference = dashboard.reference_for(_hand_corpus())
    assert _ask(reference, _lineage("A.1", False)) == [{"count": 36}]
    assert _ask(reference, _lineage("A")) == [{"count": 43}]
    assert _ask(reference, {"type": "And", "children": [
        _lineage("A", False), _country("X")]}) == [{"count": 4}]
    assert sorted(_ask(reference, _lineage("A"), ["date"]),
                  key=lambda r: r["date"]) == [
        {"date": "2021-01-01", "count": 15},
        {"date": "2021-01-02", "count": 14},
        {"date": "2021-01-03", "count": 14}]
    assert sorted(_ask(reference, _lineage("A.1"), ["country"]),
                  key=lambda r: r["country"]) == [
        {"country": "X", "count": 18}, {"country": "Y", "count": 18}]
    # a country no genome holds: a count of 0, no group
    assert _ask(reference, _country("Z")) == [{"count": 0}]
    assert _ask(reference, _country("Z"), ["date"]) == []
    assert _ask(reference, _country("Z"), ["country"]) == []
    assert _ask(reference, _country("W"), ["country"]) == []


def test_the_stale_reference_drops_the_newest_day():
    stale = dashboard.stale_reference_for(_hand_corpus())
    assert _ask(stale, _lineage("A")) == [{"count": 29}]
    assert {r["date"] for r in _ask(stale, _lineage("A"), ["date"])} == {
        "2021-01-01", "2021-01-02"}


def test_the_port_answers_the_hand_built_corpus_as_the_reference():
    import lapis_silo_torch
    from benchmark.reference.compare import agrees
    corpus = _hand_corpus()
    db = dashboard.build_database(corpus)
    lapis_silo_torch.install(db, CPU)
    reference = dashboard.reference_for(corpus)
    for node in (_lineage("A"), _lineage("A.1", False), _country("Z"),
                 {"type": "And", "children": [_lineage("A", False),
                                              _country("X")]}):
        for fields in (None, ["date"], ["country"]):
            action = {"type": "Aggregated"}
            if fields:
                action["groupByFields"] = fields
            query = json.dumps({"action": action, "filterExpression": node})
            assert agrees(reference, query, db.execute_query(query)), query


# -- the least bytes ----------------------------------------------------------------

def test_the_least_group_bytes_of_a_hand_built_corpus():
    corpus = _hand_corpus()
    # the filter: 2 + 1 words; dates: 3 days held, 1 byte a code, 3 counts;
    # countries: 2 held (Z by none), 1 byte a code, 2 counts
    assert least_bytes(corpus) == {"date": 4 * 3 + 43 + 4 * 3,
                                   "country": 4 * 3 + 43 + 4 * 2}
    assert query_bytes(corpus, ("date", "country")) == 4 * 3 + 43 + 4 * 6
    assert dashboard.build_database(corpus).least_group_bytes == least_bytes(
        corpus)
    assert [code_bytes(n) for n in (1, 256, 257, 1096, 65536, 65537)] == [
        1, 1, 2, 2, 2, 4]


# -- the readers ---------------------------------------------------------------------

MS = 1_000_000  # ns
T0 = 10_000 * MS
SPANS = [  # (name, start, end) from the window's start
    ("groupby.filter", 0, 4 * MS), ("groupby.reduce", 4 * MS, 5 * MS),
    ("groupby.assemble", 5 * MS, 5 * MS + 200_000),
    ("groupby.filter", 10 * MS, 12 * MS), ("groupby.reduce", 12 * MS, 15 * MS),
    ("groupby.assemble", 15 * MS, 15 * MS + 400_000),
    ("mutations.filter", 20 * MS, 80 * MS),
    ("groupby.filter", 150 * MS, 160 * MS),  # after the window
]


def _traced(spans=SPANS, events=(), records=()):
    ring = tracing.Recorder(64)
    for name, start, end in spans:
        ring.record(tracing.NAMES.index(name), T0 + start, T0 + end,
                    ring.new_id(), 0, 0)
    trace = Trace()
    trace.t0_ns, trace.t1_ns = T0, T0 + 100 * MS
    trace.device_events = [(name, T0 + a, T0 + b) for name, a, b in events]
    return ring, Run(list(records), 0.0, 0.1, 60.0, 1.0, 1, trace=trace)


@pytest.mark.parametrize("name,value", [("groupby_filter_ms", 3.0),
                                        ("groupby_reduce_ms", 2.0),
                                        ("groupby_assemble_ms", 0.3)])
def test_the_span_readers(name, value, monkeypatch):
    ring, window = _traced()
    monkeypatch.setattr(tracing, "RECORDER", ring)
    assert run.reader(name)(window) == pytest.approx(value)
    ring, window = _traced([s for s in SPANS
                            if not s[0].startswith("groupby.")])
    monkeypatch.setattr(tracing, "RECORDER", ring)
    assert run.reader(name)(window) is None


def _window(opened: dict, closed: dict):
    window = SimpleNamespace(counters={name: (opened[name], closed[name])
                                       for name in opened})
    window.counter = lambda name: (window.counters[name][1]
                                   - window.counters[name][0])
    return window


def test_the_read_back_share_reads_the_group_counters():
    reader = run.metric_module("groupby_readback_pct")
    engine = SimpleNamespace(group_queries=3, group_key_cells=50,
                             group_cells_read=900)
    opened = reader.counters(engine)
    # a date group-by (1,096 groups in the 16,384 bucket over 29
    # partitions) and a country group-by (10 in the 64 bucket)
    engine.group_key_cells += 1096 + 10
    engine.group_cells_read += 29 * 16385 + 29 * 65
    closed = reader.counters(engine)
    assert reader.read(_window(opened, closed)) == pytest.approx(
        100 * 1106 / (29 * 16450))
    assert reader.read(_window(opened, opened)) is None
    assert reader.counters(SimpleNamespace(mutation_queries={})) == {}
    assert reader.read(SimpleNamespace(counters={})) is None


def test_the_roofline_reads_k9_time_and_the_answered_group_bys():
    reader = run.metric_module("groupby_roofline_pct")
    least = {"date": 2_000_000, "country": 1_000_000}
    db = SimpleNamespace(least_group_bytes=least)
    counters = reader.counters(SimpleNamespace(db=db))
    # K9 for 40 us in the window, a VM launch beside it
    events = [("void (anonymous namespace)::group_counts_kernel<short>(...)",
               1 * MS, 1 * MS + 30_000),
              ("void (anonymous namespace)::group_counts_kernel<unsigned "
               "char>(...)", 2 * MS, 2 * MS + 10_000),
              ("vm_run_kernel", 3 * MS, 4 * MS)]
    records = [Record(0, "date_variant", 0, 0, 0.05),
               Record(1, "date_baseline", 0, 0, 0.06),
               Record(2, "country_variant", 0, 0, 0.07),
               Record(3, "date_variant", 0, 0, 0.2),  # after the window
               Record(4, "nucleotide", 0, 0, 0.05),
               Record(5, "date_variant", 0, 0, 0.05, error="refused")]
    _ring, window = _traced(events=events, records=records)
    window.counters = {name: (n, n) for name, n in counters.items()}
    want = 100 * (2 * 2_000_000 + 1_000_000) / HBM_BYTES_PER_S / 40e-6
    assert reader.read(window) == pytest.approx(want)
    # no K9 on the timeline, or a database without the bytes: nothing
    _ring, window = _traced(events=events[2:], records=records)
    window.counters = {name: (n, n) for name, n in counters.items()}
    assert reader.read(window) is None
    _ring, window = _traced(events=events, records=records)
    assert reader.read(window) is None
    assert reader.counters(SimpleNamespace(db=SimpleNamespace())) == {}


def test_the_rate_and_the_idle_share():
    records = [Record(0, "date_variant", 0, 0, 0.05),
               Record(1, "nucleotide", 0, 0, 0.2),
               Record(2, "count_variant", 0, 0, None)]
    _ring, window = _traced(events=[("k", 0, 30 * MS), ("c", 20 * MS,
                                                         40 * MS)],
                            records=records)
    assert run.reader("qps.variant_page")(window) == pytest.approx(10.0)
    assert run.reader("device_idle_pct.variant_page")(window) == (
        pytest.approx(60.0))
    assert run.reader("device_idle_pct.variant_page")(
        Run([], 0.0, 0.1, 60.0, 1.0, 1)) is None


# -- a small run ---------------------------------------------------------------------

def test_a_small_run_is_correct_and_the_control_fails_it():
    small = _small()
    result = run.run_cell(CELL, 2 ** 31 + 5, 1.5, True, CPU, overrides=small)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    metrics = result["metrics"]
    for name in ("groupby_filter_ms", "groupby_reduce_ms",
                 "groupby_assemble_ms", "groupby_readback_pct",
                 "qps.variant_page"):
        assert name in metrics, name
    assert 0 < metrics["groupby_readback_pct"]["value"] <= 100
    checks = control.readings(CELL, 2 ** 31 + 5, 1.5, small)
    assert checks["wrong_answers"][0] > 0
