"""The port serving a dashboard's variant page on a lineage-partitioned
corpus (``benchmark/lineage.py`` at a small size, 8 lineage partitions)
against the plain reference (``benchmark/reference/dashboard.py``): each of
the page's seven requests (``benchmark/dashboard.py``: the variant's and
the baseline's counts and counts by date, the variant by country, its
nucleotide and amino-acid mutations) through ``Database.execute_query`` on
the card's path with no host fallback, from several threads at once; and
the group-by spans and counters of ``lapis_silo_torch.tracing`` and the
device engine."""

import json
import logging
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import lapis_silo_torch
from benchmark import dashboard, lineage
from benchmark.reference.compare import agrees
from benchmark.traffic.generator import load_mix
from lapis_silo_torch import tracing
from lapis_silo_torch.ops.device_engine import DeviceEngine
from lapis_silo_torch.query.engine import QueryEngine

CPU = torch.device("cpu")
FOREVER = (0, 2 ** 63 - 1)
SEED = 2 ** 31 + 25
MIX = load_mix("variant_page")
KINDS = [kind["name"] for kind in MIX["kinds"]]
PAGES = 8  # every combination of window and country twice


def _config() -> dict:
    config = json.loads((Path(lineage.__file__).parent / "configs"
                         / "lineage1m_dash.json").read_text())
    config.update(
        n_sequences=3000, max_partitions=8,
        nucleotide_segments={"main": 1500},
        genes={name: max(8, length // 25)
               for name, length in config["genes"].items()})
    config["lineages"] = dict(config["lineages"], count=160)
    return config


@pytest.fixture(scope="module")
def corpus():
    return dashboard.draw_for(_config(), SEED)


@pytest.fixture(scope="module")
def reference(corpus):
    return dashboard.reference_for(corpus)


@pytest.fixture(scope="module")
def served(corpus):
    """The corpus on the dense bank and on the two-tier bank (every row of
    a flat word or more sparse where no partition holds it as its
    majority)."""
    db = dashboard.build_database(corpus)
    lapis_silo_torch.install(db, CPU)
    out = {"dense": db}
    db = dashboard.build_database(corpus)
    engine = DeviceEngine(db, CPU, sparse_min_words=1)
    db.device_engine, db._engine = engine, QueryEngine(db, engine)
    out["two_tier"] = db
    return out


@pytest.fixture(scope="module")
def pages(corpus):
    """The first PAGES pages of the window's stream, request by request."""
    generator = dashboard.generator_for(MIX, corpus, SEED)
    return generator.requests(PAGES * len(KINDS))


def _of(pages, kind: str) -> list[str]:
    return [r.body for r in pages if r.kind == kind]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("path", ["dense", "two_tier"])
def test_each_request_of_the_page_equals_the_reference(reference, served,
                                                       pages, path, kind):
    bodies = _of(pages, kind)
    assert len(bodies) == PAGES
    answered = 0
    for body in bodies:
        got = served[path].execute_query(body)
        assert agrees(reference, body, got), (body, got["queryResult"][:5],
                                              reference.answer(body)[:5])
        answered += bool(got["queryResult"])
    assert answered


def test_no_request_of_the_page_falls_back_to_the_host(reference, served,
                                                       pages, monkeypatch):
    """With the host's route refusing every filter (``_evaluate_filter``,
    where a request the device engine does not answer goes), each kind is
    answered on the device engine: the counts through the micro-batcher,
    the group-bys through K9 (group_counts), the Mutations through the
    device filter, K2 and K3."""
    def refuse(*args, **kwargs):
        raise AssertionError("the host's route answered")

    monkeypatch.setattr(QueryEngine, "_evaluate_filter", refuse)
    db = served["dense"]
    engine = db.device_engine
    batched = engine.count_coalesced
    coalesced = []

    def counting(*args, **kwargs):
        coalesced.append(1)
        return batched(*args, **kwargs)

    monkeypatch.setattr(engine, "count_coalesced", counting)
    before = (engine.group_queries, dict(engine.mutation_queries))
    for r in pages[:len(KINDS)]:
        got = db.execute_query(r.body)
        assert agrees(reference, r.body, got), r.body
    assert len(coalesced) == 2
    assert engine.group_queries == before[0] + 3
    assert engine.mutation_queries == {kind: before[1][kind] + 1
                                       for kind in ("nuc", "aa")}


def test_eight_threads_sending_every_kind_at_once_agree(reference, served,
                                                         pages, recorder):
    """Traced, with the interpreter switching threads often: every answer
    equals the reference, the group counters lose no update, and each
    group-by's three spans lie under its own request."""
    db = served["two_tier"]
    engine = db.device_engine
    bodies = [r.body for r in pages] * 2
    before = engine.group_queries
    tracing.PERFORMANCE_LOGGER.setLevel(logging.INFO)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(db.execute_query, bodies))
    finally:
        sys.setswitchinterval(interval)
    for body, got in zip(bodies, answers):
        assert agrees(reference, body, got), body
    grouped = 3 * 2 * PAGES
    assert engine.group_queries == before + grouped
    rows = recorder.spans(*FOREVER)
    requests = _by_name(rows, "request")["id"]
    assert len(requests) == len(bodies)
    for name in ("groupby.filter", "groupby.reduce", "groupby.assemble"):
        parents = _by_name(rows, name)["parent"]
        assert len(parents) == len(set(parents.tolist())) == grouped
        assert set(parents.tolist()) <= set(requests.tolist())


def test_baselines_are_the_variants_without_their_lineage(pages):
    """A page's filters as the generator writes them: the baseline is the
    variant's And without its PangoLineage child."""
    for first in range(0, len(pages), len(KINDS)):
        page = pages[first:first + len(KINDS)]
        variant = json.loads(page[0].body)["filterExpression"]
        baseline = json.loads(page[1].body)["filterExpression"]
        assert variant["children"][0]["type"] == "PangoLineage"
        assert baseline == {"type": "And",
                            "children": variant["children"][1:]}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sparse_min_words", [None, 1])
def test_every_kind_from_eight_threads_on_the_card_equals_the_reference(
        corpus, reference, pages, cuda_device, sparse_min_words):
    """K9 launched from several threads at once on the card's stream,
    beside counts and Mutations: each answer equals the reference."""
    db = dashboard.build_database(corpus)
    engine = DeviceEngine(db, cuda_device, sparse_min_words=sparse_min_words)
    db.device_engine, db._engine = engine, QueryEngine(db, engine)
    bodies = [r.body for r in pages] * 4
    with ThreadPoolExecutor(8) as pool:
        answers = list(pool.map(db.execute_query, bodies))
    for body, got in zip(bodies, answers):
        assert agrees(reference, body, got), (body, got["queryResult"][:5])
    assert engine.group_queries == 3 * 4 * PAGES


# -- spans and counters ----------------------------------------------------------

@pytest.fixture
def recorder(monkeypatch):
    """A fresh ring in place of the module's, and the performance logger
    as it was afterwards."""
    ring = tracing.Recorder(1 << 12)
    monkeypatch.setattr(tracing, "RECORDER", ring)
    logger = tracing.PERFORMANCE_LOGGER
    level = logger.level
    yield ring
    logger.setLevel(level)
    ring.collect(False)


def _by_name(rows, name):
    return {k: v[rows["name"] == tracing.NAMES.index(name)]
            for k, v in rows.items()}


def _counters(engine) -> tuple:
    return (engine.group_queries, engine.group_cells_read,
            engine.group_key_cells)


@pytest.mark.parametrize("kind,column", [("date_variant", "date"),
                                         ("date_baseline", "date"),
                                         ("country_variant", "country")])
def test_a_traced_group_by_records_its_spans_and_counters(
        corpus, served, pages, recorder, kind, column):
    db = served["dense"]
    engine = db.device_engine
    before = _counters(engine)
    tracing.PERFORMANCE_LOGGER.setLevel(logging.INFO)
    db.execute_query(_of(pages, kind)[0])
    rows = recorder.spans(*FOREVER)
    (request,) = _by_name(rows, "request")["id"]
    names = {tracing.NAMES[i] for i in rows["name"]} - {"gc"}
    assert names == {"request", "parse", "groupby.filter", "groupby.reduce",
                     "groupby.assemble"}
    filt, reduce_, assemble = (_by_name(rows, name) for name in (
        "groupby.filter", "groupby.reduce", "groupby.assemble"))
    for spans in (filt, reduce_, assemble):
        assert len(spans["id"]) == 1 and spans["parent"][0] == request
        assert spans["end"][0] >= spans["start"][0]
    parse = _by_name(rows, "parse")
    assert parse["end"][0] == filt["start"][0]
    assert filt["end"][0] == reduce_["start"][0]
    assert reduce_["end"][0] <= assemble["start"][0]
    # one read-back of [P, bucket + 1] for a key space of n_groups
    values = {"date": corpus.day, "country": corpus.country}[column]
    n_groups = (len(np.unique(values)) if column == "date"
                else len(corpus.countries))
    bucket = next(b for b in DeviceEngine._GROUP_BUCKETS if b >= n_groups)
    assert _counters(engine) == (
        before[0] + 1, before[1] + engine.n_partitions * (bucket + 1),
        before[2] + n_groups)


@pytest.mark.parametrize("kind", ["count_variant", "count_baseline",
                                  "nucleotide", "amino_acid"])
def test_counts_and_mutations_leave_the_group_counters(served, pages,
                                                       recorder, kind):
    db = served["dense"]
    engine = db.device_engine
    before = _counters(engine)
    tracing.PERFORMANCE_LOGGER.setLevel(logging.INFO)
    db.execute_query(_of(pages, kind)[0])
    assert _counters(engine) == before
    names = {tracing.NAMES[i] for i in recorder.spans(*FOREVER)["name"]}
    assert not {n for n in names if n.startswith("groupby.")}


def test_an_untraced_group_by_records_nothing(served, pages, recorder):
    tracing.PERFORMANCE_LOGGER.setLevel(logging.WARNING)
    served["dense"].execute_query(_of(pages, "date_variant")[0])
    assert len(recorder.spans(*FOREVER)["id"]) == 0
