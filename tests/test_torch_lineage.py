"""The port on a lineage-partitioned corpus (``benchmark/lineage.py``: a
seeded Pango tree, the nucleotide segment and all 12 genes at reduced
lengths, 8 lineage partitions) against the plain reference
(``benchmark/reference/lineage.py``): nucleotide and amino-acid Mutations
under PangoLineage and DateBetween through ``Database.execute_query``, on
the dense bank, on the two-tier bank and on the host path; and the
Mutations spans and counters of ``lapis_silo_torch.tracing`` and the
device engine."""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import lapis_silo_torch
from benchmark import lineage
from benchmark.reference.compare import agrees
from lapis_silo_torch import tracing
from lapis_silo_torch.common.symbols import AMINO_ACID, NUCLEOTIDE
from lapis_silo_torch.ops import bitset, kernels
from lapis_silo_torch.ops.device_engine import DeviceEngine
from lapis_silo_torch.query.engine import Query, QueryEngine

CPU = torch.device("cpu")
FOREVER = (0, 2 ** 63 - 1)
SEED = 2 ** 31 + 21


def _config() -> dict:
    config = json.loads((Path(lineage.__file__).parent / "configs"
                         / "lineage1m.json").read_text())
    config.update(
        n_sequences=3000, max_partitions=8,
        nucleotide_segments={"main": 1500},
        genes={name: max(8, length // 25)
               for name, length in config["genes"].items()})
    config["lineages"] = dict(config["lineages"], count=160)
    return config


@pytest.fixture(scope="module")
def corpus():
    return lineage.draw_for(_config(), SEED)


@pytest.fixture(scope="module")
def reference(corpus):
    return lineage.reference_for(corpus)


@pytest.fixture(scope="module")
def served(corpus):
    """The corpus served three ways: the dense bank, the two-tier bank
    (every row of a flat word or more sparse where no partition holds it as
    its majority) and the host alone."""
    out = {}
    db = lineage.build_database(corpus)
    lapis_silo_torch.install(db, CPU)
    out["dense"] = db
    db = lineage.build_database(corpus)
    engine = DeviceEngine(db, CPU, sparse_min_words=1)
    db.device_engine = engine
    db._engine = QueryEngine(db, engine)
    out["two_tier"] = db
    db = lineage.build_database(corpus)
    db.device_engine = None
    db._engine = QueryEngine(db, None, use_device=False)
    out["host"] = db
    return out


def _majority_lineage(corpus) -> int:
    """A lineage of a partition whose implicit symbol differs from the
    reference's at some position of main: one whose own path makes it."""
    main = corpus.segment("main")
    for p in range(corpus.n_partitions):
        rows = lineage.stored_rows(corpus, p, main)
        moved = np.flatnonzero(rows.majority != main.reference)
        if len(moved):
            lo, hi = corpus.bounds[p], corpus.bounds[p + 1]
            values, counts = np.unique(corpus.lineage[lo:hi],
                                       return_counts=True)
            return int(values[np.argmax(counts)])
    raise AssertionError("no partition holds another majority")


def _filter(corpus, case: str) -> dict:
    tree = corpus.tree
    aliased = next(i for i, name in enumerate(tree.names)
                   if name != tree.unaliased[i]
                   and corpus.lineage.tolist().count(i) > 3)
    first, last = corpus.date_text(0), corpus.date_text(corpus.n_days - 1)
    value, sub = tree.names[aliased], True
    if case == "unaliased":
        value = tree.unaliased[aliased]
    elif case == "exact":
        sub = False
    elif case == "majority":
        value = tree.names[_majority_lineage(corpus)]
    newest = int(corpus.day.max())
    if case == "newest":
        value = "B"
        first, last = corpus.date_text(newest - 90), corpus.date_text(newest)
    return {"type": "And", "children": [
        {"type": "PangoLineage", "column": "pangoLineage", "value": value,
         "includeSublineages": sub},
        {"type": "DateBetween", "column": "date", "from": first,
         "to": last}]}


def _query(action: str, proportion: float, expression: dict) -> str:
    return json.dumps({"action": {"type": action,
                                  "minProportion": proportion},
                       "filterExpression": expression})


def test_the_corpus_has_partition_majorities_aliases_and_both_tiers(
        corpus, served):
    main = corpus.segment("main")
    moved = [p for p in range(corpus.n_partitions)
             if (lineage.stored_rows(corpus, p, main).majority
                 != main.reference).any()]
    assert moved
    assert corpus.n_partitions == 8 and corpus.tree.alias_key
    engine = served["two_tier"].device_engine
    assert engine.n_rows > 1 and engine.n_sparse > 0
    assert served["dense"].device_engine.n_sparse == 0


@pytest.mark.parametrize("case", ["aliased", "unaliased", "exact", "newest",
                                  "majority"])
@pytest.mark.parametrize("proportion", [0, 0.05, 1])
@pytest.mark.parametrize("action", ["Mutations", "AminoAcidMutations"])
@pytest.mark.parametrize("path", ["dense", "two_tier", "host"])
def test_mutations_equal_the_reference(corpus, reference, served, path,
                                       action, proportion, case):
    query = _query(action, proportion, _filter(corpus, case))
    want = reference.answer(query)
    assert want or proportion == 1, query
    got = served[path].execute_query(query)
    assert agrees(reference, query, got), (query, got["queryResult"][:5],
                                          want[:5])


@pytest.mark.parametrize("case", ["aliased", "newest", "majority"])
@pytest.mark.parametrize("kind", ["nuc", "aa"])
@pytest.mark.parametrize("path", ["dense", "two_tier"])
def test_mutation_counts_many_equal_the_reference_counts(
        corpus, reference, served, path, kind, case):
    """The engine's per (symbol, position) counts of every segment of the
    alphabet, the sparse rows' from K3 over the partitions the filter
    reaches, equal the reference's counts of each symbol that is neither
    the reference's nor the missing one."""
    engine = served[path].device_engine
    expression = _filter(corpus, case)
    filt = engine.device_filter(Query(_query(
        "Mutations", 0.05, expression)).filter)
    segments = [s for s in corpus.segments if s.kind == kind]
    got = engine.mutation_counts_many(kind, [s.name for s in segments], filt)
    selected = reference.select(expression)
    port = {"nuc": NUCLEOTIDE, "aa": AMINO_ACID}[kind]
    mutated = 0
    for segment in segments:
        want, _ = reference.counts(segment.name, selected)
        ids = [port.char_to_id[c] for c in segment.chars]
        symbols = np.arange(len(segment.chars))
        mask = ((symbols[None, :] != segment.reference[:, None])
                & (symbols[None, :] != lineage.MISSING[kind]))
        np.testing.assert_array_equal(got[segment.name][ids].T[mask],
                                      want[mask])
        mutated += int((want[mask] > 0).sum())
    assert mutated


@pytest.mark.parametrize("case", ["aliased", "newest", "majority"])
@pytest.mark.parametrize("kind", ["nuc", "aa"])
def test_sparse_entries_read_are_the_reached_partitions_alphabet_entries(
        corpus, served, kind, case):
    """K3's entries-read counter advances by the stream entries of the
    alphabet's sparse rows in the partitions where the filter has a set
    bit, counted with numpy from the engine's [L, P] bounds."""
    engine = served["two_tier"].device_engine
    filt = engine.device_filter(Query(_query(
        "Mutations", 0.05, _filter(corpus, case))).filter)
    words = np.concatenate([part.cpu().numpy() for part in filt.parts])
    reached = words.reshape(engine.n_partitions, engine.n_words).any(axis=1)
    _, row_base, n_rows = engine._sparse_alphabets[kind]
    lens = engine.sparse_lengths_pp[row_base:row_base + n_rows]
    want = int(lens[:, reached].sum())
    assert 0 < reached.sum() < engine.n_partitions or case == "newest"
    assert 0 < want < int(engine.sparse_lengths_pp.sum())
    names = sorted(engine.db.nuc_sequences if kind == "nuc"
                   else engine.db.aa_sequences)
    before = (engine.mutation_sparse_entries_read,
              engine.mutation_sparse_launches)
    engine.mutation_counts_many(kind, names, filt)
    assert engine.mutation_sparse_entries_read == before[0] + want
    assert engine.mutation_sparse_launches == before[1] + 1


@pytest.mark.parametrize("action,kind", [("Mutations", "nuc"),
                                         ("AminoAcidMutations", "aa")])
@pytest.mark.parametrize("path", ["dense", "two_tier"])
def test_dense_words_read_are_the_reached_partitions_own_words(
        corpus, reference, served, path, action, kind):
    """A lineage filter's Mutations equal the reference while K2 reads, in
    one launch over the alphabet's dense rows, only the own words of the
    partitions where the filter has a set bit: its words-read counter
    advances by the rows times those words, counted with numpy, below the
    rows times the flat words."""
    db = served[path]
    engine = db.device_engine
    query = _query(action, 0.05, _filter(corpus, "aliased"))
    before = (engine.mutation_dense_rows, engine.mutation_dense_words_read,
              kernels.MUTATION_COUNTS.plain_launches)
    got = db.execute_query(query)
    assert agrees(reference, query, got), (query, got["queryResult"][:5])
    rows = engine.mutation_dense_rows - before[0]
    read = engine.mutation_dense_words_read - before[1]
    assert rows == sum(meta["n_stored"] for (k, _), meta
                       in engine.segment_meta.items() if k == kind)
    assert kernels.MUTATION_COUNTS.plain_launches == before[2] + 1
    filt = engine.device_filter(Query(query).filter)
    words = np.concatenate([part.numpy() for part in filt.parts])
    reached = words.reshape(engine.n_partitions, engine.n_words).any(axis=1)
    own = sum(bitset.words_for(n) for n, hit
              in zip(engine.part_rows, reached) if hit)
    assert 0 < reached.sum() < engine.n_partitions
    assert 0 < read == rows * own < rows * engine.n_flat_words


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sparse_min_words", [None, 1])
def test_mutations_on_the_card_equal_the_reference(corpus, reference, served,
                                                   cuda_device,
                                                   sparse_min_words):
    """The dense and the two-tier bank on the card: K2's one launch per
    alphabet and K3 answer both alphabets as the reference does, and K2's
    words read equal the CPU engine's for the same filter."""
    db = lineage.build_database(corpus)
    engine = DeviceEngine(db, cuda_device, sparse_min_words=sparse_min_words)
    db.device_engine, db._engine = engine, QueryEngine(db, engine)
    cpu = served["dense" if sparse_min_words is None else "two_tier"]
    for action in ("Mutations", "AminoAcidMutations"):
        for case in ("aliased", "newest", "majority"):
            query = _query(action, 0.05, _filter(corpus, case))
            launches = kernels.MUTATION_COUNTS.launches
            read = (engine.mutation_dense_words_read,
                    cpu.device_engine.mutation_dense_words_read)
            got = db.execute_query(query)
            assert agrees(reference, query, got), (query,
                                                   got["queryResult"][:5])
            assert kernels.MUTATION_COUNTS.launches == launches + 1
            cpu.execute_query(query)
            assert (engine.mutation_dense_words_read - read[0]
                    == cpu.device_engine.mutation_dense_words_read - read[1])


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


@pytest.mark.parametrize("action,kind", [("Mutations", "nuc"),
                                         ("AminoAcidMutations", "aa")])
def test_a_traced_mutations_query_records_its_spans_and_counters(
        corpus, served, recorder, action, kind):
    db = served["two_tier"]
    engine = db.device_engine
    query = _query(action, 0.05, _filter(corpus, "aliased"))
    before = (dict(engine.mutation_queries), engine.mutation_dense_rows,
              engine.mutation_sparse_rows, engine.mutation_sparse_launches)
    tracing.PERFORMANCE_LOGGER.setLevel(logging.INFO)
    db.execute_query(query)
    rows = recorder.spans(*FOREVER)
    (request,) = _by_name(rows, "request")["id"]
    filt, reduce_, assemble = (_by_name(rows, name) for name in (
        "mutations.filter", "mutations.reduce", "mutations.assemble"))
    for spans in (filt, reduce_, assemble):
        assert len(spans["id"]) == 1
        assert spans["end"][0] >= spans["start"][0]
    # the filter and the action under the request, the reduction under the
    # action and inside it
    assert filt["parent"][0] == assemble["parent"][0] == request
    assert reduce_["parent"][0] == assemble["id"][0]
    assert filt["end"][0] <= assemble["start"][0] <= reduce_["start"][0]
    assert reduce_["end"][0] <= assemble["end"][0]
    dense = sum(meta["n_stored"] for (k, _), meta
                in engine.segment_meta.items() if k == kind)
    assert engine.mutation_queries[kind] == before[0][kind] + 1
    assert engine.mutation_dense_rows == before[1] + dense
    # K3 answered the rows of the query's alphabet only
    _, _, n_kind = engine._sparse_alphabets[kind]
    assert 0 < n_kind < engine.n_sparse
    assert engine.mutation_sparse_rows == before[2] + n_kind
    assert engine.mutation_sparse_launches == before[3] + 1


def test_the_counters_advance_only_by_the_kernels_launched(corpus, served):
    """A second reduction against the same filter takes K3's counts from
    its memo: K2 launches again and counts, K3 does not."""
    db = served["two_tier"]
    engine = db.device_engine
    filt = engine.device_filter(Query(_query(
        "AminoAcidMutations", 0.05, _filter(corpus, "aliased"))).filter)
    names = sorted(db.aa_sequences)
    engine.mutation_counts_many("aa", names, filt)
    before = (engine.mutation_queries["aa"], engine.mutation_dense_rows,
              engine.mutation_sparse_rows, engine.mutation_sparse_launches,
              engine.mutation_sparse_entries_read)
    engine.mutation_counts_many("aa", names, filt)
    dense = sum(meta["n_stored"] for (k, _), meta
                in engine.segment_meta.items() if k == "aa")
    assert dense
    assert engine.mutation_queries["aa"] == before[0] + 1
    assert engine.mutation_dense_rows == before[1] + dense
    assert engine.mutation_sparse_rows == before[2]
    assert engine.mutation_sparse_launches == before[3]
    assert engine.mutation_sparse_entries_read == before[4]


def test_untraced_mutations_record_nothing_and_counts_keep_their_spans(
        corpus, served, recorder):
    db = served["dense"]
    tracing.PERFORMANCE_LOGGER.setLevel(logging.WARNING)
    db.execute_query(_query("Mutations", 0.05, _filter(corpus, "aliased")))
    assert len(recorder.spans(*FOREVER)["id"]) == 0
    tracing.PERFORMANCE_LOGGER.setLevel(logging.INFO)
    db.execute_query(json.dumps({"action": {"type": "Aggregated"},
                                 "filterExpression": _filter(corpus,
                                                             "aliased")}))
    names = {tracing.NAMES[i] for i in recorder.spans(*FOREVER)["name"]}
    assert names - {"gc"} == {"request", "parse", "batcher.enqueue",
                              "batcher.wait", "batcher.wake", "batch",
                              "batch.lower", "batch.count", "batch.readback"}
