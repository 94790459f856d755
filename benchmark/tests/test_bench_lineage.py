"""The lineage deployment (``benchmark/lineage.py``) as the harness uses it:
the corpus module honours the contract, a small run of
``lineage1m.mutations`` is correct and the control fails it, the
generator's requests, and the least bytes of ``mutations_roofline_pct``
on a corpus built by hand."""

import datetime
import json

import numpy as np
import pytest
import torch

from benchmark import control, lineage, run
from benchmark.reference.compare import agrees
from benchmark.roofline_mutations import least_bytes, query_bytes

CPU = torch.device("cpu")
CELL = "lineage1m.mutations"


def _small() -> dict:
    config, _ = run.cell_files(run.load_spec(), CELL)
    return {"config": {
        "n_sequences": 4096, "max_partitions": 8,
        "nucleotide_segments": {"main": 900},
        "genes": {name: max(8, length // 30)
                  for name, length in config["genes"].items()},
        "lineages": dict(config["lineages"], count=150)},
        "mix": {"warmup_requests": 8, "prefetch_per_s": 60,
                "loop": {"kind": "closed", "clients": 4}}}


def test_the_configuration_names_this_module_of_the_contract():
    config, mix = run.cell_files(run.load_spec(), CELL)
    assert run.corpus_module(config) is lineage
    for name in run.CORPUS_CONTRACT:
        assert callable(getattr(lineage, name))
    assert config["n_sequences"] == 524288 and len(config["genes"]) == 12
    assert mix["warmup_requests"] == 256
    assert mix["check"] == {"nucleotide": 128, "amino_acid": 128}


def test_a_small_run_is_correct_and_the_control_fails_it():
    small = _small()
    result = run.run_cell(CELL, 2 ** 31 + 5, 1.5, True, CPU, overrides=small)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    metrics = result["metrics"]
    for name in ("mutations_filter_ms", "mutations_reduce_ms",
                 "mutations_assemble_ms", "mutations_sparse_word_pct",
                 "qps.mutations", "parse_us.mutations",
                 "gc_pause_pct.mutations",
                 "request_uncovered_pct.mutations"):
        assert name in metrics, name
    for name in ("mutations_sparse_word_pct", "gc_pause_pct.mutations",
                 "request_uncovered_pct.mutations"):
        assert 0 <= metrics[name]["value"] <= 100, name
    # the action's own time, without the reduction under it
    assert metrics["mutations_assemble_ms"]["value"] > 0
    checks = control.readings(CELL, 2 ** 31 + 5, 1.5, small)
    assert checks["wrong_answers"][0] > 0


def test_the_generator_alternates_kinds_and_sends_no_request_twice():
    config, mix = run.cell_files(run.load_spec(), CELL, _small())
    corpus = lineage.draw_for(config, 2 ** 31 + 9)
    generator = lineage.generator_for(mix, corpus, 2 ** 31 + 9)
    stream = generator.stream(chunk=64)
    stream.prefetch(300)
    window = [stream[i] for i in range(300)]
    warm = generator.requests(mix["warmup_requests"], stream=2)
    bodies = [r.body for r in window]
    assert len(set(bodies)) == len(bodies)
    assert not set(bodies) & {r.body for r in warm}
    assert [r.kind for r in window] == ["nucleotide", "amino_acid"] * 150
    reference = lineage.reference_for(corpus)
    newest = corpus.date_text(int(corpus.day.max()))
    ends = 0
    for r in window:
        data = json.loads(r.body)
        chosen = int(reference.select(data["filterExpression"]).sum())
        assert 0 < chosen < corpus.n_rows, r.body
        ends += data["filterExpression"]["children"][1]["to"] == newest
        assert data["action"]["minProportion"] == 0.05
    assert ends >= len(window) // 2
    # the same seed draws the same requests afresh
    again = lineage.generator_for(mix, corpus, 2 ** 31 + 9).stream(chunk=64)
    assert [again[i].body for i in range(300)] == bodies


def test_the_sparse_share_counts_the_words_each_kernel_read():
    """A reduction on the two-tier bank: K2 reads every flat word of the
    alphabet's dense rows, K3 every entry of the stream."""
    from lapis_silo_torch.ops.device_engine import DeviceEngine
    from lapis_silo_torch.query.engine import QueryEngine
    config, mix = run.cell_files(run.load_spec(), CELL, _small())
    corpus = lineage.draw_for(config, 2 ** 31 + 11)
    db = lineage.build_database(corpus)
    engine = DeviceEngine(db, CPU, sparse_min_words=1)
    db.device_engine, db._engine = engine, QueryEngine(db, engine)
    reader = run.metric_module("mutations_sparse_word_pct")
    body = lineage.generator_for(mix, corpus, 2 ** 31 + 11).requests(2)[1]
    assert body.kind == "amino_acid"
    before = reader.counters(engine)
    db.execute_query(body.body)
    after = reader.counters(engine)
    dense = sum(meta["n_stored"] for (kind, _), meta
                in engine.segment_meta.items() if kind == "aa")
    assert dense and engine.n_sparse
    assert (after["mutation_dense_words"] - before["mutation_dense_words"]
            == dense * engine.n_flat_words)
    assert (after["mutation_sparse_entries"]
            - before["mutation_sparse_entries"]
            == engine.sparse_idx.shape[0])


def _hand_corpus():
    """Two partitions by hand: 33 genomes of A.1 (two words), then 3 of A.1
    and 7 of A; main ACGT, gene S AC. A.1 carries main 1G and S 2D;
    genome 2 a private 4A, genome 40 a private 1C; genome 34 N over main
    2-3, genome 0 X over S 1-2."""
    tree = lineage.Tree(
        unaliased=["A", "A.1"], names=["A", "A.1"],
        parent=np.array([-1, 0]), alias_key={},
        start=np.array([0, 0]), end=np.array([9, 9]),
        genomes=np.array([7, 36]), n_nuc=np.array([0, 1]),
        aa_genes=[np.array([], np.int64), np.array([0])])
    main = lineage.Segment("nuc", "main", np.array([1, 2, 3, 4], np.uint8))
    gene = lineage.Segment("aa", "S", np.array([1, 2], np.uint8))
    i64 = lambda *v: np.array(v, dtype=np.int64)  # noqa: E731
    u8 = lambda *v: np.array(v, dtype=np.uint8)  # noqa: E731
    lineage_of = np.array([1] * 36 + [0] * 7, dtype=np.int32)
    return lineage.Corpus(
        [main, gene], tree, datetime.date(2021, 1, 1), 10, ["X"],
        i64(0, 33, 43), lineage_of, np.zeros(43, np.int32),
        np.zeros(43, np.int8),
        paths={"main": (i64(1), i64(0), u8(3)), "S": (i64(1), i64(1), u8(3))},
        private={"main": (i64(2, 40), i64(3, 0), u8(1, 2), u8(4, 1)),
                 "S": (i64(), i64(), u8(), u8())},
        runs={"main": (i64(34), i64(1), i64(3)),
              "S": (i64(0), i64(0), i64(2))})


def test_the_least_bytes_of_a_hand_built_corpus_equal_a_count_by_hand():
    corpus = _hand_corpus()
    # partition 0: main 1G is the majority and 1A holds no genome; 4A of
    # genome 2 (1 word). S: 1X and 2X of genome 0 (1 word each); 2D the
    # majority, 2C empty. Partition 1 (one word): main 1G, 1C, 2N, 3N;
    # S 2D. The filter: 2 + 1 words.
    assert least_bytes(corpus) == {"nuc": 4 * 5 + 4 * 3, "aa": 4 * 3 + 4 * 3}
    rows = lineage.stored_rows(corpus, 0, corpus.segment("main"))
    assert rows.majority.tolist() == [3, 2, 3, 4]
    assert list(zip(rows.positions.tolist(), rows.symbols.tolist())) == [
        (3, 1)]
    db = lineage.build_database(corpus)
    assert db.least_mutation_bytes == least_bytes(corpus)
    assert query_bytes({"nuc": 0}, corpus) == {"nuc": 12}


@pytest.mark.parametrize("action", ["Mutations", "AminoAcidMutations"])
def test_the_port_answers_the_hand_built_corpus_as_the_reference(action):
    import lapis_silo_torch
    corpus = _hand_corpus()
    db = lineage.build_database(corpus)
    lapis_silo_torch.install(db, CPU)
    reference = lineage.reference_for(corpus)
    for value, sub in (("A", True), ("A.1", False), ("A", False)):
        query = json.dumps({"action": {"type": action, "minProportion": 0},
                            "filterExpression": {
                                "type": "PangoLineage",
                                "column": "pangoLineage", "value": value,
                                "includeSublineages": sub}})
        assert agrees(reference, query, db.execute_query(query)), query
