"""The configuration names the module that draws its corpus, its traffic
and its reference, and the harness calls nothing else on it: a module of
the contract drives a whole run and the control; a configuration that
names none, or one outside ``benchmark.``, is refused before any set-up;
``benchmark.corpus`` gives what the harness built directly before."""

import json

import numpy as np
import pytest
import torch

from benchmark import control, corpus, run
from benchmark.reference.silo import Reference
from benchmark.tests import counting_corpus
from benchmark.traffic.generator import Generator

CPU = torch.device("cpu")
COUNTING = "benchmark.tests.counting_corpus"
SMALL = {
    "dense1m.counts": {
        "config": {"n_sequences": 6000, "sequence_length": 800},
        "mix": {"prefetch_per_s": 400, "warmup_requests": 32,
                "loop": {"kind": "closed", "clients": 8}}},
    "twotier2m.hot": {
        "config": {"n_sequences": 16384, "sequence_length": 1000,
                   "n_partitions": 2, "mutations_per_genome": 2},
        "mix": {"prefetch_per_s": 400, "warmup_requests": 32,
                "loop": {"kind": "closed", "clients": 8},
                "positions": {"kind": "fixed_set", "size": 48}}},
}


def _named(cell: str, module: str) -> dict:
    small = SMALL[cell]
    return {"config": dict(small["config"], corpus=module), "mix": small["mix"]}


def test_a_module_of_the_contract_drives_a_run_and_the_control():
    calls = counting_corpus.CALLS
    calls.clear()
    overrides = _named("dense1m.counts", COUNTING)
    result = run.run_cell("dense1m.counts", 31, 1.0, False, CPU,
                          overrides=overrides)
    assert result["correct"], result["checks"]
    assert dict(calls) == {"draw_for": 1, "build_database": 1,
                           "generator_for": 1, "reference_for": 1}
    checks = control.readings("dense1m.counts", 37, 1.0, overrides)
    assert checks["wrong_answers"][0] > 0
    assert set(calls) == set(run.CORPUS_CONTRACT)
    assert calls["stale_reference_for"] == 1 and calls["draw_for"] == 2


def _spec_without_corpus(tmp_path) -> dict:
    spec = run.load_spec()
    entry = next(c for c in spec["configs"] if c["name"] == "dense1m")
    data = json.loads((run.ROOT / entry["file"]).read_text())
    del data["corpus"]
    path = tmp_path / "dense1m.json"
    path.write_text(json.dumps(data))
    configs = [dict(c, file=str(path)) if c is entry else c
               for c in spec["configs"]]
    return dict(spec, configs=configs)


@pytest.mark.parametrize("how", ["missing", "os", "benchmark.nothing_here"])
def test_a_configuration_without_a_benchmark_corpus_is_refused_first(
        how, tmp_path, monkeypatch):
    def drawn(*args, **kwargs):
        raise AssertionError("the corpus was drawn")
    monkeypatch.setattr(corpus, "draw", drawn)
    monkeypatch.setattr(corpus, "draw_for", drawn)
    if how == "missing":
        spec, overrides = _spec_without_corpus(tmp_path), SMALL["dense1m.counts"]
    else:
        spec, overrides = run.load_spec(), _named("dense1m.counts", how)
    for start in (lambda: run.run_cell("dense1m.counts", 3, 1.0, False, CPU,
                                       overrides=overrides, spec=spec),
                  lambda: control.readings("dense1m.counts", 3, 1.0,
                                           overrides, spec)):
        with pytest.raises(SystemExit) as refused:
            start()
        assert "'dense1m'" in str(refused.value)
        assert ("None" if how == "missing" else repr(how)) in str(
            refused.value)


def test_a_module_missing_a_function_of_the_contract_is_refused():
    with pytest.raises(SystemExit, match="lacks draw_for, build_database"):
        run.corpus_module({"name": "x", "corpus": "benchmark.stats"})


@pytest.mark.parametrize("cell", list(SMALL))
def test_the_contract_gives_what_the_harness_built_directly(cell):
    """Seed for seed, the corpus, the requests (the window's, the
    warm-up's and the sweep) and the reference's answers as the harness
    made them before it named a module."""
    seed = 2**31 + 11
    config, mix = run.cell_files(run.load_spec(), cell, SMALL[cell])
    module = run.corpus_module(config)
    assert module is corpus
    drawn = module.draw_for(config, seed)
    direct = corpus.draw(config["n_sequences"], config["sequence_length"],
                         config["n_partitions"],
                         config["mutations_per_genome"], seed)
    assert (drawn.reference == direct.reference).all()
    for a, b in zip(drawn.partitions, direct.partitions, strict=True):
        for name in ("days", "country", "age", "rows", "positions",
                     "symbols", "by_position"):
            assert np.array_equal(getattr(a, name), getattr(b, name)), name
    ours = module.generator_for(mix, drawn, seed)
    theirs = Generator(mix, direct.reference, corpus.COUNTRIES, corpus.YEAR,
                       corpus.MONTH, corpus.N_DAYS, seed)

    def bodies(generator):
        window = generator.stream()
        window.prefetch(300)
        return ([window[i].body for i in range(300)],
                [r.body for r in generator.requests(64, stream=2)],
                [r.body for r in generator.sweep()])
    drawn_bodies = bodies(ours)
    assert drawn_bodies == bodies(theirs)
    reference = module.reference_for(drawn)
    before = Reference(direct, corpus.COUNTRIES, corpus.YEAR, corpus.MONTH)
    for body in drawn_bodies[0][:200] + drawn_bodies[2][:16]:
        assert reference.answer(body) == before.answer(body), body
