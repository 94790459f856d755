"""A per-layer metric of the program's counters comes as a reader file: the
reader names the counters it reads (``counters(engine)``), and the run
snapshots them at the window's open and close with no other file changed."""

import shutil

import pytest
import torch

from benchmark import run

CPU = torch.device("cpu")
SMALL = {"config": {"n_sequences": 6000, "sequence_length": 800},
         "mix": {"prefetch_per_s": 400, "warmup_requests": 32,
                 "loop": {"kind": "closed", "clients": 8}}}
READER = '''
def counters(engine):
    return {"{name}": engine.{name}}


def read(run):
    return run.counter("{name}")
'''
NAMES = ("lowered_once", "lowered_per_partition")


def _spec_with_readers(tmp_path) -> dict:
    """The metrics directory copied to `tmp_path` with the two new readers,
    and the spec with their per-layer entries in place of the others."""
    shutil.copytree(run.METRICS_DIR, tmp_path, dirs_exist_ok=True)
    for name in NAMES:
        (tmp_path / f"{name}.py").write_text(
            READER.replace("{name}", name))
    spec = run.load_spec()
    spec["per_layer"] = [
        {"name": name, "unit": "lowerings", "better": "lower",
         "source": "program_counter", "layer": "lowering",
         "moves": "card_us_per_query", "workloads": ["dense1m.counts"]}
        for name in NAMES]
    return spec


def test_a_reader_file_gets_the_counters_it_names(tmp_path, monkeypatch,
                                                  capsys):
    spec = _spec_with_readers(tmp_path)
    monkeypatch.setattr(run, "METRICS_DIR", tmp_path)
    result = run.run_cell("dense1m.counts", 43, 1.0, True, CPU,
                          overrides=SMALL, spec=spec)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert set(metrics) == set(NAMES)
    # every count of the mix is partition-free and never sent twice: each
    # lowers once, in one partition
    assert 0 < metrics["lowered_once"]["value"] <= result["attempted"]
    assert metrics["lowered_per_partition"]["value"] == 0
    err = capsys.readouterr().err
    assert f"counter lowered_once: {metrics['lowered_once']['value']}" in err


@pytest.mark.parametrize("trace", [False, True])
def test_only_the_run_readers_add_probes(tmp_path, monkeypatch, trace):
    """An untraced run reads the end-to-end metrics, which read no program
    counter: it snapshots only the counters every run logs."""
    spec = _spec_with_readers(tmp_path)
    monkeypatch.setattr(run, "METRICS_DIR", tmp_path)
    probes = run.counter_probes(spec, "dense1m.counts", trace)
    assert len(probes) == (len(NAMES) if trace else 0)
    assert run.counter_probes(spec, "twotier2m.hot", trace) == []
