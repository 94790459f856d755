"""BENCHMARK.json names files that exist, and each cell reports what its
metrics need: the harness finds configurations, mixes and metric readers by
name."""

import json
import re
from pathlib import Path

from benchmark.run import CORPUS_CONTRACT, corpus_module, metric_entries

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_resolves_to_a_file():
    for config in SPEC["configs"]:
        data = json.loads((ROOT / config["file"]).read_text())
        assert data["name"] == config["name"]
        assert set(config["reduced"]) <= set(data["reduced"])
        if data["corpus"] == "benchmark.corpus":  # the keys its draw_for reads
            for key in ("n_sequences", "sequence_length", "n_partitions",
                        "mutations_per_genome"):
                assert isinstance(data[key], int)
    for cell in SPEC["workloads"]:
        assert NAME.match(cell["name"])
        assert (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json"
                ).exists()
        assert cell["config"] in {c["name"] for c in SPEC["configs"]}
    for metric in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(metric["name"])
        assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py"
                ).exists()


def test_every_configuration_names_a_benchmark_corpus_module():
    for config in SPEC["configs"]:
        data = json.loads((ROOT / config["file"]).read_text())
        assert data["corpus"].startswith("benchmark."), config["name"]
        module = corpus_module(data)
        assert module.__name__ == data["corpus"]
        for name in CORPUS_CONTRACT:
            assert callable(getattr(module, name)), (config["name"], name)


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    end_to_end = {m["name"] for m in SPEC["end_to_end"]}
    for cell in SPEC["workloads"]:
        reported = {m["name"] for m in metric_entries(SPEC, cell["name"],
                                                      False)}
        assert "setup_s" in reported and len(reported) >= 2
        layers = metric_entries(SPEC, cell["name"], True)
        assert layers
        for metric in layers:
            assert metric["moves"] in end_to_end
            assert metric["moves"] in reported, (cell["name"], metric)


def test_bounds_and_window():
    for metric in SPEC["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
