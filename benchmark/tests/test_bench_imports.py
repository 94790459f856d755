"""Nothing the harness runs imports JAX or the JAX package; the reference
imports nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "lapis_silo_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of the modules a file imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _harness_files():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_harness_sources_import_no_jax():
    for path in _harness_files():
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        names = _imports(path)
        assert names <= {"__future__", "json", "math", "numpy"}, (path, names)


SCRIPT = """
import json, os, sys, torch
sys.path.insert(0, {root!r})
os.environ["SILO_DENSE_BANK_BUDGET_GB"] = "0.00001"
os.environ["SILO_LEAF_POOL_GB"] = "0.01"
from benchmark import run
small = {{"config": {{"n_sequences": 16384, "sequence_length": 1000,
                      "n_partitions": 2, "mutations_per_genome": 2}},
          "mix": {{"prefetch_per_s": 400, "warmup_requests": 32,
                   "loop": {{"kind": "closed", "clients": 4}},
                   "positions": {{"kind": "fixed_set", "size": 32}}}}}}
for trace in (False, True):
    result = run.run_cell("twotier2m.hot", 3, 0.5, trace, torch.device("cpu"),
                          overrides=small)
    assert result["correct"], result
counts = {{"config": {{"n_sequences": 4096, "sequence_length": 500}},
           "mix": {{"prefetch_per_s": 400, "warmup_requests": 16,
                    "loop": {{"kind": "closed", "clients": 4}}}}}}
assert run.run_cell("dense1m.counts", 4, 0.5, True, torch.device("cpu"),
                    overrides=counts)["correct"]
print(json.dumps(sorted({{name.split(".")[0] for name in sys.modules}})))
"""


def test_a_run_loads_no_jax():
    """Compared by whole top-level names: the port's name begins with the
    JAX package's, and is no match."""
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "lapis_silo_torch" in loaded
    assert not loaded & FORBIDDEN


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dense1m.counts",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT / "build")})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
