"""The port's own host layers (storage, query language, actions, synthetic
corpora) against the JAX package's.

The port imports neither ``jax`` nor ``lapis_silo_tpu``: no import statement
under ``lapis_silo_torch/`` or in ``chip_smoke.py`` names them, and a process
that serves counts and Mutations from the port never loads them. From one
seed, both packages' ``synthetic_database`` build the same partitions, row
counts and (symbol, position) bitmaps, and both host engines
(``use_device=False``) answer Aggregated, Mutations and Details equally.
Every value is an integer, a string or a packed word: the tolerance is
equality."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lapis_silo_tpu import testing as ref_testing
from lapis_silo_tpu.query.engine import QueryEngine as RefQueryEngine
from lapis_silo_torch import testing
from lapis_silo_torch.query.engine import QueryEngine

REPO = Path(__file__).resolve().parents[1]
BANNED = ("jax", "lapis_silo_tpu")
CORPORA = [dict(n_rows=700, length=180, n_partitions=3, seed=5),
           dict(n_rows=999, length=333, n_partitions=2, seed=7, rich=True)]


def _banned_imports(path: Path) -> list[str]:
    """`file:line module` for every import of a banned module in the file,
    at any depth (lazy imports inside functions included)."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [f"{path.relative_to(REPO)}:{node.lineno} {name}"
                  for name in names
                  if name.split(".")[0] in BANNED]
    return found


@pytest.mark.parametrize("root", ["lapis_silo_torch", "chip_smoke.py"])
def test_port_imports_neither_jax_nor_the_jax_package(root):
    path = REPO / root
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert len(files) > (20 if path.is_dir() else 0)
    assert [hit for f in files for hit in _banned_imports(f)] == []


def test_serving_from_the_port_loads_no_jax_module():
    """A fresh process builds the port's corpus, installs the port on the
    CPU, answers counts and a Mutations query equal to its host oracle, and
    has loaded no module of jax* or lapis_silo_tpu*."""
    script = """
import json, sys, torch
import lapis_silo_torch
from lapis_silo_torch.query.engine import QueryEngine
from lapis_silo_torch.testing import sample_count_queries, synthetic_database
db = synthetic_database(600, 150, n_partitions=2, seed=3)
queries = sample_count_queries(db, 6, seed=2) + [json.dumps({
    "action": {"type": "Mutations", "minProportion": 0.0},
    "filterExpression": {"type": "HasNucleotideMutation", "position": 40}})]
want = [QueryEngine(db, use_device=False).execute(q) for q in queries]
lapis_silo_torch.install(db, torch.device("cpu"))
assert [db.execute_query(q) for q in queries] == want
assert db._engine._use_device
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib",
                                                "lapis_silo_tpu"))))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    done = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert json.loads(done.stdout.strip().splitlines()[-1]) == []


@pytest.fixture(scope="module", params=range(len(CORPORA)))
def pair(request):
    corpus = CORPORA[request.param]
    return (ref_testing.synthetic_database(**corpus),
            testing.synthetic_database(**corpus))


def test_synthetic_corpora_are_equal(pair):
    ref, port = pair
    assert type(port).__module__.startswith("lapis_silo_torch.")
    assert [p.sequence_count for p in port.partitions] == [
        p.sequence_count for p in ref.partitions]
    assert sorted(port.nuc_sequences) == sorted(ref.nuc_sequences)
    assert sorted(port.aa_sequences) == sorted(ref.aa_sequences)
    n_planes = 0
    for ref_part, port_part in zip(ref.partitions, port.partitions,
                                   strict=True):
        for kind in ("nuc_sequences", "aa_sequences"):
            ref_segs = getattr(ref_part, kind)
            port_segs = getattr(port_part, kind)
            assert sorted(port_segs) == sorted(ref_segs)
            for name, want in ref_segs.items():
                got = port_segs[name]
                assert got.n_rows == want.n_rows == ref_part.sequence_count
                for field in ("majority", "sym_ids", "pos_ids", "row_map",
                              "counts"):
                    np.testing.assert_array_equal(getattr(got, field),
                                                  getattr(want, field))
                for sym in range(want.alphabet.count):
                    for pos in range(want.length):
                        np.testing.assert_array_equal(got.plane(sym, pos),
                                                      want.plane(sym, pos))
                        n_planes += 1
    assert n_planes > 1000


def test_sample_queries_are_equal(pair):
    ref, port = pair
    assert testing.sample_count_queries(port, 32, seed=4) == (
        ref_testing.sample_count_queries(ref, 32, seed=4))
    positions = np.arange(0, 150, 11)
    assert testing.hot_count_queries(port, positions, 16, seed=6) == (
        ref_testing.hot_count_queries(ref, positions, 16, seed=6))


@pytest.mark.parametrize("action", [
    {"type": "Aggregated"},
    {"type": "Aggregated", "groupByFields": ["country"]},
    {"type": "Mutations", "minProportion": 0.05},
    {"type": "Mutations", "minProportion": 0.0},
    {"type": "Details", "fields": ["key", "age", "country"],
     "orderByFields": ["key"]},
])
def test_host_engines_answer_equally(pair, action):
    ref, port = pair
    queries = [json.dumps({"action": action,
                           "filterExpression": json.loads(q)[
                               "filterExpression"]})
               for q in testing.sample_count_queries(port, 12, seed=9)]
    ref_engine = RefQueryEngine(ref, use_device=False)
    port_engine = QueryEngine(port, use_device=False)
    answered = 0
    for query in queries:
        want = ref_engine.execute(query)
        assert port_engine.execute(query) == want, query
        answered += bool(want["queryResult"])
    assert answered >= len(queries) // 2
