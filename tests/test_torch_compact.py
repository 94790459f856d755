"""The port's compact extraction (DeviceEngine.evaluate_compact) against the
JAX package's.

With COMPACT_MIN_WORDS lowered so the small corpora take the path, the
port's ``evaluate_compact`` on 1, 4 and 8 CPU shards equals the JAX
engine's (its fused ``compact:{cap}`` output, lapis_silo_tpu/ops/vm.py:505)
and ``evaluate()``: selective filters below the cap, wide ones that
overflow it (the words are copied instead), the trivial FULL/ZERO filters
and the empty result. ``reductions.compact_nonzero`` is held to the
reference's fixed-size ``jnp.nonzero``, and Details through the query
engine to the JAX engine's answer. Each package serves its own corpus built
from the same seed; every value is a word or an index: the tolerance is
equality. The same on the card is marked `cuda`."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapis_silo_tpu import testing as ref_testing
from lapis_silo_tpu.ops import device_engine as ref_de
from lapis_silo_tpu.query.engine import Query as RefQuery
from lapis_silo_tpu.query.engine import QueryEngine as RefQueryEngine
from lapis_silo_torch.ops import reductions
from lapis_silo_torch.ops.device_engine import DeviceEngine
from lapis_silo_torch.query.engine import Query, QueryEngine
from lapis_silo_torch.testing import synthetic_database

CPU = torch.device("cpu")
CORPUS = dict(n_rows=2048, length=512, n_partitions=3, seed=5)
FILTERS = [
    {"type": "NucleotideEquals", "position": 17, "symbol": "A"},
    {"type": "HasNucleotideMutation", "position": 300},
    {"type": "Not", "child": {"type": "HasNucleotideMutation",
                              "position": 3}},  # wide: overflows small caps
    {"type": "True"},
    {"type": "False"},
    {"type": "And", "children": [
        {"type": "StringEquals", "column": "country", "value": "Spain"},
        {"type": "IntBetween", "column": "age", "from": 10, "to": 30}]},
    {"type": "And", "children": [  # empty
        {"type": "HasNucleotideMutation", "position": 300},
        {"type": "Not", "child": {"type": "HasNucleotideMutation",
                                  "position": 300}}]},
]


def _body(filter_json, action=None):
    return json.dumps({"action": action or {"type": "Aggregated"},
                       "filterExpression": filter_json})


@pytest.fixture(scope="module")
def port_db():
    return synthetic_database(**CORPUS)


@pytest.fixture(scope="module")
def ref_engine():
    return ref_de.DeviceEngine(ref_testing.synthetic_database(**CORPUS),
                               devices=jax.devices()[:1])


@pytest.mark.parametrize("cap", [5, 12, 4, 16384])
@pytest.mark.parametrize("n", [1, 37, 200])
def test_compact_nonzero_matches_fixed_size_nonzero(cap, n):
    rng = np.random.default_rng(cap * n)
    words = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    words[rng.random(n) < 0.6] = 0
    words[n // 2] = 0x80000000  # a word that is negative as int32
    nz = jnp.asarray(words) != 0
    idx = np.asarray(jnp.nonzero(nz, size=cap, fill_value=0)[0])
    block = reductions.compact_nonzero(
        torch.from_numpy(words.view(np.int32)), cap, offset=1000).numpy()
    assert block.shape == (1 + 2 * cap,)
    assert block[0] == int(nz.sum())
    np.testing.assert_array_equal(block[1:1 + cap], idx + 1000)
    np.testing.assert_array_equal(block[1 + cap:].view(np.uint32), words[idx])


@pytest.mark.parametrize("n_shards", [1, 4, 8])
@pytest.mark.parametrize("cap", [8, 40, 16384])
def test_evaluate_compact_matches_jax_and_evaluate(port_db, ref_engine,
                                                   monkeypatch, n_shards, cap):
    engine = DeviceEngine(port_db, CPU,
                          devices=[CPU] * n_shards if n_shards > 1 else None)
    for target in (engine, ref_engine):
        monkeypatch.setattr(target, "COMPACT_MIN_WORDS", 0)
        monkeypatch.setattr(target, "COMPACT_CAP_WORDS", cap)
    calls = []
    compact = reductions.compact_nonzero
    monkeypatch.setattr(reductions, "compact_nonzero",
                        lambda *a: calls.append(a) or compact(*a))
    for filter_json in FILTERS:
        got = engine.evaluate_compact(Query(_body(filter_json)).filter)
        want = ref_engine.evaluate_compact(RefQuery(_body(filter_json)).filter)
        plain = engine.evaluate(Query(_body(filter_json)).filter)
        assert len(got) == len(want) == len(plain) == 3
        for g, w, p in zip(got, want, plain):
            np.testing.assert_array_equal(g, w, err_msg=f"{filter_json}")
            np.testing.assert_array_equal(g, p, err_msg=f"{filter_json}")
    # one extraction per shard for every non-trivial filter
    assert len(calls) == n_shards * (len(FILTERS) - 2)
    assert [a[2] for a in calls[:n_shards]] == list(engine.shards.offsets)


def test_small_corpora_copy_the_bitset(port_db, monkeypatch):
    """Under COMPACT_MIN_WORDS flat words, no extraction runs."""
    engine = DeviceEngine(port_db, CPU)
    assert engine.n_flat_words < engine.COMPACT_MIN_WORDS
    monkeypatch.setattr(reductions, "compact_nonzero", None)
    flt = Query(_body(FILTERS[0])).filter
    for g, w in zip(engine.evaluate_compact(flt), engine.evaluate(flt)):
        np.testing.assert_array_equal(g, w)


def test_details_through_compact_match_jax(port_db, ref_engine, monkeypatch):
    """Details and Insertions-free row actions read evaluate_compact through
    the query engine: equal to the JAX engine's answers."""
    engine = DeviceEngine(port_db, CPU, devices=[CPU] * 4)
    for target in (engine, ref_engine):
        monkeypatch.setattr(target, "COMPACT_MIN_WORDS", 0)
        monkeypatch.setattr(target, "COMPACT_CAP_WORDS", 16)
    port, ref = QueryEngine(port_db, engine), RefQueryEngine(ref_engine.db)
    ref._device_engine = ref_engine
    action = {"type": "Details", "fields": ["key", "age", "country"],
              "orderByFields": ["key"], "limit": 50}
    for filter_json in FILTERS:
        body = _body(filter_json, action)
        assert port.execute(body) == ref.execute(body), filter_json


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_evaluate_compact_on_card(cuda_device, port_db, monkeypatch):
    """On the card, on one shard and on 4: below and above the cap, equal to
    evaluate()."""
    for devices in (None, [cuda_device] * 4):
        engine = DeviceEngine(port_db, cuda_device, devices=devices)
        monkeypatch.setattr(engine, "COMPACT_MIN_WORDS", 0)
        for cap in (8, 16384):
            monkeypatch.setattr(engine, "COMPACT_CAP_WORDS", cap)
            for filter_json in FILTERS:
                flt = Query(_body(filter_json)).filter
                for g, w in zip(engine.evaluate_compact(flt),
                                engine.evaluate(flt)):
                    np.testing.assert_array_equal(g, w)
