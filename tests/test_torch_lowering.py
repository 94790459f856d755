"""The port's lowering (lapis_silo_torch/ops/lowering.py) against the JAX
package's: for the bench's count queries, the serving mix and random filter
trees over the rich corpus, both give bit-equal wire code arrays, equal dyn
rows and equal register counts (or raise the same host-fallback exception).
The reference engine runs on one CPU device, where its row layout is the
port's (no mesh padding, no TPU row alignment). Each engine lowers on its own
package's corpus, built from the same seed, and its own parse of the query."""

import json
import random

import jax
import numpy as np
import pytest
import torch

from lapis_silo_tpu import testing as ref_testing
from lapis_silo_tpu.ops import device_engine as ref_de
from lapis_silo_tpu.query.engine import Query as RefQuery
from lapis_silo_torch.ops import vm
from lapis_silo_torch.ops.device_engine import DeviceEngine
from lapis_silo_torch.query.engine import Query
from lapis_silo_torch.testing import (
    hot_count_queries, sample_count_queries, synthetic_database,
)

from .test_fuzz_filters import random_filter


def _engines(**corpus):
    return (ref_de.DeviceEngine(ref_testing.synthetic_database(**corpus),
                                devices=jax.devices()[:1]),
            DeviceEngine(synthetic_database(**corpus), torch.device("cpu")))


@pytest.fixture(scope="module")
def lean():
    return _engines(n_rows=2000, length=400, n_partitions=3, seed=4)


@pytest.fixture(scope="module")
def rich():
    return _engines(n_rows=999, length=333, n_partitions=3, seed=7, rich=True)


def _assert_same_lowering(engines, query_json: str) -> bool:
    """True when both lowered the query's filter, False when both fell
    back."""
    ref, port = engines
    try:
        want, want_regs = ref.lower(RefQuery(query_json).filter)
    except (ref_de.ProgramTooLarge, ref_de.StructureMismatch) as ex:
        with pytest.raises(getattr(vm, type(ex).__name__)):
            port.lower(Query(query_json).filter)
        return False
    got, got_regs = port.lower(Query(query_json).filter)
    assert got_regs == want_regs == got.max_regs == want.max_regs
    bucket = vm._LEN_BUCKETS[-1]
    np.testing.assert_array_equal(
        vm.pack_code_array(bucket, got.opcodes, got.operands, got.regspec),
        ref_de.pack_code_array(bucket, want.opcodes, want.operands,
                               want.regspec))
    assert len(got.dyn_rows) == len(want.dyn_rows)
    for got_rows, want_rows in zip(got.dyn_rows, want.dyn_rows):
        for g, w in zip(got_rows, want_rows, strict=True):
            np.testing.assert_array_equal(g, w)
    assert got.sparse_leaves == want.sparse_leaves == []
    return True


def test_row_layout_matches_reference(lean):
    ref, port = lean
    assert port.n_words == ref.n_words and port.n_rows == ref.n_rows
    for key, meta in ref.segment_meta.items():
        np.testing.assert_array_equal(port.segment_meta[key]["row_map"],
                                      meta["row_map"])


def test_sample_count_queries_lower_identically(lean):
    db = lean[1].db
    for query in sample_count_queries(db, 64, seed=3):
        assert _assert_same_lowering(lean, query)


def test_hot_count_queries_lower_identically(lean):
    db = lean[1].db
    positions = np.arange(0, 400, 7)
    for query in hot_count_queries(db, positions, 48, seed=5):
        assert _assert_same_lowering(lean, query)


def test_rich_filter_trees_lower_identically(rich):
    db = rich[1].db
    rng = random.Random(9)
    lowered = 0
    for _ in range(120):
        query = json.dumps({"filterExpression": random_filter(rng, db),
                            "action": {"type": "Aggregated"}})
        lowered += _assert_same_lowering(rich, query)
    assert lowered >= 90
