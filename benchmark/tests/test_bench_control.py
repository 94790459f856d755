"""``correct`` comes out false for the control and for a timed path broken
underneath, and true for the sound one: each run here drives the whole of
a run but the look for a card, at a size the CPU holds."""

import numpy as np
import pytest
import torch

from benchmark import control, run
from benchmark.tests.mixes import ACTIONS, actions_spec
from lapis_silo_torch.ops.device_engine import DeviceEngine

CPU = torch.device("cpu")
SMALL = {
    "dense1m.counts": {
        "config": {"n_sequences": 6000, "sequence_length": 800},
        "mix": {"prefetch_per_s": 400, "warmup_requests": 32,
                "loop": {"kind": "closed", "clients": 8}}},
    "dense1m.actions": {
        "config": {"n_sequences": 6000, "sequence_length": 800},
        "mix": ACTIONS},
    "twotier2m.hot": {
        "config": {"n_sequences": 16384, "sequence_length": 1000,
                   "n_partitions": 2, "mutations_per_genome": 2},
        "mix": {"prefetch_per_s": 400, "warmup_requests": 32,
                "loop": {"kind": "closed", "clients": 8},
                "positions": {"kind": "fixed_set", "size": 48}}},
}


@pytest.fixture(autouse=True)
def two_tier_when_hot(request, monkeypatch):
    """The hot cell's corpus is small: the dense budget is shrunk so that
    its rows go sparse and the pool serves them, as at full size."""
    if "hot" in request.node.name:
        monkeypatch.setenv("SILO_DENSE_BANK_BUDGET_GB", "0.00001")
        monkeypatch.setenv("SILO_LEAF_POOL_GB", "0.01")


SPEC = actions_spec(run.load_spec())


def _run(cell, seed=17):
    return run.run_cell(cell, seed, 1.0, False, CPU, overrides=SMALL[cell],
                        spec=SPEC)


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_runs_are_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["checks"]["wrong_answers"]["value"] == 0


@pytest.mark.parametrize("cell", list(SMALL))
def test_the_control_is_not_correct(cell):
    checks = control.readings(cell, 23, 1.0, SMALL[cell], SPEC)
    assert checks["wrong_answers"][0] > 0


def _altered_count(monkeypatch):
    """A count altered where the launch's counts are read back."""
    finish = DeviceEngine.count_finish

    def wrong(results, device_idx, dispatches):
        results = finish(results, device_idx, dispatches)
        if device_idx:
            results[device_idx[0]] += 1
        return results
    monkeypatch.setattr(DeviceEngine, "count_finish", staticmethod(wrong))


def _half_batch(monkeypatch):
    """Half of each batch left out of the launch, its answers the mean of
    the rest."""
    count_programs = DeviceEngine.count_programs

    def half(self, lowered, *args, **kwargs):
        kept = count_programs(self, lowered[:max(1, len(lowered) // 2)],
                              *args, **kwargs)
        mean = int(round(float(np.mean(kept))))
        return kept + [mean] * (len(lowered) - len(kept))
    monkeypatch.setattr(DeviceEngine, "count_programs", half)


def _altered_mutations(monkeypatch):
    many = DeviceEngine.mutation_counts_many

    def wrong(self, kind, names, filter_words):
        out = many(self, kind, names, filter_words)
        for counts in out.values():
            hit = np.argwhere(counts[1:5] > 0)
            if len(hit):
                symbol, position = hit[-1]
                counts[symbol + 1, position] += 1
        return out
    monkeypatch.setattr(DeviceEngine, "mutation_counts_many", wrong)


def _altered_groups(monkeypatch):
    group_counts = DeviceEngine.group_counts

    def wrong(self, filter_expr, column_names):
        groups = group_counts(self, filter_expr, column_names)
        if groups:
            key, count = groups[0]
            groups = [(key, count + 1)] + groups[1:]
        return groups
    monkeypatch.setattr(DeviceEngine, "group_counts", wrong)


def _dropped_row(monkeypatch):
    evaluate_compact = DeviceEngine.evaluate_compact

    def wrong(self, filter_expr):
        bitmaps = [words.copy() for words in evaluate_compact(self,
                                                              filter_expr)]
        for words in bitmaps:
            nonzero = np.flatnonzero(words)
            if len(nonzero):
                word = words[nonzero[0]]
                words[nonzero[0]] = word & (word - np.uint32(1))
                break
        return bitmaps
    monkeypatch.setattr(DeviceEngine, "evaluate_compact", wrong)


@pytest.mark.parametrize("cell,fault", [
    ("dense1m.counts", _altered_count),
    ("dense1m.counts", _half_batch),
    ("twotier2m.hot", _altered_count),
    ("twotier2m.hot", _half_batch),
    ("dense1m.actions", _altered_count),
    ("dense1m.actions", _altered_mutations),
    ("dense1m.actions", _altered_groups),
    ("dense1m.actions", _dropped_row),
])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(cell)
    assert not result["correct"]
    assert result["checks"]["wrong_answers"]["value"] > 0
