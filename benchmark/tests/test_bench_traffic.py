"""The generator: one seed, one set of requests; every seed the same number
of each kind and the same gaps between arrivals."""

import collections
import json

import numpy as np
import pytest

from benchmark import corpus
from benchmark.tests.mixes import ACTIONS
from benchmark.traffic.generator import Generator, load_mix

REFERENCE = np.random.default_rng(0).integers(1, 5, size=29903)
MIXES = ["counts", "hot", "actions"]


def _mix(name):
    return dict(ACTIONS) if name == "actions" else load_mix(name)


def _generator(name, seed):
    return Generator(_mix(name), REFERENCE, corpus.COUNTRIES, corpus.YEAR,
                     corpus.MONTH, corpus.N_DAYS, seed)


@pytest.mark.parametrize("name", MIXES)
def test_requests_repeat_per_seed_and_differ_between_seeds(name):
    first = [r.body for r in _generator(name, 2**31 + 5).requests(500)]
    again = [r.body for r in _generator(name, 2**31 + 5).requests(500)]
    other = [r.body for r in _generator(name, 2**31 + 6).requests(500)]
    assert first == again
    assert first != other
    warm = [r.body for r in _generator(name, 2**31 + 5).requests(500, 2)]
    # another stream draws other requests; a one-leaf request of 29,903
    # positions may come up in both by chance
    assert len(set(first) & set(warm)) <= 5


@pytest.mark.parametrize("name", MIXES)
def test_kinds_keep_their_shares_on_every_seed(name):
    mix = _mix(name)
    n = 1000
    for seed in (1, 2, 3):
        requests = _generator(name, seed).requests(n)
        counts = collections.Counter(r.kind for r in requests)
        for kind in mix["kinds"]:
            assert abs(counts[kind["name"]] - kind["share"] * n) <= 1
        for request in requests:
            data = json.loads(request.body)
            kind = next(k for k in mix["kinds"] if k["name"] == request.kind)
            assert data["action"] == kind["action"]


def test_leaves_and_metadata_follow_the_mix():
    requests = _generator("actions", 7).requests(2000)
    counts = [json.loads(r.body)["filterExpression"] for r in requests
              if r.kind == "count"]
    narrowed = [f for f in counts if f["type"] == "And"
                and f["children"][-1]["type"] == "DateBetween"]
    assert len(narrowed) == len(counts) // 2
    for node in narrowed:
        country, dates = node["children"][-2:]
        assert country["value"] in corpus.COUNTRIES
        lo, hi = int(dates["from"][-2:]), int(dates["to"][-2:])
        assert 1 <= lo <= hi <= corpus.N_DAYS and hi - lo < 14
    has = nuc = 0
    for request in requests:
        for leaf in _leaves(json.loads(request.body)["filterExpression"]):
            if leaf["type"] == "HasNucleotideMutation":
                has += 1
                assert request.kind == "count"
            elif leaf["type"] == "NucleotideEquals":
                nuc += 1
                position = leaf["position"] - 1
                assert "-ACGT".index(leaf["symbol"]) == (
                    REFERENCE[position] % 4 + 1)
    assert has and nuc


def _leaves(node):
    if "children" in node:
        for child in node["children"]:
            yield from _leaves(child)
    elif "child" in node:
        yield from _leaves(node["child"])
    else:
        yield node


def test_fixed_set_bounds_the_positions():
    generator = _generator("hot", 11)
    positions = {leaf["position"] - 1
                 for r in generator.requests(3000)
                 for leaf in _leaves(json.loads(r.body)["filterExpression"])}
    assert positions <= set(generator.position_set.tolist())
    assert len(generator.position_set) == 512
    swept = {leaf["position"] - 1 for r in generator.sweep()
             for leaf in _leaves(json.loads(r.body)["filterExpression"])}
    assert swept == set(generator.position_set.tolist())


def test_arrivals_are_the_same_gaps_in_another_order():
    a = _generator("actions", 1).arrivals(18, 40)
    b = _generator("actions", 2).arrivals(18, 40)
    assert len(a) == len(b) == 720
    assert a[0] == 0 and (np.diff(a) > 0).all() and a[-1] < 40
    gaps_a = np.sort(np.diff(np.append(a, 40)))
    gaps_b = np.sort(np.diff(np.append(b, 40)))
    assert np.allclose(gaps_a, gaps_b)
    assert not np.allclose(a, b)
    # exponential gaps: the mean is the rate's, the spread an exponential's
    assert abs(np.diff(a).mean() - 1 / 18) < 0.005
    assert abs(np.median(gaps_a) - np.log(2) / 18) < 0.005


@pytest.mark.parametrize("name", ["counts", "hot"])
def test_a_closed_loop_is_never_sent_a_request_twice(name):
    """Past what the stream drew ahead, it draws more, never the same."""
    stream = _generator(name, 2**31 + 9).stream(chunk=300)
    stream.prefetch(300)
    bodies = [stream[i].body for i in range(1000)]
    assert len(stream.parts) == 4
    # fresh combinations; a one-leaf count over 29,903 positions (or 512
    # fixed ones) may come up twice by chance
    repeated = len(bodies) - len(set(bodies))
    assert repeated <= (25 if name == "hot" else 5)
    again = _generator(name, 2**31 + 9).stream(chunk=300)
    assert [again[i].body for i in range(999, -1, -1)] == bodies[::-1]
    first = _generator(name, 2**31 + 9).requests(300)
    assert [r.body for r in first] == bodies[:300]
