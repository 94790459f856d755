"""The plain reference against the port's CPU path, and its sparse
evaluation against a plain one over one boolean per sequence."""

import json

import numpy as np
import pytest
import torch

import lapis_silo_torch
from benchmark import corpus
from benchmark.reference.compare import agrees
from benchmark.reference.silo import SYMBOLS, Reference
from benchmark.tests.mixes import ACTIONS
from benchmark.traffic.generator import Generator, load_mix

SMALL = {"counts": (6000, 900, 3, 30), "actions": (6000, 900, 3, 30),
         # few mutations a genome: rows sparse enough for the CSR tier
         "hot": (16384, 1000, 2, 2)}


def _reference(drawn):
    return Reference(drawn, corpus.COUNTRIES, corpus.YEAR, corpus.MONTH)


def _generator(mix, drawn, seed):
    return Generator(mix, drawn.reference, corpus.COUNTRIES, corpus.YEAR,
                     corpus.MONTH, corpus.N_DAYS, seed)


@pytest.mark.parametrize("name", ["counts", "actions", "hot"])
def test_reference_agrees_with_the_port(name, monkeypatch):
    n_rows, length, n_partitions, mutations = SMALL[name]
    if name == "hot":  # the two-tier engine: every stored row sparse
        monkeypatch.setenv("SILO_DENSE_BANK_BUDGET_GB", "0.00001")
        monkeypatch.setenv("SILO_LEAF_POOL_GB", "0.01")
    drawn = corpus.draw(n_rows, length, n_partitions, mutations, 20261017)
    db = corpus.build_database(drawn)
    engine = lapis_silo_torch.install(db, torch.device("cpu"))
    if name == "hot":
        assert engine.n_sparse > 0 and engine.pool_slots > 0
    mix = dict(ACTIONS) if name == "actions" else load_mix(name)
    if "size" in mix["positions"]:
        mix["positions"] = {"kind": "fixed_set", "size": 64}
    generator = _generator(mix, drawn, 5)
    reference = _reference(drawn)
    requests = generator.requests(240) + generator.sweep()[:16]
    kinds = set()
    for request in requests:
        response = db.execute_query(request.body)
        assert agrees(reference, request.body, response), request.body
        kinds.add(request.kind)
    assert kinds >= {kind["name"] for kind in mix["kinds"]}


def _dense(ref: Reference, node) -> np.ndarray:
    """The plain evaluation: one boolean per sequence, straight from the
    arrays."""
    n = ref.n
    kind = node["type"]
    if kind in ("And", "Or"):
        parts = [_dense(ref, c) for c in node["children"]]
        out = parts[0].copy()
        for part in parts[1:]:
            out = out & part if kind == "And" else out | part
        return out
    if kind == "Not":
        return ~_dense(ref, node["child"])
    if kind == "N-Of":
        hits = sum(_dense(ref, c).astype(int) for c in node["children"])
        want = node["numberOfMatchers"]
        return hits == want if node["matchExactly"] else hits >= want
    if kind == "StringEquals":
        return ref.country == corpus.COUNTRIES.index(node["value"])
    if kind == "DateBetween":
        lo, hi = (int(node[k][-2:]) for k in ("from", "to"))
        return (ref.day >= lo) & (ref.day <= hi)
    symbol_of = np.full(n, -1)  # -1: the reference's symbol
    position = node["position"] - 1
    for part in ref.parts:
        at = part.positions == position
        symbol_of[part.rows[at] + part.row_base] = part.symbols[at]
    ref_symbol = int(ref.reference[position])
    if kind == "HasNucleotideMutation":
        if SYMBOLS[ref_symbol] == "T":
            return np.ones(n, dtype=bool)
        return symbol_of >= 0
    symbol = ref_symbol if node["symbol"] == "." else SYMBOLS.index(
        node["symbol"])
    if symbol == ref_symbol:
        return symbol_of < 0
    return symbol_of == symbol


def _tree(rng, leaves, depth):
    if depth == 0 or rng.random() < 0.3:
        return leaves[rng.integers(len(leaves))]
    kind = ["And", "Or", "Not", "N-Of"][rng.integers(4)]
    if kind == "Not":
        return {"type": "Not", "child": _tree(rng, leaves, depth - 1)}
    children = [_tree(rng, leaves, depth - 1)
                for _ in range(int(rng.integers(2, 4)))]
    if kind == "N-Of":
        return {"type": "N-Of", "children": children,
                "numberOfMatchers": int(rng.integers(0, len(children) + 1)),
                "matchExactly": bool(rng.random() < 0.5)}
    return {"type": kind, "children": children}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sparse_evaluation_equals_the_plain_one(seed):
    drawn = corpus.draw(3000, 200, 2, 30, seed)
    ref = _reference(drawn)
    rng = np.random.default_rng(seed)
    leaves = []
    for position in rng.choice(200, 12, replace=False).tolist():
        leaves.append({"type": "HasNucleotideMutation",
                       "position": position + 1})
        for symbol in ".ACGT":
            leaves.append({"type": "NucleotideEquals",
                           "position": position + 1, "symbol": symbol})
    leaves += [{"type": "StringEquals", "column": "country", "value": c}
               for c in corpus.COUNTRIES[:2]]
    leaves += [{"type": "DateBetween", "column": "date",
                "from": "2021-03-05", "to": "2021-03-11"}]
    for _ in range(200):
        node = _tree(rng, leaves, 3)
        want = np.flatnonzero(_dense(ref, node))
        assert (ref.members(ref.select(node)) == want).all(), node


def test_details_check_refuses_what_silo_would_not_say():
    drawn = corpus.draw(4000, 300, 2, 30, 11)
    ref = _reference(drawn)
    position = int(drawn.partitions[0].positions[0])
    symbol = SYMBOLS[int(drawn.partitions[0].symbols[0])]
    query = json.dumps({
        "action": {"type": "Details", "fields": ["key", "date", "country"],
                   "orderByFields": ["date"], "limit": 3},
        "filterExpression": {"type": "NucleotideEquals",
                             "position": position + 1, "symbol": symbol}})
    rows = ref.answer(query)
    assert len(rows) >= 2 and ref.check_details(query, rows)
    assert not ref.check_details(query, rows[:-1])  # short of the limit
    assert not ref.check_details(query, [rows[0]] * len(rows))  # repeated
    if rows[0]["date"] != rows[-1]["date"]:
        assert not ref.check_details(query, rows[::-1])  # order by date
    chosen = set(ref.members(ref.select(
        json.loads(query)["filterExpression"])).tolist())
    outside = next(r for r in range(ref.n) if r not in chosen)
    other = ref.details_row(outside, ["key", "date", "country"])
    assert not ref.check_details(query, rows[:-1] + [other])  # unselected
    changed = dict(rows[0], country="Atlantis")
    assert not ref.check_details(query, [changed] + rows[1:])
