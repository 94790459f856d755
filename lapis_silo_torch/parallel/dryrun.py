"""The multi-device dry run of the port's sharded engine.

The counterpart of ``dryrun_multichip`` (``__graft_entry__.py:65-243``):
the port's ``DeviceEngine`` with the flat word axis sharded over `devices`
runs the code paths a multi-card deployment runs (the sparse tier forced
on, batched counts cold and then pool-resident, a group-by and the
Mutations histogram), and every result is held bit-equal to a host oracle
(numpy bitsets, no device) and to a one-device engine. The kernels' launch
counters (``kernels.KernelCounts``) show which routes ran: on CUDA devices
K1, K2, K3 and K5 (and the sharded wrappers over K1 and K2) launched and no
plain version ran; on the CPU the plain versions stand in for them.

    python -c 'import torch; from lapis_silo_torch.parallel.dryrun import \\
        dryrun_multichip; print(dryrun_multichip([torch.device("cpu")] * 4))'
"""

from __future__ import annotations

import json

import numpy as np

from ..common.symbols import NUCLEOTIDE
from ..ops import bitset, kernels
from ..ops.device_engine import DeviceEngine
from ..query import ast
from ..query.engine import Query
from ..query.ir import HostEvaluator
from ..testing import sample_count_queries, synthetic_database
from .shards import resolve

# the kernels the sharded engine's routes must reach, directly or through
# the sharded wrappers
ROUTE_KERNELS = (kernels.VM_RUN, kernels.VM_RUN_SHARDED,
                 kernels.MUTATION_COUNTS, kernels.MUTATION_COUNTS_SHARDED,
                 kernels.SPARSE_COUNTS, kernels.DENSIFY_INTO_POOL)


def _oracle_count(db, filter_expr) -> int:
    """The filter's count from numpy bitsets on the host."""
    total = 0
    db.uniform_compile = True
    try:
        for partition in db.partitions:
            node = filter_expr.compile(db, partition, ast.NONE)
            total += int(bitset.popcount(
                HostEvaluator(partition.sequence_count).evaluate(node)))
    finally:
        db.uniform_compile = False
    return total


def _counts() -> dict:
    return {k.name: (k.launches, k.plain_launches) for k in kernels.KERNELS}


def dryrun_multichip(devices) -> dict:
    """Run the dry run over `devices` (one word shard per entry, repeats
    allowed); raises AssertionError on any mismatch or missed route.
    Returns what it checked: the batch size, the sparse rows, the pool's
    hits and misses, and the launches (kernel, plain) per kernel."""
    devices = [resolve(d) for d in devices]
    # 16,384 rows per partition, so that with sparse_min_words=1 both
    # tiers hold rows. The reference takes 256 positions, where its word
    # axis is padded to 128 words per device (a Mosaic layout the port
    # drops); on the port's unpadded axis no row of that corpus passes the
    # density cutoff. At 576 positions each row is sparser: 1,569 rows
    # stay dense and 159 go sparse
    db = synthetic_database(n_rows=49152, length=576, n_partitions=3,
                            mutations_per_genome=8)
    queries = [Query(q) for q in sample_count_queries(db, 16)]
    groupby = Query(json.dumps({
        "action": {"type": "Aggregated", "groupByFields": ["country"]},
        "filterExpression": {"type": "HasNucleotideMutation", "position": 17},
    }))

    before = _counts()
    sharded = DeviceEngine(db, devices[0], sparse_min_words=1,
                           devices=devices if len(devices) > 1 else None)
    assert sharded.n_sparse > 0, "sparse tier must be active"
    # explicit queries on the sparse-tier rows: the batch must densify
    # them into the pool, not only read dense rows
    meta = sharded.segment_meta[("nuc", "main")]
    for sym_id, pos_id in zip(meta["sparse_sym_ids"], meta["sparse_pos_ids"]):
        queries.append(Query(json.dumps({
            "action": {"type": "Aggregated"},
            "filterExpression": {
                "type": "Or", "children": [
                    {"type": "NucleotideEquals", "position": int(pos_id) + 1,
                     "symbol": NUCLEOTIDE.chars[int(sym_id)]},
                    {"type": "HasNucleotideMutation", "position": 3},
                ]},
        })))
    batch = [q.filter for q in queries]
    assert any(sharded.lower(f)[0].sparse_leaves for f in batch), \
        "no query reaches the sparse tier"
    want_counts = [_oracle_count(db, f) for f in batch]
    n_total = sum(p.sequence_count for p in db.partitions)
    sel = next(q for q, c in zip(queries, want_counts) if 0 < c < n_total)

    got_counts = sharded.count_batch(batch)
    # cold, then hot: the repeat reads the sparse leaves pool-resident
    assert sharded.pool_slots > 0, "hot-leaf pool inactive"
    misses_after_cold = sharded.pool_misses
    assert sharded.count_batch(batch) == got_counts
    assert sharded.pool_hits > 0, "no pool-resident reads"
    assert sharded.pool_misses == misses_after_cold, \
        "hot leaves densified again"
    got_groups = sharded.group_counts(groupby.filter, ["country"])
    sel_words = sharded.evaluate(sel.filter)
    got_mut = sharded.mutation_counts("nuc", "main", sel_words)
    after = _counts()
    launched = {name: (after[name][0] - before[name][0],
                       after[name][1] - before[name][1]) for name in after}
    on_card = devices[0].type == "cuda"
    for k in ROUTE_KERNELS:
        kernel_runs, plain_runs = launched[k.name]
        assert (kernel_runs if on_card else plain_runs) > 0, \
            f"{k.name} never reached"
    if on_card:
        assert not any(plain for _runs, plain in launched.values()), launched

    assert got_counts == want_counts, (got_counts[:4], want_counts[:4])
    # a one-device engine: the words unsharded, the counts never added
    # across shards
    single = DeviceEngine(db, devices[0], sparse_min_words=1)
    assert single.count_batch(batch) == want_counts
    assert got_groups == single.group_counts(groupby.filter, ["country"])
    assert got_groups and sum(c for _g, c in got_groups) == _oracle_count(
        db, groupby.filter)
    single_words = single.evaluate(sel.filter)
    for got_w, want_w in zip(sel_words, single_words, strict=True):
        np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(
        got_mut, single.mutation_counts("nuc", "main", single_words))
    return {"devices": [str(d) for d in devices], "counts": len(batch),
            "n_sparse": sharded.n_sparse, "pool_slots": sharded.pool_slots,
            "pool_hits": sharded.pool_hits,
            "pool_misses": sharded.pool_misses, "launches": launched}
