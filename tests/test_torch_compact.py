"""The port's compact extraction (DeviceEngine.evaluate_compact) against the
JAX package's.

With COMPACT_MIN_WORDS lowered so the small corpora take the path, the
port's ``evaluate_compact`` on 1, 4 and 8 CPU shards equals the JAX
engine's (its fused ``compact:{cap}`` output, lapis_silo_tpu/ops/vm.py:505)
and ``evaluate()``: selective filters below the cap, wide ones that
overflow it (the words are copied instead), the trivial FULL/ZERO filters
and the empty result. ``reductions.compact_nonzero`` is held to the
reference's fixed-size ``jnp.nonzero``, and Details through the query
engine to the JAX engine's answer. ``kernels.compact_nonzero_sharded`` (K10's
wrapper; its plain version on the CPU) over uneven shards with non-zero
offsets equals ``jnp.nonzero(size=cap, fill_value=0)`` per shard and on the
flat words, at counts of 0, 1, cap - 1, cap, cap + 1 and many times cap.
A numpy emulation of ``csrc/compact.cu`` over its host-side layout
(``kernels.compact_layout`` and ``compact_table``: each tile's shard and
16-byte quads by the kernel's own arithmetic, the look-back's prefixes)
covers every word once, writes every slot, equals the plain version, and
fails under three mutations of the layout. Each package serves its own
corpus built from the same seed; every value is a word or an index: the
tolerance is equality. The same on the card is marked `cuda`."""

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
from lapis_silo_torch.ops import kernels, reductions
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


# counts of non-zero words per shard at CAP: 0, 1, cap - 1, cap, cap + 1
# and many times cap
CAP = 8
FILLS = [0, 1, CAP - 1, CAP, CAP + 1, 5 * CAP]


def _shards(rng, widths, counts, base=1000, head=0, devices=None):
    """Flat uint32 words over shards of `widths` (shard d holding counts[d]
    non-zero words, some with bit 31 set, word 0 among them in every other
    shard), and the shards as int32 tensors starting `head` words
    into their storage (a view: the kernel's 16-byte quads then start
    before the shard; on devices[d], the CPU by default); the shards'
    global offsets from `base`."""
    parts, offsets, flat = [], [], []
    for d, (n, k) in enumerate(zip(widths, counts)):
        words = np.zeros(n, dtype=np.uint32)
        hot = rng.choice(n, size=min(k, n), replace=False)
        if hot.size and d % 2 and 0 not in hot:
            hot[0] = 0
        words[hot] = rng.integers(1, 1 << 32, size=hot.size, dtype=np.uint64)
        words[hot[::3]] |= np.uint32(0x80000000)
        storage = np.zeros(n + head, dtype=np.uint32)
        storage[head:] = words
        storage = torch.from_numpy(storage.view(np.int32))
        if devices is not None:
            storage = storage.to(devices[d])
        parts.append(storage[head:])
        offsets.append(base + sum(widths[:d]))
        flat.append(words)
    return parts, offsets, np.concatenate(flat)


def _want_block(flat, lo, hi, cap):
    """The reference's block for the shard [lo, hi) of `flat` (global index
    base added by the caller): jnp.nonzero's count, its first cap indices
    and the words there (fill index 0: the shard's word 0)."""
    shard = jnp.asarray(flat[lo:hi])
    nz = shard != 0
    idx = np.asarray(jnp.nonzero(nz, size=cap, fill_value=0)[0])
    words = np.asarray(shard[idx]) if hi > lo else np.zeros(cap, np.uint32)
    return int(nz.sum()), idx, words


@pytest.mark.parametrize("fill", FILLS)
def test_compact_nonzero_sharded_matches_jax_nonzero(fill):
    """K10's wrapper over 4 uneven shards (one empty) with non-zero offsets,
    every non-empty shard at the same count of non-zero words: each shard's
    block equals jnp.nonzero over its words; where the counts fit the cap in
    all, the pairs of all shards are jnp.nonzero over the flat words."""
    rng = np.random.default_rng(fill)
    widths = [3 * CAP + 5, 0, 6 * CAP + 1, 11]
    parts, offsets, flat = _shards(rng, widths, [fill] * 4, head=1)
    stacks = kernels.compact_nonzero_sharded(parts, offsets, CAP)
    assert len(stacks) == 1 and stacks[0].shape == (4, 1 + 2 * CAP)
    blocks = stacks[0].numpy()
    lo = 0
    for d, n in enumerate(widths):
        count, idx, words = _want_block(flat, lo, lo + n, CAP)
        assert blocks[d, 0] == count
        np.testing.assert_array_equal(blocks[d, 1:1 + CAP], idx + offsets[d])
        np.testing.assert_array_equal(blocks[d, 1 + CAP:].view(np.uint32),
                                      words)
        lo += n
    if (blocks[:, 0] <= CAP).all():
        total = int(blocks[:, 0].sum())
        flat_idx = np.asarray(jnp.nonzero(jnp.asarray(flat) != 0,
                                          size=4 * CAP, fill_value=0)[0])
        got = np.concatenate([blocks[d, 1:1 + blocks[d, 0]]
                              for d in range(4)])
        np.testing.assert_array_equal(got, flat_idx[:total] + offsets[0])


@pytest.mark.parametrize("fill", [0, CAP, 5 * CAP])
def test_compact_to_host_rebuilds_the_flat_words(fill):
    """compact_to_host over 3 shards equals the flat words while the
    shards' counts fit the cap, and is None past it."""
    from lapis_silo_torch.ops.device_engine import compact_to_host

    rng = np.random.default_rng(fill + 1)
    widths = [40, 25, 64]
    counts = [fill // 3, fill - fill // 3, 0]
    parts, _offsets, flat = _shards(rng, widths, counts)
    offsets = [0, 40, 65]
    got = compact_to_host(parts, offsets, CAP, flat.size)
    if fill <= CAP:
        np.testing.assert_array_equal(got, flat)
    else:
        assert got is None


# -- K10's host-side layout, emulated ----------------------------------------

QUADS = kernels.COMPACT_TILE_QUADS


def _find_tile(rows, tile):
    """csrc/compact.cu's find_tile: the last shard whose first tile is at or
    before `tile`, and the tile's index within that shard."""
    s = 0
    while s + 1 < len(rows) and rows[s + 1][4] <= tile:
        s += 1
    return s, tile - rows[s][4]


def _k10_emulate(words, offsets, cap, layout=kernels.compact_layout):
    """csrc/compact.cu's K10 on the CPU over one card's shards: the shard
    table from `layout` and kernels.compact_table, read back as the C
    entry reads it; each tile, in ticket order, finds its shard, loads its
    1,024 quads from 16-byte boundaries (words outside the shard as 0),
    takes its prefix from its predecessors' published totals (walking back
    to the shard's first tile), writes its ranks below cap, and the shard's
    last tile the count and the fill. Asserts that every word is loaded
    exactly once and every slot written. Returns the blocks [D, 1 + 2 cap]."""
    widths = tuple(w.shape[0] for w in words)
    rows, n_tiles = layout(widths, kernels._heads(words))
    blocks = torch.zeros((len(words), 1 + 2 * cap), dtype=torch.int32)
    table = kernels.compact_table(words, blocks, offsets, rows)
    rows = [tuple(table[6 * i:6 * i + 6]) for i in range(len(words))]
    out = np.zeros((len(words), 1 + 2 * cap), dtype=np.int64)
    written = np.zeros(out.shape, dtype=np.int64)
    covered = [np.zeros(n, dtype=np.int64) for n in widths]
    published = {}
    for tile in range(n_tiles):
        s, local = _find_tile(rows, tile)
        addr, block_addr, n, offset, tile_lo, tiles = rows[s]
        assert (addr, block_addr) == (words[s].data_ptr(),
                                      blocks[s].data_ptr())
        head = addr % 16 // 4
        first = 4 * np.arange(local * QUADS, (local + 1) * QUADS) - head
        local_idx = (first[:, None] + np.arange(4)).reshape(-1)
        inside = (local_idx >= 0) & (local_idx < n)
        covered[s][local_idx[inside]] += 1
        vals = np.zeros(local_idx.size, dtype=np.uint32)
        vals[inside] = words[s].numpy().view(np.uint32)[local_idx[inside]]
        hot = np.flatnonzero(vals)
        excl = 0
        for pred in range(tile - 1, tile_lo - 1, -1):
            excl += published[pred]
        published[tile] = hot.size
        rank = excl + np.arange(hot.size)
        keep = rank < cap
        out[s, 1 + rank[keep]] = offset + local_idx[hot[keep]]
        out[s, 1 + cap + rank[keep]] = vals[hot[keep]].view(np.int32)
        written[s, 1 + rank[keep]] += 1
        written[s, 1 + cap + rank[keep]] += 1
        if local == tiles - 1:
            count = excl + hot.size
            out[s, 0] = count
            written[s, 0] += 1
            word0 = words[s].numpy()[0] if n else 0
            out[s, 1 + count:1 + cap] = offset
            out[s, 1 + cap + count:] = word0
            written[s, 1 + count:1 + cap] += 1
            written[s, 1 + cap + count:] += 1
    for cover in covered:
        assert (cover == 1).all(), "a word not loaded exactly once"
    assert (written >= 1).all(), "a slot never written"
    return out.astype(np.int32)


def _layout_cases():
    """Shards of one card that cross tile edges: widths just past and just
    under whole tiles at every head (0-3 words into a quad), an empty
    shard, one shard alone."""
    rng = np.random.default_rng(3)
    tile = 4 * QUADS
    yield rng, [tile - 1, 0, 2 * tile + 3, 5], 3, 2
    yield rng, [tile + 1, tile - 2, 1], 1, 3
    yield rng, [3 * tile - 1], 3, 40
    yield rng, [7, tile, 0, tile + 7], 2, 16384


@pytest.mark.parametrize("case", range(4))
def test_k10_emulation_equals_plain(case):
    """The emulated kernel over compact_layout equals the plain version."""
    rng, widths, head, cap = list(_layout_cases())[case]
    counts = [n // 3 for n in widths]
    parts, offsets, _flat = _shards(rng, widths, counts, head=head)
    want = torch.cat(kernels.compact_nonzero_sharded_plain(parts, offsets,
                                                          cap)).numpy()
    np.testing.assert_array_equal(_k10_emulate(parts, offsets, cap), want)


def _no_head(widths, heads):
    """Mutation: tiles counted as if every shard started on a quad."""
    return kernels.compact_layout.__wrapped__(widths, (0,) * len(widths))


def _no_empty_tile(widths, heads):
    """Mutation: an empty shard gets no tile."""
    rows, n_tiles, lo = [], 0, 0
    for (_first, tiles), n in zip(
            kernels.compact_layout.__wrapped__(widths, heads)[0], widths):
        tiles = tiles if n else 0
        rows.append((lo, tiles))
        lo += tiles
    return tuple(rows), lo


def _restart_numbering(widths, heads):
    """Mutation: every shard's tiles numbered from 0."""
    rows, n_tiles = kernels.compact_layout.__wrapped__(widths, heads)
    return tuple((0, tiles) for _first, tiles in rows), max(
        tiles for _first, tiles in rows)


@pytest.mark.parametrize("mutant", [_no_head, _no_empty_tile,
                                    _restart_numbering],
                         ids=lambda f: f.__name__)
def test_k10_emulation_catches_a_broken_layout(mutant):
    """Each mutation of the host-side layout fails the emulation on the
    cases above: a word loaded twice or never, a slot never written, or
    wrong blocks."""
    failed = 0
    for rng, widths, head, cap in _layout_cases():
        parts, offsets, _flat = _shards(rng, widths, [n // 3 for n in widths],
                                        head=head)
        want = torch.cat(kernels.compact_nonzero_sharded_plain(
            parts, offsets, cap)).numpy()
        try:
            got = _k10_emulate(parts, offsets, cap, layout=mutant)
        except (AssertionError, IndexError, KeyError):
            failed += 1
            continue
        failed += not np.array_equal(got, want)
    assert failed


def test_compact_layout_and_table():
    """Tiles per shard from its quads (head words before it in its first
    quad), one for an empty shard, numbered shard after shard; more than
    COMPACT_MAX_SHARDS shards refused; the table's rows."""
    tile = 4 * QUADS
    assert kernels.compact_layout((tile, tile, 0, 1), (0, 1, 0, 3)) == (
        ((0, 1), (1, 2), (3, 1), (4, 1)), 5)
    assert kernels.compact_layout((tile - 3,), (3,)) == (((0, 1),), 1)
    with pytest.raises(ValueError):
        kernels.compact_layout((1,) * 33, (0,) * 33)
    parts = [torch.zeros(5, dtype=torch.int32), torch.zeros(9, dtype=torch.int32)]
    blocks = torch.zeros((2, 3), dtype=torch.int32)
    rows, _n = kernels.compact_layout((5, 9), kernels._heads(parts))
    table = kernels.compact_table(parts, blocks, [7, 12], rows)
    assert list(table) == [parts[0].data_ptr(), blocks[0].data_ptr(), 5, 7,
                           0, 1, parts[1].data_ptr(), blocks[1].data_ptr(),
                           9, 12, 1, 1]


def test_routes_launch_k10_per_shard_on_the_cpu(port_db, monkeypatch):
    """evaluate_compact reaches K10's wrapper, whose plain version runs once
    per shard on the CPU; never the kernel."""
    engine = DeviceEngine(port_db, CPU, devices=[CPU] * 4)
    monkeypatch.setattr(engine, "COMPACT_MIN_WORDS", 0)
    kernels.reset_counts()
    engine.evaluate_compact(Query(_body(FILTERS[0])).filter)
    assert kernels.COMPACT_NONZERO.plain_launches == 4
    assert kernels.COMPACT_NONZERO.launches == 0


@pytest.mark.cuda
def test_compact_kernel_on_card(cuda_device):
    """K10 against its plain version on the card: every fill, unaligned and
    empty shards, tile edges, shards over the visible cards and 4 on one
    card; one launch per card."""
    n_cards = torch.cuda.device_count()
    for case, (rng, widths, head, cap) in enumerate(_layout_cases()):
        for fill in (0, 1, cap - 1, cap, cap + 1, 5 * cap):
            for cards in ([cuda_device] * len(widths),
                          [torch.device("cuda", d % n_cards)
                           for d in range(len(widths))]):
                on, offsets, _flat = _shards(
                    rng, widths, [fill] * len(widths), head=head,
                    devices=cards)
                kernels.reset_counts()
                got = kernels.compact_nonzero_sharded(on, offsets, cap)
                assert kernels.COMPACT_NONZERO.launches == len(set(cards))
                want = kernels.compact_nonzero_sharded_plain(on, offsets, cap)
                for g, w in zip(got, want):
                    assert torch.equal(g.cpu(), w.cpu()), (case, fill)


@pytest.mark.cuda
def test_compact_to_host_from_many_threads(cuda_device):
    """compact_to_host from 16 threads at once on one card, each on its own
    words (K10's scratch and the pinned blocks are shared across calls):
    every rebuild equals its words."""
    import sys
    import threading

    from lapis_silo_torch.ops.device_engine import compact_to_host

    rng = np.random.default_rng(16)
    inputs = []
    for t in range(16):
        parts, _offsets, flat = _shards(rng, [5000, 3000], [t, 2 * t],
                                        devices=[cuda_device] * 2)
        inputs.append((parts, flat))
    failures = []

    def run(parts, flat):
        for _ in range(20):
            got = compact_to_host(parts, [0, 5000], 64, flat.size)
            if got is None or not np.array_equal(got, flat):
                failures.append(flat.size)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=args) for args in inputs]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=120)
        assert not any(thread.is_alive() for thread in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not failures
