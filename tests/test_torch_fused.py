"""The filter's total and compact blocks from the VM launch that writes the
filter (``kernels.vm_filter_sharded``: K1 or K6 with their epilogue, as the
reference's dispatch yields its ``count`` and ``compact:<cap>`` outputs,
lapis_silo_tpu/ops/vm.py:500-514) against the JAX package's.

Each package serves its own corpus built from the same seed, on one shard
and on 4 (the JAX engine over as many virtual CPU devices): ``count``,
``count_async``, a device filter's total, Mutations matrices and answers,
``evaluate_compact`` and ``ShardedQueryStep``'s count equal the JAX
package's; a filter at the lowering's length cap still runs on the device
route. On the CPU the wrapper runs its plain version (the VM's plain run,
then the plain popcount and compaction), never K10's or K11's wrapper. A
numpy emulation of the epilogue over its host-side layout
(``kernels.card_tail``: each shard's word blocks in whole tiles and its
fill CTAs, numbered shard after shard; the table read back from
``kernels.k6_block``; each tile's ranks after its prefix, then the fill
CTAs) reads every word once, writes every slot once, equals the plain
version, and fails under four mutations of the layout.
Every value is a word, an index or a count: the tolerance is equality. The
kernels against K10, K11 and the plain versions on the card are marked
`cuda`."""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from lapis_silo_tpu import testing as ref_testing
from lapis_silo_tpu.ops import device_engine as ref_de
from lapis_silo_tpu.parallel.mesh import ShardedQueryStep as RefStep
from lapis_silo_tpu.parallel.mesh import make_mesh as ref_make_mesh
from lapis_silo_tpu.query.engine import Query as RefQuery
from lapis_silo_torch.ops import kernels, vm
from lapis_silo_torch.ops.device_engine import DeviceEngine
from lapis_silo_torch.ops.words import to_host
from lapis_silo_torch.parallel.mesh import ShardedQueryStep
from lapis_silo_torch.parallel.shards import gather_words, split_words
from lapis_silo_torch.query.engine import Query
from lapis_silo_torch.testing import sample_count_queries, synthetic_database

CPU = torch.device("cpu")
CORPUS = dict(n_rows=2048, length=512, n_partitions=3, seed=7)
TRIVIAL = [{"type": "True"}, {"type": "False"}]


def _body(filter_json, action=None):
    return json.dumps({"action": action or {"type": "Aggregated"},
                       "filterExpression": filter_json})


def _filters(db) -> list:
    """The sampled count filters, a wide one, an empty one and the trivial
    FULL/ZERO loads."""
    sampled = [json.loads(q)["filterExpression"]
               for q in sample_count_queries(db, 12, seed=4)]
    return sampled + [
        {"type": "Not", "child": {"type": "HasNucleotideMutation",
                                  "position": 3}},
        {"type": "And", "children": [
            {"type": "HasNucleotideMutation", "position": 300},
            {"type": "Not", "child": {"type": "HasNucleotideMutation",
                                      "position": 300}}]}] + TRIVIAL


@pytest.fixture(scope="module")
def port_db():
    return synthetic_database(**CORPUS)


@functools.cache
def _ref_engine(n_shards: int):
    return ref_de.DeviceEngine(ref_testing.synthetic_database(**CORPUS),
                               devices=jax.devices()[:n_shards])


def _port_engine(db, n_shards: int) -> DeviceEngine:
    return DeviceEngine(db, CPU,
                        devices=[CPU] * n_shards if n_shards > 1 else None)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_counts_and_totals_match_jax(port_db, n_shards):
    """count, count_async and a device filter's total equal the JAX
    engine's; each non-trivial filter takes one VM run (its plain version
    here) and no K11, a trivial one none."""
    engine, ref = _port_engine(port_db, n_shards), _ref_engine(n_shards)
    for filter_json in _filters(port_db):
        flt, ref_flt = Query(_body(filter_json)).filter, RefQuery(
            _body(filter_json)).filter
        want = ref.count(ref_flt)
        assert engine.count(flt) == want, filter_json
        kernels.reset_counts()
        total = engine.count_async(flt)
        assert total.dtype == torch.int64 and total.dim() == 0
        assert int(total) == int(ref.count_async(ref_flt)) == want
        assert engine.device_filter(flt).popcount() == want
        assert ref.device_filter(ref_flt).popcount() == want
        vm_runs = (kernels.VM_RUN.plain_launches if n_shards == 1
                   else kernels.VM_RUN_SHARDED.plain_launches)
        assert vm_runs == (0 if filter_json in TRIVIAL else 2), filter_json
        assert kernels.POPCOUNT_WORDS.plain_launches == 0


@pytest.mark.parametrize("n_shards", [1, 4])
def test_mutations_match_jax(port_db, monkeypatch, n_shards):
    """A Mutations filter's total and matrices from the device filter, and
    whole Mutations answers through the query engines, equal the JAX
    package's."""
    from lapis_silo_torch.query.engine import QueryEngine

    engine, ref = _port_engine(port_db, n_shards), _ref_engine(n_shards)
    # the Mutations action reduces on the database's device engine
    monkeypatch.setattr(port_db, "device_engine", engine, raising=False)
    port = QueryEngine(port_db, engine)
    filters = _filters(port_db)[:4] + [
        {"type": "HasNucleotideMutation", "position": 100}] + TRIVIAL
    for filter_json in filters:
        flt, ref_flt = Query(_body(filter_json)).filter, RefQuery(
            _body(filter_json)).filter
        got, want = engine.device_filter(flt), ref.device_filter(ref_flt)
        assert got.popcount() == want.popcount(), filter_json
        got_m = engine.mutation_counts_many("nuc", ["main"], got)["main"]
        want_m = ref.mutation_counts_many("nuc", ["main"], want)["main"]
        np.testing.assert_array_equal(got_m, want_m)
        body = _body(filter_json, {"type": "Mutations",
                                   "minProportion": 0.05})
        assert port.execute(body) == ref.db.execute_query(body), filter_json


@pytest.mark.parametrize("n_shards", [1, 4])
def test_evaluate_compact_matches_jax(port_db, monkeypatch, n_shards):
    """evaluate_compact, its blocks from the VM launch, equals the JAX
    engine's and evaluate() below and above the cap; K10's wrapper never
    runs."""
    engine, ref = _port_engine(port_db, n_shards), _ref_engine(n_shards)
    for target in (engine, ref):
        monkeypatch.setattr(target, "COMPACT_MIN_WORDS", 0)
        monkeypatch.setattr(target, "COMPACT_CAP_WORDS", 12)
    kernels.reset_counts()
    for filter_json in _filters(port_db):
        got = engine.evaluate_compact(Query(_body(filter_json)).filter)
        want = ref.evaluate_compact(RefQuery(_body(filter_json)).filter)
        plain = engine.evaluate(Query(_body(filter_json)).filter)
        for g, w, p in zip(got, want, plain):
            np.testing.assert_array_equal(g, w, err_msg=f"{filter_json}")
            np.testing.assert_array_equal(g, p, err_msg=f"{filter_json}")
    assert kernels.COMPACT_NONZERO.plain_launches == 0


@functools.cache
def _ref_step(n_shards, n_rows, n_dyn, n_words, program_len):
    return RefStep(ref_make_mesh(jax.devices()[:n_shards]), 1, n_rows,
                   n_dyn, n_words, program_len)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_step_count_matches_jax(port_db, n_shards):
    """ShardedQueryStep's count, from the VM launch, equals the JAX step's
    on as many virtual devices, for each sampled program."""
    engine = _port_engine(port_db, 4)
    bank = to_host(gather_words(engine.banks, CPU))
    full = to_host(gather_words(engine.fulls, CPU))
    devices = [CPU] * n_shards
    for query in sample_count_queries(port_db, 6, seed=3):
        program = engine.lower(Query(query).filter)[0]
        bucket = next(b for b in vm._LEN_BUCKETS if b >= len(program.opcodes))
        code = vm.pack_code_array(bucket, program.opcodes, program.operands,
                                  program.regspec)
        dyn = np.zeros((max(1, len(program.dyn_rows)), bank.shape[1]),
                       dtype=np.uint32)
        for di, rows in enumerate(program.dyn_rows):
            for pi, row in enumerate(rows):
                dyn[di, pi * engine.n_words:pi * engine.n_words + len(row)] = row
        _words, want, _muts = _ref_step(n_shards, bank.shape[0], dyn.shape[0],
                                        bank.shape[1], code.shape[1])(
            code, bank, dyn, full, 0)
        step = ShardedQueryStep(devices, bank.shape[1])
        kernels.reset_counts()
        words, count, _muts = step(code, split_words(bank, devices),
                                   split_words(dyn, devices),
                                   split_words(full, devices), 0)
        assert count.dtype == torch.int32 and int(count) == int(want)
        assert kernels.POPCOUNT_WORDS.plain_launches == 0


def _filter_at_cap(engine):
    """An Or of mutation leaves that lowers to exactly the lowering's
    largest program (vm._LEN_BUCKETS[-1] instructions)."""
    cap = vm._LEN_BUCKETS[-1]
    for n_mut in range(70, 90):
        for n_eq in range(0, 12):
            children = ([{"type": "HasNucleotideMutation", "position": p}
                         for p in range(1, n_mut + 1)]
                        + [{"type": "NucleotideEquals", "position": p,
                            "symbol": "A"}
                           for p in range(200, 200 + n_eq)])
            filter_json = {"type": "Or", "children": children}
            try:
                program = engine.lower(Query(_body(filter_json)).filter)[0]
            except vm.ProgramTooLarge:
                break
            if len(program.opcodes) == cap:
                return filter_json
    raise AssertionError("no filter lowers to the cap")


@pytest.mark.parametrize("n_shards", [1, 4])
def test_a_filter_at_the_length_cap_runs_on_the_device_route(
        port_db, monkeypatch, n_shards):
    """A program of the lowering's largest length takes its total and
    blocks from the same launch (no instruction is appended, so none
    becomes ProgramTooLarge): count_async, device_filter and
    evaluate_compact equal the JAX engine's."""
    engine, ref = _port_engine(port_db, n_shards), _ref_engine(n_shards)
    filter_json = _filter_at_cap(engine)
    flt, ref_flt = Query(_body(filter_json)).filter, RefQuery(
        _body(filter_json)).filter
    want = int(ref.count_async(ref_flt))
    kernels.reset_counts()
    assert int(engine.count_async(flt)) == want
    assert engine.device_filter(flt).popcount() == want
    assert (kernels.VM_RUN.plain_launches
            + kernels.VM_RUN_SHARDED.plain_launches) >= 2
    for target in (engine, ref):
        monkeypatch.setattr(target, "COMPACT_MIN_WORDS", 0)
    for g, w in zip(engine.evaluate_compact(flt),
                    ref.evaluate_compact(ref_flt)):
        np.testing.assert_array_equal(g, w)


# -- the epilogue's host-side layout, emulated --------------------------------

def _parts(rng, widths, fill):
    """int32 shards of `widths` words, each with `fill` non-zero words
    (some with bit 31 set, word 0 among them in every other shard)."""
    parts = []
    for d, n in enumerate(widths):
        words = np.zeros(n, dtype=np.uint32)
        hot = rng.choice(n, size=min(fill, n), replace=False)
        if hot.size and d % 2 and 0 not in hot:
            hot[0] = 0
        words[hot] = rng.integers(1, 1 << 32, size=hot.size, dtype=np.uint64)
        words[hot[::3]] |= np.uint32(0x80000000)
        parts.append(torch.from_numpy(words.view(np.int32)))
    return parts


def _tail_emulate(parts, offsets, cap, lane_words, vec):
    """The epilogue of csrc/vm_run_sharded.cu (and csrc/vm_run.cu's, whose
    one shard is laid out as K6's at 4 or 1 words a lane, vec 1) on the CPU
    over one card's shards of reg[0] words `parts`: the plan from
    kernels.card_tail, its table read back from kernels.k6_block as the
    kernel reads it. Each tile, in ticket order, finds its shard, its 4
    warps their word blocks and each lane its runs of `vec` words (the
    tile's words in the kernel's group order must ascend), takes its prefix
    from the totals its shard's earlier tiles published and writes its
    ranks below cap; the shard's last tile writes the count. Then each fill
    CTA finds its shard by the first fill CTAs and fills its share of the
    slots past the count. Asserts that every word is read exactly once and
    every slot written exactly once. Returns (total, blocks)."""
    widths = tuple(part.shape[0] for part in parts)
    blocks = torch.zeros((len(parts), 1 + 2 * cap), dtype=torch.int32)
    table, n_tiles, need, n_fill = kernels.card_tail(
        widths, lane_words, blocks, offsets, cap)
    program = kernels.k6_program(torch.zeros((2, 4), dtype=torch.int32), 4,
                                 np.array([0, 4], dtype=np.int32), 1, 4,
                                 lane_words)
    shards = np.zeros((len(parts), kernels.SHARD_FIELDS), dtype=np.int64)
    block, where = kernels.k6_block(shards, program, pin=False, tails=table)
    lo = where["tails"] // 4
    tails = block.numpy()[lo:lo + 2 * kernels.TAIL_FIELDS * len(parts)].view(
        np.int64).reshape(len(parts), kernels.TAIL_FIELDS)
    assert need >= kernels.TAIL_HEAD + n_tiles, "the descriptors do not fit"
    block_words, runs = 32 * lane_words, lane_words // vec
    host = [part.numpy().view(np.uint32) for part in parts]
    out = np.zeros((len(parts), 1 + 2 * cap), dtype=np.int64)
    written = np.zeros(out.shape, dtype=np.int64)
    covered = [np.zeros(n, dtype=np.int64) for n in widths]
    published, total = {}, 0
    warp, run, lane, word = np.meshgrid(np.arange(4), np.arange(runs),
                                        np.arange(32), np.arange(vec),
                                        indexing="ij")

    def shard_of(number, column):
        s = 0
        while s + 1 < len(parts) and tails[s + 1][column] <= number:
            s += 1
        return s, [int(v) for v in tails[s]]

    for tile in range(n_tiles):
        s, (out_addr, offset, tile_lo, tiles, _lo, _n) = shard_of(tile, 2)
        assert (out_addr, offset) == (blocks[s].data_ptr(), offsets[s])
        assert tile_lo <= tile < tile_lo + tiles, "a tile outside its shard"
        n = widths[s]
        wblock = (tile - tile_lo) * 4 + warp
        w0 = wblock * block_words + vec * lane
        live = (wblock < -(-n // block_words)) & (w0 + 32 * vec * run < n)
        idx = (w0 + 32 * vec * run + word).reshape(-1)
        live = live.reshape(-1)
        assert (idx[live] < n).all(), "a run past the shard"
        assert (np.diff(idx[live]) > 0).all(), "groups out of word order"
        covered[s][idx[live]] += 1
        vals = np.zeros(idx.size, dtype=np.uint32)
        vals[live] = host[s][idx[live]]
        total += int(np.bitwise_count(vals).sum())
        hot = np.flatnonzero(vals)
        excl = sum(published[t] for t in range(tile_lo, tile))
        published[tile] = hot.size
        rank = excl + np.arange(hot.size)
        keep = rank < cap
        out[s, 1 + rank[keep]] = offset + idx[hot[keep]]
        out[s, 1 + cap + rank[keep]] = vals[hot[keep]].view(np.int32)
        written[s, 1 + rank[keep]] += 1
        written[s, 1 + cap + rank[keep]] += 1
        if tile == tile_lo + tiles - 1:
            out[s, 0] = excl + hot.size
            written[s, 0] += 1
    for fill in range(n_fill):
        s, (_out, offset, _tlo, _tiles, fill_lo, fills) = shard_of(fill, 4)
        assert fill_lo <= fill < fill_lo + fills, "a fill CTA outside its shard"
        assert written[s, 0] == 1, "no count for a fill to wait on"
        count, n, part = int(out[s, 0]), widths[s], fill - fill_lo
        if count >= cap:
            continue
        chunk = -(-(cap - count) // fills)
        a = count + part * chunk
        b = min(cap, a + chunk)
        if a < b:
            word0 = int(host[s][0].view(np.int32)) if n else 0
            out[s, 1 + a:1 + b] = offset
            out[s, 1 + cap + a:1 + cap + b] = word0
            written[s, 1 + a:1 + b] += 1
            written[s, 1 + cap + a:1 + cap + b] += 1
    for cover in covered:
        assert (cover == 1).all(), "a word not read exactly once"
    assert (written == 1).all(), "a slot not written exactly once"
    return total, out.astype(np.int32)


# (lane_words, vec, widths, cap): K1's wide and narrow forms over one
# shard; K6's wide forms (16-byte runs need widths that are multiples of 4)
# and its narrow one over shards that cross tiles, an empty shard among them
LAYOUTS = [
    (4, 1, [2600], 40),
    (1, 1, [5], 3),
    (8, 4, [1024, 0, 2600, 8], 40),
    (8, 1, [1023, 1, 3 * 1024 + 5], 2),
    (1, 1, [127, 0, 129, 600], 16384),
]


@pytest.mark.parametrize("case", range(len(LAYOUTS)))
@pytest.mark.parametrize("fill", [0, 1, 39, 400])
def test_tail_emulation_equals_plain(case, fill):
    lane_words, vec, widths, cap = LAYOUTS[case]
    rng = np.random.default_rng(case * 100 + fill)
    parts = _parts(rng, widths, fill)
    offsets = [1000 + sum(widths[:d]) for d in range(len(widths))]
    total, blocks = _tail_emulate(parts, offsets, cap, lane_words, vec)
    want = torch.cat(kernels.compact_nonzero_sharded_plain(parts, offsets,
                                                          cap)).numpy()
    np.testing.assert_array_equal(blocks, want)
    assert total == int(kernels.popcount_words_sharded_plain(parts))


# the layout the mutations start from, kept before a test replaces it
_TAIL_LAYOUT = kernels.tail_layout.__wrapped__
_TAIL_TABLE = kernels.tail_table


def _restart_tiles(widths, block_words):
    """Mutation: every shard's tiles numbered from 0."""
    rows, n_tiles = _TAIL_LAYOUT(widths, block_words)
    return tuple((0, tiles) for _first, tiles in rows), max(
        tiles for _first, tiles in rows)


def _tiles_of_eight_blocks(widths, block_words):
    """Mutation: a tile counted as 8 word blocks, not the 4 warps'."""
    return _TAIL_LAYOUT(widths, 2 * block_words)


def _no_empty_tile(widths, block_words):
    """Mutation: an empty shard gets no tile."""
    rows, lo = [], 0
    for (_first, tiles), n in zip(_TAIL_LAYOUT(widths, block_words)[0],
                                  widths):
        tiles = tiles if n else 0
        rows.append((lo, tiles))
        lo += tiles
    return tuple(rows), lo


def _restart_fills(blocks, offsets, rows, fills):
    """Mutation (of tail_table): every shard's fill CTAs numbered from 0."""
    table = _TAIL_TABLE(blocks, offsets, rows, fills)
    table[:, 4] = 0
    return table


@pytest.mark.parametrize("mutant", [_restart_tiles, _tiles_of_eight_blocks,
                                    _no_empty_tile, _restart_fills],
                         ids=lambda m: m.__name__)
def test_tail_emulation_catches_a_broken_layout(monkeypatch, mutant):
    """Each mutation of the host-side plan fails the emulation on the cases
    above: a word read twice or never, a slot never written, or a tile or
    fill CTA outside its shard."""
    name = "tail_table" if mutant is _restart_fills else "tail_layout"
    monkeypatch.setattr(kernels, name, mutant)
    failed = 0
    for case, (lane_words, vec, widths, cap) in enumerate(LAYOUTS):
        rng = np.random.default_rng(case)
        parts = _parts(rng, widths, 39)
        offsets = [1000 + sum(widths[:d]) for d in range(len(widths))]
        want = torch.cat(kernels.compact_nonzero_sharded_plain(
            parts, offsets, cap)).numpy()
        try:
            _total, got = _tail_emulate(parts, offsets, cap, lane_words, vec)
        except (AssertionError, IndexError, KeyError):
            failed += 1
            continue
        failed += not np.array_equal(got, want)
    assert failed


def test_card_tail_and_tail_table():
    """Tiles per shard from its word blocks in whole tiles of 4, one for an
    empty shard, numbered shard after shard; the buffer's head and one
    descriptor a tile with a cap; the fill CTAs, fill_ctas(cap) a shard
    numbered shard after shard; the table's rows."""
    assert kernels.tail_layout((1024, 0, 1025, 1), 256) == (
        ((0, 1), (1, 1), (2, 2), (4, 1)), 5)
    blocks = torch.zeros((2, 7), dtype=torch.int32)
    table, n_tiles, need, n_fill = kernels.card_tail((600, 40), 4, blocks,
                                                     [7, 607], 3)
    assert (n_tiles, need, n_fill) == (3, kernels.TAIL_HEAD + 3, 2)
    assert table.tolist() == [[blocks[0].data_ptr(), 7, 0, 2, 0, 1],
                              [blocks[1].data_ptr(), 607, 2, 1, 1, 1]]
    table, n_tiles, need, n_fill = kernels.card_tail((600, 40), 4, None,
                                                     None, None)
    assert (need, n_fill) == (kernels.TAIL_HEAD, 0)
    assert table.tolist() == [[0, 0, 0, 2, 0, 0], [0, 0, 2, 1, 0, 0]]
    assert kernels.fill_ctas(16384) == 16 and kernels.fill_ctas(40) == 1
    assert kernels.fill_ctas(1 << 20) == kernels.TAIL_MAX_FILL


def test_wrapper_checks_and_plain_version():
    """A compaction needs the shards' offsets; the plain version's total
    and blocks are the plain popcount and compaction of its words, and its
    words and counts vm_run_sharded_plain's."""
    rng = np.random.default_rng(2)
    pw = 300
    bank = torch.from_numpy(rng.integers(0, 1 << 32, size=(8, pw),
                                         dtype=np.uint32).view(np.int32))
    full = torch.full((pw,), -1, dtype=torch.int32)
    dyn = torch.zeros((1, pw), dtype=torch.int32)
    code = torch.from_numpy(vm.pack_code_array(
        16, [vm.ALU, vm.ALU, vm.EMIT_COUNT], [3, 5, 9],
        [0 | (vm.M_MOVB << 24) | (vm.B_BANK << 28),
         0 | (vm.M_AND << 24) | (vm.B_BANK << 28), vm.NO_DST]))
    args = (code, 4, [bank[:, :100], bank[:, 100:]],
            [dyn[:, :100], dyn[:, 100:]], [dyn[:, :100], dyn[:, 100:]],
            [full[:100], full[100:]], 4)
    args = tuple(a if not isinstance(a, list) else [t.contiguous() for t in a]
                 for a in args)
    with pytest.raises(ValueError, match="offsets"):
        kernels.vm_filter_sharded(*args, cap=4)
    out = kernels.vm_filter_sharded(*args, offsets=[0, 100], cap=4)
    words, counts = kernels.vm_run_sharded_plain(*args)
    for g, w in zip(out.words, words):
        assert torch.equal(g, w)
    assert torch.equal(out.counts, counts)
    assert int(out.total) == int(kernels.popcount_words_sharded_plain(words))
    assert int(out.counts[9]) == int(out.total)
    for g, w in zip(out.blocks, kernels.compact_nonzero_sharded_plain(
            words, [0, 100], 4)):
        assert torch.equal(g, w)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _random_program(rng, n: int, n_rows: int):
    """A random single program of `n` instructions over every mode and
    b-source, EMITs among them (operands in and out of range)."""
    opcodes = rng.choice([vm.ALU] * 6 + [vm.EMIT_COUNT, vm.NOP], size=n)
    operands = rng.integers(-4, n_rows + 4, size=n)
    emits = opcodes == vm.EMIT_COUNT
    operands[emits] = rng.choice([0, 1, 4095, 4096, -1], size=int(emits.sum()))
    regspec = (rng.integers(0, 8, size=n) | (rng.integers(0, 8, size=n) << 8)
               | (rng.integers(0, 8, size=n) << 16)
               | (rng.integers(0, 5, size=n) << 24)
               | (rng.integers(1, 5, size=n) << 28))
    return torch.from_numpy(vm.pack_code_array(512, opcodes, operands,
                                               regspec))


@pytest.mark.cuda
def test_fused_launch_on_card(cuda_device):
    """vm_filter_sharded on the card against K10 and K11 on its words and
    against its plain version, bit-exact: one shard (K1, narrow and wide
    forms for the total, the wide form compacting), 4 shards of one card
    and 3 of ragged widths over the visible cards (K6); caps under and over
    the fill; one VM launch per card and no K10 or K11."""
    rng = np.random.default_rng(15)
    n_cards = torch.cuda.device_count()
    for pw, splits, cards in (
            (2048, [2048], [cuda_device]),
            (65536, [65536], [cuda_device]),
            (32768, [8192] * 4, [cuda_device] * 4),
            (9001, [3000, 1, 6000],
             [torch.device("cuda", d % n_cards) for d in range(3)])):
        bank = rng.integers(0, 1 << 32, size=(32, pw), dtype=np.uint32)
        bank[:, rng.random(pw) < 0.95] = 0
        full = np.full(pw, 0xFFFFFFFF, dtype=np.uint32)
        full[-1] = 0x7
        edges = np.cumsum([0] + splits)
        on = [[torch.from_numpy(np.ascontiguousarray(
            a[..., lo:hi]).view(np.int32)).to(card)
            for lo, hi, card in zip(edges, edges[1:], cards)]
            for a in (bank, bank[:2], bank[:1], full)]
        offsets = [int(lo) for lo in edges[:-1]]
        for n_instr in (8, 96):
            code = _random_program(rng, n_instr, 32)
            args = (code, n_instr, *on, 8)
            for cap in (None, 4, 400, 16384):
                kw = {} if cap is None else {"offsets": offsets, "cap": cap}
                kernels.reset_counts()
                got = kernels.vm_filter_sharded(*args, **kw)
                vm_launches = (kernels.VM_RUN.launches
                               + kernels.VM_RUN_SHARDED.launches)
                assert vm_launches == len(set(cards))
                assert (kernels.COMPACT_NONZERO.launches,
                        kernels.POPCOUNT_WORDS.launches) == (0, 0)
                want = kernels.vm_filter_sharded_plain(*args, **kw)
                for g, w in zip(got.words, want.words):
                    assert torch.equal(g.cpu(), w.cpu()), (pw, cap)
                assert torch.equal(got.counts.cpu(), want.counts.cpu())
                assert int(got.total) == int(want.total)
                assert int(got.total) == int(
                    kernels.popcount_words_sharded(got.words))
                if cap is None:
                    continue
                k10 = kernels.compact_nonzero_sharded(got.words, offsets, cap)
                for g, w, k in zip(got.blocks, want.blocks, k10):
                    assert torch.equal(g.cpu(), w.cpu()), (pw, cap)
                    assert torch.equal(g.cpu(), k.cpu()), (pw, cap)


@pytest.mark.cuda
def test_engine_routes_on_card(cuda_device, port_db, monkeypatch):
    """On the card, on one shard and on 4: count_async, device_filter and
    evaluate_compact equal their CPU engine's, each query one VM launch
    per card and no K10 or K11."""
    cpu_engine = _port_engine(port_db, 1)
    for devices in (None, [cuda_device] * 4):
        engine = DeviceEngine(port_db, cuda_device, devices=devices)
        monkeypatch.setattr(engine, "COMPACT_MIN_WORDS", 0)
        for filter_json in _filters(port_db):
            flt = Query(_body(filter_json)).filter
            want = cpu_engine.count(flt)
            kernels.reset_counts()
            assert int(engine.count_async(flt)) == want
            assert engine.device_filter(flt).popcount() == want
            for g, w in zip(engine.evaluate_compact(flt),
                            cpu_engine.evaluate(flt)):
                np.testing.assert_array_equal(g, w)
            launches = kernels.VM_RUN.launches + kernels.VM_RUN_SHARDED.launches
            assert launches == (0 if filter_json in TRIVIAL else 3)
            assert (kernels.COMPACT_NONZERO.launches,
                    kernels.POPCOUNT_WORDS.launches) == (0, 0)
