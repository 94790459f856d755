"""The port's word-sharded engine against the JAX package's mesh engine.

One process holds one word shard per entry of `devices` (here repeats of
the CPU); the JAX package shards over the 8 virtual CPU devices
(tests/conftest.py). The sharded wrappers' plain versions are held to
vm_run_sharded / mutation_counts_banked_sharded in interpret mode, the
window-local densify to vm._densify_one with w_off, the entry-split sparse
counts to _sparse_mutation_counts_sharded_jit, and the sharded engine, with
4 and 8 shards, to the JAX mesh engine and the host oracle on both tiers and
every pool route. Each package serves its own corpus from the same seed and
parses the queries itself. K6's host layout (ranges of whole segments,
register offsets, range-local EMIT slots, the shard table and block) is
held to the plain sharded VM through a CPU emulation of the kernel. Every
value is an integer or a word: the tolerance is equality. The CUDA
launches are held to the plain versions on the card (marked `cuda`)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lapis_silo_torch
from lapis_silo_tpu import testing as ref_testing
from lapis_silo_tpu.ops import device_engine as ref_de
from lapis_silo_tpu.ops import pallas_kernels as pk
from lapis_silo_tpu.ops import reductions as ref_reductions
from lapis_silo_tpu.ops import vm as ref_vm
from lapis_silo_tpu.parallel.mesh import make_mesh
from lapis_silo_tpu.query.engine import Query as RefQuery
from lapis_silo_torch.ops import kernels, reductions, vm
from lapis_silo_torch.ops.words import popcount
from lapis_silo_torch.ops.device_engine import (
    DeviceEngine, build_state, state_from_reference,
)
from lapis_silo_torch.parallel.shards import ShardLayout, gather_words, reduce_sum
from lapis_silo_torch.query import ast
from lapis_silo_torch.query.engine import Query, QueryEngine
from lapis_silo_torch.query.ir import HostEvaluator
from lapis_silo_torch.testing import sample_count_queries, synthetic_database

from .test_torch_sparse import _combined, _stream
from .test_torch_vm import _bank, _program, _random_segments, _run_xla

CPU = torch.device("cpu")
# 2,048 sequences in 3 partitions: 22 words per partition, padded to 24 on 4
# and 8 shards, whose windows (18 and 9 words) straddle partition edges
DENSE = dict(n_rows=2048, length=256, n_partitions=3)
TWO_TIER = dict(n_rows=2048, length=256, n_partitions=3, mutations_per_genome=2)


def _t(array):
    return torch.from_numpy(np.ascontiguousarray(array).view(np.int32))


def _split(array, n_shards):
    """Host words [..., PW] -> n_shards CPU tensors [..., PW/n_shards]."""
    return [_t(part) for part in np.split(array, n_shards, axis=-1)]


def _words(parts):
    return gather_words(parts, "cpu").numpy().view(np.uint32)


def _host_words(db, filter_expr, pi):
    node = filter_expr.compile(db, db.partitions[pi], ast.NONE)
    return HostEvaluator(db.partitions[pi].sequence_count).evaluate(node)


def _host_count(db, filter_expr):
    return sum(int(np.bitwise_count(_host_words(db, filter_expr, pi)).sum())
               for pi in range(len(db.partitions)))


def _filters(queries):
    return [Query(q).filter for q in queries]


def _ref_filters(queries):
    return [RefQuery(q).filter for q in queries]


# -- (a) the sharded wrappers ----------------------------------------------

@pytest.mark.parametrize("n_shards,n_regs,pw,wild", [
    (4, 8, 2048, True), (8, 16, 2048, True), (8, 4, 296, False),
    (3, 32, 300, True)])
def test_plain_vm_run_sharded_matches_xla_interpreter(n_shards, n_regs, pw,
                                                      wild):
    """The cases of tests/test_torch_vm.py, sharded: summing each shard's
    last-EMIT popcounts gives the global last-EMIT count, so words and
    counts equal the XLA interpreter's over the whole word axis, clamped
    operands and repeated and out-of-range EMITs included."""
    rng = np.random.default_rng(n_shards * 100 + n_regs)
    bank, dyn, sparse, full = _bank(rng, pw)
    ops, opers, specs = _program(rng, 40, n_regs, wild)
    n_instr = vm._round_instr(len(ops))
    code = vm.pack_code_array(64, ops, opers, specs)
    want_words, want_counts = _run_xla(code, n_instr, bank, dyn, sparse, full,
                                       n_regs)
    before = kernels.VM_RUN_SHARDED.plain_launches
    words, counts = kernels.vm_run_sharded(
        _t(code), n_instr, _split(bank, n_shards), _split(dyn, n_shards),
        _split(sparse, n_shards), _split(full, n_shards), n_regs)
    assert kernels.VM_RUN_SHARDED.plain_launches == before + 1
    assert len(words) == n_shards and counts.dtype == torch.int32
    np.testing.assert_array_equal(_words(words), want_words)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    plain_words, plain_counts = kernels.vm_run_sharded_plain(
        _t(code), n_instr, _split(bank, n_shards), _split(dyn, n_shards),
        _split(sparse, n_shards), _split(full, n_shards), n_regs)
    np.testing.assert_array_equal(_words(plain_words), want_words)
    assert torch.equal(plain_counts, counts)


@pytest.mark.parametrize("n_shards,n_regs,pw,n_cuts", [
    (3, 8, 300, 4), (4, 16, 2048, 9), (8, 32, 2048, 20)])
def test_plain_vm_run_sharded_segments_match_unsharded(n_shards, n_regs, pw,
                                                       n_cuts):
    """Random segment lists over wild programs, sharded: each shard runs
    every segment on its own words, so the words and the summed counts equal
    the unsharded segmented run (held to the XLA interpreter segment by
    segment in tests/test_torch_vm.py)."""
    rng = np.random.default_rng(n_shards * 10 + n_cuts)
    bank, dyn, sparse, full = _bank(rng, pw)
    ops, opers, specs = _program(rng, 40, n_regs, wild=True)
    n_instr = vm._round_instr(len(ops))
    code = _t(vm.pack_code_array(128, ops, opers, specs))
    starts = _random_segments(rng, n_instr, n_cuts)
    want_words, want_counts = kernels.vm_run_plain(
        code, n_instr, _t(bank), _t(dyn), _t(sparse), _t(full), n_regs, starts)
    shards = [_split(a, n_shards) for a in (bank, dyn, sparse, full)]
    for run in (kernels.vm_run_sharded, kernels.vm_run_sharded_plain):
        words, counts = run(code, n_instr, *shards, n_regs, starts)
        assert torch.equal(gather_words(words, "cpu"), want_words)
        assert torch.equal(counts, want_counts)


def test_plain_vm_run_sharded_matches_mosaic_on_mesh():
    """vm_run_sharded over the 8-device mesh in interpret mode (the Mosaic
    kernel per shard, psum of the counts) on a program where the Mosaic and
    XLA forms agree (each EMIT slot written once)."""
    mesh = make_mesh(jax.devices()[:8])
    rng = np.random.default_rng(11)
    pw, n_regs = 8 * 2 * 128, 8
    bank, dyn, sparse, full = _bank(rng, pw)
    ops, opers, specs = _program(rng, 16, n_regs, wild=False)
    n_emits = ops.count(vm.EMIT_COUNT)
    code = vm.pack_code_array(64, ops, opers, specs)
    n_instr = vm._round_instr(len(ops))
    want_words, want_counts = pk.vm_run_sharded(
        mesh, "seq", jnp.asarray(code[0]), jnp.asarray(code[1]),
        jnp.asarray([n_instr], dtype=np.int32),
        jnp.asarray(bank.reshape(bank.shape[0], pw // 128, 128)),
        jnp.asarray(dyn), jnp.asarray(sparse), jnp.asarray(full),
        n_regs=n_regs, interpret=True)
    words, counts = kernels.vm_run_sharded(
        _t(code), n_instr, _split(bank, 8), _split(dyn, 8), _split(sparse, 8),
        _split(full, 8), n_regs)
    np.testing.assert_array_equal(_words(words), np.asarray(want_words))
    np.testing.assert_array_equal(counts.numpy()[:n_emits],
                                  np.asarray(want_counts)[:n_emits])


@pytest.mark.parametrize("n_shards", [4, 8])
def test_plain_mutation_counts_sharded_matches_mosaic_on_mesh(n_shards):
    """mutation_counts_banked_sharded over the 8-device mesh in interpret
    mode, against the port's sum over 4 and 8 shards (a row-block-aligned
    start, as the TPU kernel takes)."""
    mesh = make_mesh(jax.devices()[:8])
    rng = np.random.default_rng(n_shards)
    n_rows, pw = 2 * pk.ROW_BLOCK, 8 * 3 * 128
    bank = rng.integers(0, 2**32, size=(n_rows, pw), dtype=np.uint32)
    filters = rng.integers(0, 2**32, size=pw, dtype=np.uint32)
    start, n_seg = pk.ROW_BLOCK, pk.ROW_BLOCK
    want = np.asarray(pk.mutation_counts_banked_sharded(
        mesh, "seq", jnp.asarray(bank.reshape(n_rows, pw // 128, 128)),
        jnp.asarray(filters), start, n_seg, pw, interpret=True))
    before = kernels.MUTATION_COUNTS_SHARDED.plain_launches
    got = kernels.mutation_counts_sharded(
        _split(bank, n_shards), _split(filters, n_shards), start, n_seg)
    assert kernels.MUTATION_COUNTS_SHARDED.plain_launches == before + 1
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(kernels.mutation_counts_sharded_plain(
        _split(bank, n_shards), _split(filters, n_shards), start, n_seg), got)


def test_sharded_wrappers_check_their_shards():
    """One entry per shard in every list, one device type across shards."""
    pw, n = 64, 4
    parts = [torch.zeros(pw // n, dtype=torch.int32) for _ in range(n)]
    banks = [torch.zeros((3, pw // n), dtype=torch.int32) for _ in range(n)]
    with pytest.raises(ValueError):
        kernels.mutation_counts_sharded(banks[:-1], parts, 0, 3)
    mixed = parts[:-1] + [torch.zeros(pw // n, dtype=torch.int32,
                                      device="meta")]
    with pytest.raises(ValueError):
        kernels.mutation_counts_sharded(banks, mixed, 0, 3)
    with pytest.raises(ValueError):
        ShardLayout([CPU, torch.device("meta")], 1, 64)
    with pytest.raises(ValueError):
        ShardLayout([CPU] * 3, 2, 64)  # 64 words do not split in 3
    layout = ShardLayout([CPU] * 8, 3, 24)
    assert layout.local_words == 9 and layout.distinct == (CPU,)
    assert [layout.partitions(d) for d in range(8)] == [
        (0, 1), (0, 1), (0, 2), (1, 2), (1, 2), (1, 3), (2, 3), (2, 3)]
    counts = reduce_sum([torch.tensor([1, 2], dtype=torch.int32)] * 3, CPU)
    assert counts.dtype == torch.int32 and counts.tolist() == [3, 6]


# -- (a2) K6's layout on the host --------------------------------------------

A, B, C = "card a", "card b", "card c"  # device keys: any hashable serves


def _fake_shard(d, n_rows=89709, width=None):
    """Shard d's (bank, rows, dyn, rows, sparse, rows, full, words, width)
    with fake pointers past 2^40 and a width of its own."""
    ptr = [(1 << 40) * (d + 1) + 4096 * f for f in range(5)]
    return (ptr[0], n_rows, ptr[1], 3, ptr[2], 2, ptr[3], ptr[4],
            523 + d if width is None else width)


@pytest.mark.parametrize("devices,groups", [
    ([A, A, B, B], [(A, 0, [0, 1]), (B, 2, [2, 3])]),
    ([A, B, A], [(A, 0, [0, 2]), (B, 2, [1])]),
    ([B, A, C, A, B], [(B, 0, [0, 4]), (A, 2, [1, 3]), (C, 4, [2])]),
    ([A] * 4, [(A, 0, [0, 1, 2, 3])]),
])
def test_shard_table_groups_shards_by_card_in_first_seen_order(devices,
                                                               groups):
    """Fake device keys and pointers: the shards grouped by card in
    first-seen order, each row the shard's pointers, row counts and own
    width (ragged across shards); in K6's block the table starts at 0
    (8-byte aligned), the code follows it, and every part reads back as
    packed."""
    shards = [_fake_shard(d) for d in range(len(devices))]
    got, table = kernels.shard_table(devices, shards)
    assert got == groups
    order = [d for _device, _row, members in got for d in members]
    assert table.dtype == np.int64
    assert table.shape == (len(devices), kernels.SHARD_FIELDS)
    for row, d in enumerate(order):
        assert tuple(table[row, :-1].tolist()) == shards[d]
        assert table[row, -1] == 0
    rng = np.random.default_rng(len(devices))
    ops, opers, specs = _program(rng, 30, 8, wild=True)
    n_instr = vm._round_instr(len(ops))
    program = kernels.k6_program(_t(vm.pack_code_array(64, ops, opers, specs)),
                                 n_instr, _random_segments(rng, n_instr, 5), 3,
                                 8, 8)
    block, offsets = kernels.k6_block(table, program, pin=False)
    assert offsets["shards"] == 0
    assert offsets["opers"] == 8 * kernels.SHARD_FIELDS * len(devices)
    host = block.numpy()
    parts = list(offsets.items())
    ends = [offset for _name, offset in parts[1:]] + [4 * host.size]
    read = {name: host[offset // 4: end // 4]
            for (name, offset), end in zip(parts, ends)}
    np.testing.assert_array_equal(read["shards"].view(np.int64).reshape(
        table.shape), table)
    for name in ("opers", "specs", "regw", "aux", "range_lo", "slot_off",
                 "range_slots"):
        np.testing.assert_array_equal(read[name], getattr(program, name))


@pytest.mark.parametrize("shard", [_fake_shard(0, n_rows=1 << 31),
                                   _fake_shard(0, width=1 << 30)])
def test_shard_table_refuses_what_k6_cannot_address(shard):
    """K6 addresses rows with 32-bit counts and byte strides: a row count
    from 2^31 or a width from 2^30 words is refused."""
    with pytest.raises(ValueError, match="K6 takes"):
        kernels.shard_table([A, A], [shard, _fake_shard(1)])


def _k6_emulate(code, n_instr, shards, n_regs, starts, n_ranges,
                lane_words=8):
    """K6 as k6_program lays the program out and the kernel runs it, in
    plain torch on the CPU, per shard (bank, dyn, sparse, full): each
    range's instructions in order, the registers zeroed at each
    K6_SEG_START, ra, rb and the destination taken from the host's byte
    offsets (128 lane_words bytes a register), the counted EMITs'
    popcounts added into the range's slots and those into the counts;
    reg[0] after the last range, or zeros where the program says so."""
    program = kernels.k6_program(code, n_instr, starts, n_ranges, n_regs,
                                 lane_words)
    stride = 128 * lane_words
    counts = torch.zeros(vm.MAX_BATCH_QUERIES, dtype=torch.int32)
    words = []
    for bank, dyn, sparse, full in shards:
        rows = {vm.B_BANK: bank, vm.B_DYN: dyn, vm.B_SPARSE: sparse}
        regs = torch.zeros((n_regs + 1, full.shape[0]), dtype=torch.int32)
        for r in range(program.range_lo.shape[0] - 1):
            acc = torch.zeros(max(program.max_slots, 1), dtype=torch.int32)
            for i in range(program.range_lo[r], program.range_lo[r + 1]):
                oper, spec, regw, aux = (int(part[i]) for part in (
                    program.opers, program.specs, program.regw, program.aux))
                if aux & kernels.K6_SEG_START:
                    regs.zero_()
                a = regs[(regw & 0xFFFF) // stride]
                bsrc = (spec >> vm.WIRE_BSRC_SHIFT) & 0xF
                if bsrc == vm.B_REG:
                    b = regs[(regw >> 16) // stride]
                elif bsrc in rows:
                    b = rows[bsrc][min(max(oper, 0), rows[bsrc].shape[0] - 1)]
                else:
                    b = full if bsrc == vm.B_FULL else torch.zeros_like(full)
                mode = (spec >> vm.WIRE_MODE_SHIFT) & 0xF
                val = (b if mode == vm.M_MOVB else a & b if mode == vm.M_AND
                       else a | b if mode == vm.M_OR
                       else a ^ b if mode == vm.M_XOR else a & (b ^ full))
                if aux & kernels.K6_SLOT_MASK:
                    acc[(aux & kernels.K6_SLOT_MASK) - 1] += popcount(a).sum()
                regs[(aux >> kernels.K6_DST_SHIFT) // stride] = val
            lo, hi = program.slot_off[r], program.slot_off[r + 1]
            counts[torch.from_numpy(program.range_slots[lo:hi]).long()] += (
                acc[:hi - lo])
        words.append(torch.zeros_like(full) if program.zero_words
                     else regs[0].clone())
    return words, counts, program


@pytest.mark.parametrize("n_shards,n_regs,pw,wild,n_cuts", [
    (2, 1, 64, True, 6), (3, 8, 200, True, 11), (4, 32, 130, True, 0),
    (3, 16, 97, False, 25), (2, 4, 33, True, 40), (4, 8, 256, False, 60)])
@pytest.mark.parametrize("n_ranges,lane_words", [(1, 8), (3, 1), (3, 8),
                                                 (1000, 8)])
def test_k6_layout_matches_plain_sharded_vm(n_shards, n_regs, pw, wild,
                                            n_cuts, n_ranges, lane_words):
    """The layout K6 runs (ranges of whole segments, the registers zeroed at
    each segment's start, a segment's last EMIT per slot counted once into
    range-local slots) gives the plain sharded VM's words and counts, over
    shards of ragged widths: random segments with empty and one-instruction
    ones, EMIT slots repeated inside and across segments, negative and out
    of range (or every slot once, as a batch has it), n_regs 1 and
    MAX_REGS (32), both lane forms (their register strides), and the
    range count that one launch takes, down to one range and up to one per
    segment."""
    rng = np.random.default_rng(n_shards * 1000 + pw + n_ranges)
    bank, dyn, sparse, full = _bank(rng, pw)
    ops, opers, specs = _program(rng, 50, n_regs, wild)
    operands = np.asarray(opers)
    if wild:  # else every slot once, as in a batch
        emits = np.asarray(ops) == vm.EMIT_COUNT
        operands[emits] = rng.choice([0, 1, 2, 4095, 4096, -1, -4096, -4097],
                                     size=int(emits.sum()))
    n_instr = vm._round_instr(len(ops))
    code = _t(vm.pack_code_array(128, ops, operands.tolist(), specs))
    starts = (_random_segments(rng, n_instr, n_cuts) if n_cuts
              else np.asarray([0, n_instr], dtype=np.int32))
    shards = list(zip(*[[_t(part) for part in np.array_split(a, n_shards,
                                                             axis=-1)]
                        for a in (bank, dyn, sparse, full)]))
    words, counts, program = _k6_emulate(code, n_instr, shards, n_regs,
                                         starts, n_ranges, lane_words)
    assert program.range_lo.shape[0] - 1 <= max(n_ranges, 1)
    want_words, want_counts = kernels.vm_run_sharded_plain(
        code, n_instr, *map(list, zip(*shards)), n_regs, starts)
    assert torch.equal(counts, want_counts)
    for got, want in zip(words, want_words):
        assert torch.equal(got, want)


@pytest.mark.parametrize("starts", [[0, 0], [0, 8, 8], [0, 3, 8, 8],
                                    [0, 1, 2, 3, 4, 5, 6, 7, 8]])
def test_k6_layout_edges(starts):
    """No instruction at all, an empty last segment (reg[0] comes out
    zero), and one-instruction segments: the layout still equals the plain
    VM."""
    rng = np.random.default_rng(len(starts))
    bank, dyn, sparse, full = _bank(rng, 40)
    n_instr = starts[-1]
    ops = [vm.ALU, vm.EMIT_COUNT] * 4
    opers = [1, 7, 2, 7, 3, 9, 0, 7]
    specs = [(i % 3) | (vm.M_OR << 24) | (vm.B_BANK << 28) for i in range(8)]
    code = _t(vm.pack_code_array(16, ops, opers, specs))
    starts = np.asarray(starts, dtype=np.int32)
    shards = [tuple(_t(a) for a in (bank, dyn, sparse, full))]
    words, counts, program = _k6_emulate(code, n_instr, shards, 4, starts, 2)
    assert program.zero_words == (n_instr == 0 or starts[-2] == n_instr)
    want_words, want_counts = kernels.vm_run_plain(
        code, n_instr, *shards[0], 4, starts)
    assert torch.equal(words[0], want_words)
    assert torch.equal(counts, want_counts)


# -- (b) window-local densify -----------------------------------------------

@pytest.mark.parametrize("n_shards,n_parts,part_words", [
    (4, 3, 256), (8, 2, 512), (3, 2, 195)])
def test_plain_windowed_densify_matches_xla_window_local(n_shards, n_parts,
                                                         part_words):
    """K4 and K5's plain versions with a window offset against the
    reference's window-local scatter (_densify_one with w_off and
    local_words, as its mesh pool update runs it), for every shard's window,
    and with only the overlapping partitions' segments passed."""
    rng = np.random.default_rng(n_shards * 10 + n_parts)
    n_leaves = 6
    idx, words, starts, lens = _stream(rng, n_leaves, n_parts, part_words,
                                       200, empty=[(1, 0)])
    pw = n_parts * part_words
    local = pw // n_shards
    layout = ShardLayout([CPU] * n_shards, n_parts, part_words)
    comb = _combined(idx, words, pk.COMBINE_BLOCK)
    whole = kernels.densify_rows(_t(idx), _t(words), _t(starts), _t(lens), pw)
    for shard in range(n_shards):
        w_off = shard * local
        want = np.asarray(jax.jit(lambda *a, w=w_off: ref_vm._densify_one(
            n_leaves, 1 << 13, pw, n_parts, *a, w_off=w,
            local_words=local))(comb, jnp.asarray(starts.reshape(-1)),
                                jnp.asarray(lens.reshape(-1))))
        got = kernels.densify_rows(_t(idx), _t(words), _t(starts), _t(lens),
                                   local, w_off)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        assert torch.equal(got, whole[:, w_off:w_off + local])
        p_lo, p_hi = layout.partitions(shard)
        narrow = (_t(starts[:, p_lo:p_hi]), _t(lens[:, p_lo:p_hi]))
        assert torch.equal(kernels.densify_rows(
            _t(idx), _t(words), *narrow, local, w_off), got)
        pool = _t(rng.integers(0, 2**32, size=(n_leaves + 2, local),
                               dtype=np.uint32))
        slots = [n_leaves + 1, 0, 3, 2, 5, 1]
        old = pool.clone()
        kernels.densify_rows_into_pool(pool, _t(idx), _t(words), *narrow,
                                       slots, w_off)
        assert torch.equal(pool[slots], got)
        assert torch.equal(pool[4], old[4])


# -- (c) the entry-split sparse counts --------------------------------------

@pytest.mark.parametrize("n_shards,use_kernel", [
    (8, False), (4, False), (8, True)])
def test_entry_split_sparse_counts_match_sharded_reference(
        n_shards, use_kernel, monkeypatch):
    """The stream's entries split into contiguous chunks, each chunk's
    bounds clipped to it, K3's plain version per chunk against the whole
    filter, and the partials summed: equal to
    _sparse_mutation_counts_sharded_jit over the 8-device mesh (its XLA
    gather, or the Mosaic gather kernel in interpret mode), whose chunks are
    even over its padded stream where the port's are even over the live
    entries."""
    monkeypatch.setenv("SILO_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(n_shards + use_kernel)
    n_leaves, n_parts, part_words = 40, 4, 512
    idx, words, starts, lens = _stream(rng, n_leaves, n_parts, part_words,
                                       120, empty=[(3, 1), (39, 3)])
    filters = rng.integers(0, 2**32, size=n_parts * part_words,
                           dtype=np.uint32)
    mesh = make_mesh(jax.devices()[:8])
    quantum = 8 * (pk.SPARSE_CHUNK if use_kernel else pk.COMBINE_BLOCK)
    run = ref_reductions._sparse_mutation_counts_sharded_jit(mesh, n_parts,
                                                             use_kernel)
    want = np.asarray(run(_combined(idx, words, quantum), jnp.asarray(filters),
                          jnp.asarray(starts.reshape(-1)),
                          jnp.asarray(lens.reshape(-1))))
    chunks = [(_t(idx[lo:hi]), _t(words[lo:hi]), *(
        _t(a.astype(np.int32)) for a in reductions.clip_bounds(
            starts, lens, lo, hi)))
        for lo, hi in reductions.entry_chunks(len(idx), n_shards)]
    got = kernels.sparse_counts_chunked(chunks, [_t(filters)] * n_shards)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    whole = kernels.sparse_counts(_t(idx), _t(words), _t(filters), _t(starts),
                                  _t(lens))
    assert torch.equal(got, whole)


def test_entry_chunks_and_clipping_count_each_entry_once():
    """Any split (more chunks than entries included): the clipped segments
    of all chunks tile each segment exactly."""
    starts = np.array([[0, 5], [5, 9], [9, 9]])
    lens = np.array([[5, 0], [4, 3], [0, 3]])
    for n_chunks in (1, 2, 5, 13, 20):
        chunks = reductions.entry_chunks(12, n_chunks)
        assert chunks[0][0] == 0 and chunks[-1][1] == 12
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        total = sum(reductions.clip_bounds(starts, lens, lo, hi)[1]
                    for lo, hi in chunks)
        np.testing.assert_array_equal(total, lens)


# -- (d) the sharded engine -------------------------------------------------

@pytest.fixture(scope="module")
def dense_db():
    return synthetic_database(**DENSE)


@pytest.fixture(scope="module")
def two_tier_db():
    return synthetic_database(**TWO_TIER)


@pytest.fixture(scope="module")
def dense_ref():
    engine = ref_de.DeviceEngine(ref_testing.synthetic_database(**DENSE),
                                 devices=jax.devices()[:8])
    assert engine.mesh is not None and engine.n_words == 24
    return engine


@pytest.fixture(scope="module")
def two_tier_ref():
    engine = ref_de.DeviceEngine(ref_testing.synthetic_database(**TWO_TIER),
                                 devices=jax.devices()[:8],
                                 sparse_min_words=1)
    assert engine.mesh is not None and engine.n_sparse > 0
    return engine


MUTATION_QUERY = json.dumps({
    "action": {"type": "Aggregated"},
    "filterExpression": {"type": "Or", "children": [
        {"type": "HasNucleotideMutation", "position": 7},
        {"type": "IntBetween", "column": "age", "from": 30, "to": 60}]}})


def _check_engine(port, ref, db, queries, route="pooled"):
    """Counts (per route), evaluate words and Mutations matrices of the port
    against the JAX mesh engine and the host oracle."""
    filters = _filters(queries)
    want = ref.count_batch(_ref_filters(queries))
    assert want == [_host_count(db, f) for f in filters]
    lowered = [port.lower(f)[0] for f in filters]
    if route == "poolless":
        dispatches = port.count_dispatches(lowered, force_poolless=True)
        got = port.count_finish([None] * len(lowered),
                                list(range(len(lowered))), dispatches)
    else:
        got = port.count_programs(lowered)
    assert got == want
    for f, program in zip(filters[:6], lowered):
        assert int(port.count_async(f, program)) == want[filters.index(f)]
        for pi, part in enumerate(port.evaluate(f)):
            np.testing.assert_array_equal(part, _host_words(db, f, pi))
    mut = Query(MUTATION_QUERY).filter
    ref_words = ref.evaluate(RefQuery(MUTATION_QUERY).filter)
    for name in sorted(db.nuc_sequences):
        want_matrix = ref.mutation_counts("nuc", name, ref_words)
        np.testing.assert_array_equal(
            port.mutation_counts("nuc", name, port.evaluate(mut)), want_matrix)
        dev_filter = port.device_filter(mut)
        assert dev_filter.popcount() == _host_count(db, mut)
        np.testing.assert_array_equal(
            port.mutation_counts_many("nuc", [name], dev_filter)[name],
            want_matrix)


@pytest.mark.parametrize("n_shards", [4, 8])
def test_sharded_dense_engine_matches_jax_mesh_and_oracle(dense_db, dense_ref,
                                                          n_shards):
    port = DeviceEngine(dense_db, CPU, devices=[CPU] * n_shards)
    assert len(port.shards) == n_shards and port.n_sparse == 0
    assert port.n_words == 24 and len(port.banks) == n_shards
    assert port.banks[0].shape == (dense_ref.n_rows, 3 * 24 // n_shards)
    kernels.reset_counts()
    _check_engine(port, dense_ref, dense_db,
                  sample_count_queries(dense_db, 24, seed=3))
    assert kernels.VM_RUN_SHARDED.plain_launches > 0
    assert kernels.MUTATION_COUNTS_SHARDED.plain_launches > 0
    assert kernels.VM_RUN.plain_launches >= n_shards * (
        kernels.VM_RUN_SHARDED.plain_launches)


@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("route", ["pooled", "poolless", "no_pool"])
def test_sharded_two_tier_engine_matches_jax_mesh_and_oracle(
        two_tier_db, two_tier_ref, n_shards, route, monkeypatch):
    """The two-tier bank sharded: the pool in [C + 1, PW/D] shards updated
    window-locally (small chunks), the poolless window-local blocks, and an
    engine without a pool; sparse Mutations over the entry-split stream."""
    if route == "no_pool":
        monkeypatch.setenv("SILO_LEAF_POOL", "0")
    port = DeviceEngine(two_tier_db, CPU, sparse_min_words=1,
                        devices=[CPU] * n_shards)
    assert port.n_sparse > 0 and (port.pool_slots > 0) == (route != "no_pool")
    port._pool_update_k_cap = 4
    kernels.reset_counts()
    _check_engine(port, two_tier_ref, two_tier_db,
                  sample_count_queries(two_tier_db, 24, seed=12), route)
    # the poolless route forces the count batch only: its single counts and
    # words ride the pool
    pooled = kernels.DENSIFY_INTO_POOL.plain_launches
    assert (pooled > 0) == (route != "no_pool")
    if route != "no_pool":
        assert len(port.leaf_pool) == n_shards
        assert port.leaf_pool[0].shape == (port.pool_slots + 1,
                                           port.n_flat_words // n_shards)
        assert pooled % n_shards == 0 and port.pool_hits > 0
    if route != "pooled":
        assert kernels.DENSIFY_ROWS.plain_launches % n_shards == 0
        assert kernels.DENSIFY_ROWS.plain_launches > 0
    assert kernels.SPARSE_COUNTS.plain_launches % n_shards == 0
    assert kernels.SPARSE_COUNTS.plain_launches > 0


def test_sharded_engine_matches_jax_mesh_kernel_route(two_tier_db,
                                                      monkeypatch):
    """The JAX mesh engine on its kernel route (bank3 padded to 128 words
    per shard, interpret-mode Mosaic kernels under shard_map, the mesh pool
    and the Mosaic sparse gather) against the port with 8 shards."""
    monkeypatch.setenv("SILO_FORCE_BANK3", "1")
    monkeypatch.setenv("SILO_PALLAS_INTERPRET", "1")
    ref_de._interpreter.cache_clear()
    ref_reductions._sparse_mutation_counts_sharded_jit.cache_clear()
    try:
        ref = ref_de.DeviceEngine(ref_testing.synthetic_database(**TWO_TIER),
                                  devices=jax.devices()[:8],
                                  sparse_min_words=1)
        assert ref.bank3 and ref.n_words % (128 * 8) == 0 and ref.pool_slots
        port = DeviceEngine(two_tier_db, CPU, sparse_min_words=1,
                            devices=[CPU] * 8)
        queries = sample_count_queries(two_tier_db, 8, seed=5)
        filters, ref_filters = _filters(queries), _ref_filters(queries)
        assert port.count_batch(filters) == ref.count_batch(ref_filters)
        mut = Query(MUTATION_QUERY).filter
        np.testing.assert_array_equal(
            port.mutation_counts("nuc", "main", port.evaluate(mut)),
            ref.mutation_counts("nuc", "main", ref.evaluate(
                RefQuery(MUTATION_QUERY).filter)))
        # the converted state of the kernel-route engine: its 128 x 8 word
        # padding splits over 8 shards as over 4
        for n_shards in (4, 8):
            state = state_from_reference(
                np.asarray(ref.bank), np.asarray(ref.full_masks),
                ref.segment_meta, CPU, np.asarray(ref.sparse_stream[0]),
                ref.sparse_starts_pp, ref.sparse_lengths_pp,
                devices=[CPU] * n_shards)
            converted = DeviceEngine(two_tier_db, CPU, state=state,
                                     devices=[CPU] * n_shards)
            assert converted.n_words == ref.n_words
            assert converted.count_batch(filters) == ref.count_batch(
                ref_filters)
    finally:
        ref_de._interpreter.cache_clear()
        ref_reductions._sparse_mutation_counts_sharded_jit.cache_clear()
        ref_de.vm._pool_update_jit.cache_clear()


def test_pool_update_chunks_upload_once_per_device(two_tier_db, two_tier_ref,
                                                  monkeypatch):
    """_eager_update_chunks on 4 CPU shards of one device: each chunk's
    slots are checked and its bounds and slots staged once for the device
    (kernels.densify_inputs), every shard takes all P segments, the pool
    shards hold each resident leaf's densified row (the plain K4 of the
    whole row, split at the windows), and the counts equal the JAX mesh
    engine's."""
    port = DeviceEngine(two_tier_db, CPU, sparse_min_words=1,
                        devices=[CPU] * 4)
    port._pool_update_k_cap = 8
    staged = []
    real = kernels.densify_inputs

    def spy(bounds, slots, device):
        staged.append((bounds.shape, slots is not None, device))
        return real(bounds, slots, device)

    monkeypatch.setattr(kernels, "densify_inputs", spy)
    queries = sample_count_queries(two_tier_db, 24, seed=12)
    kernels.reset_counts()
    got = port.count_programs([port.lower(f)[0] for f in _filters(queries)])
    assert got == two_tier_ref.count_batch(_ref_filters(queries))
    n_chunks = port.pool_update_dispatches
    assert n_chunks > 1 and len(staged) == n_chunks
    assert all(shape[2] == port.n_partitions and with_slots and device == CPU
               for shape, with_slots, device in staged)
    assert kernels.DENSIFY_INTO_POOL.plain_launches == 4 * n_chunks
    leaves = list(port._leaf_slot)
    starts, lens = (torch.from_numpy(a.astype(np.int32))
                    for a in port._bounds(leaves))
    whole = kernels.densify_rows_plain(port.sparse_idx, port.sparse_words,
                                       starts, lens, port.n_flat_words)
    pool = gather_words(port.leaf_pool, "cpu")
    assert torch.equal(pool[[port._leaf_slot[leaf] for leaf in leaves]], whole)


def test_execute_query_through_sharded_install(monkeypatch):
    """install(db, device, devices=[...]) with the tier forced by the budget
    rule and a pool from SILO_LEAF_POOL_GB: counts and Mutations through
    db.execute_query equal the JAX engine's (a mesh over the 8 virtual
    devices) and the host oracle."""
    monkeypatch.setenv("SILO_DENSE_BANK_BUDGET_GB", "0.00001")
    monkeypatch.setenv("SILO_LEAF_POOL_GB", "0.001")
    ref_db = ref_testing.synthetic_database(**TWO_TIER)
    port_db = synthetic_database(**TWO_TIER)
    engine = lapis_silo_torch.install(port_db, CPU, devices=[CPU] * 4)
    assert len(engine.shards) == 4 and engine.n_sparse > 0
    assert engine.pool_slots > 0
    counts = sample_count_queries(port_db, 24, seed=8)
    muts = [json.dumps({"action": {"type": "Mutations", "minProportion": p},
                        "filterExpression": f}) for f, p in (
        ({"type": "HasNucleotideMutation", "position": 101}, 0.0),
        ({"type": "IntBetween", "column": "age", "from": 20, "to": 70}, 0.05))]
    want = [ref_db.execute_query(q) for q in counts + muts]
    assert ref_db.device_engine.mesh is not None
    port_db.device_engine = None
    try:
        assert [QueryEngine(port_db, use_device=False).execute(q)
                for q in counts + muts] == want
    finally:
        port_db.device_engine = engine
    assert [port_db.execute_query(q) for q in counts + muts] == want
    assert port_db._engine._use_device


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_pool_is_charged_per_device(two_tier_db, n_shards, monkeypatch):
    """Shards on one device add up there: a pool budget buys as many slots
    as the flat row PW fits in it, however many shards share the device."""
    pool_bytes = 80 * 4 * 72  # 80 flat rows of 3 x 24 words
    monkeypatch.setenv("SILO_LEAF_POOL_GB", str(pool_bytes / 2**30))
    port = DeviceEngine(two_tier_db, CPU, sparse_min_words=1,
                        devices=[CPU] * n_shards)
    assert port.n_sparse > 8 * 80  # no cap hides 8x too many slots
    assert port.pool_slots == pool_bytes // (4 * port.n_flat_words)
    port.warm_pool_updates()
    pool_words = sum(pool.numel() for pool in port.leaf_pool)
    assert 4 * pool_words <= pool_bytes + 4 * port.n_flat_words  # + scratch


def test_sharded_engine_refuses_mismatched_devices(dense_db):
    with pytest.raises(ValueError):
        DeviceEngine(dense_db, torch.device("meta"), devices=[CPU, CPU])
    state = build_state(dense_db, CPU, devices=[CPU] * 4)
    with pytest.raises(ValueError):
        DeviceEngine(dense_db, CPU, state=state, devices=[CPU] * 8)


# -- (e) state_from_reference from a mesh engine ----------------------------

@pytest.mark.parametrize("n_shards", [4, 8])
def test_state_from_mesh_reference_equals_own_build(two_tier_db, two_tier_ref,
                                                    n_shards):
    """The JAX mesh engine pads 22 words per partition to 24, as the port
    does on 4 and 8 shards: the converted shards, stream and metadata equal
    the port's own build."""
    ref = two_tier_ref
    converted = state_from_reference(
        np.asarray(ref.bank), np.asarray(ref.full_masks), ref.segment_meta,
        CPU, np.asarray(ref.sparse_stream[0]), ref.sparse_starts_pp,
        ref.sparse_lengths_pp, devices=[CPU] * n_shards)
    own = build_state(two_tier_db, CPU, sparse_min_words=1,
                      devices=[CPU] * n_shards)
    for name in ("banks", "fulls"):
        assert len(getattr(own, name)) == n_shards
        for a, b in zip(getattr(own, name), getattr(converted, name)):
            assert torch.equal(a, b), name
    for name in ("sparse_idx", "sparse_words"):
        assert torch.equal(getattr(own, name), getattr(converted, name)), name
    for name in ("sparse_starts_pp", "sparse_lengths_pp"):
        np.testing.assert_array_equal(getattr(own, name),
                                      getattr(converted, name))
    for key, want in converted.segment_meta.items():
        for name, value in want.items():
            np.testing.assert_array_equal(own.segment_meta[key][name], value,
                                          err_msg=name)
    engine = DeviceEngine(two_tier_db, CPU, state=converted,
                          devices=[CPU] * n_shards)
    queries = sample_count_queries(two_tier_db, 12, seed=2)
    assert engine.count_batch(_filters(queries)) == ref.count_batch(
        _ref_filters(queries))


# -- (f) on the card ---------------------------------------------------------

@pytest.fixture
def cuda_devices():
    """Four shards round-robin over the visible cards."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return [torch.device("cuda", d % torch.cuda.device_count())
            for d in range(4)]


@pytest.mark.cuda
def test_sharded_kernels_match_plain_on_card(cuda_devices):
    """vm_run_sharded (K6; one segment and random segments) and
    mutation_counts_sharded (K2 per shard) against their plain
    versions, and the windowed K4/K5 against theirs,
    with shard windows that straddle partitions and a ragged local width."""
    rng = np.random.default_rng(3)
    pw, n_regs = 4 * 523, 16
    bank, dyn, sparse, full = _bank(rng, pw)
    ops, opers, specs = _program(rng, 40, n_regs, wild=True)
    code = _t(vm.pack_code_array(64, ops, opers, specs))
    n_instr = vm._round_instr(len(ops))

    def on_card(parts):
        return [part.to(dev) for part, dev in zip(parts, cuda_devices)]

    args = [on_card(_split(a, 4)) for a in (bank, dyn, sparse, full)]
    for segments in (None, _random_segments(rng, n_instr, 7)):
        words, counts = kernels.vm_run_sharded(code, n_instr, *args, n_regs,
                                               segments)
        plain_words, plain_counts = kernels.vm_run_sharded_plain(
            code, n_instr, *args, n_regs, segments)
        assert torch.equal(counts, plain_counts)
        for got, want in zip(words, plain_words):
            assert torch.equal(got, want)
    banks, filters = on_card(_split(bank, 4)), on_card(_split(full, 4))
    assert torch.equal(kernels.mutation_counts_sharded(banks, filters, 3, 20),
                       kernels.mutation_counts_sharded_plain(banks, filters,
                                                             3, 20))
    idx, stream_words, starts, lens = (_t(a).to(cuda_devices[0]) for a in
                                       _stream(rng, 9, 3, 700, 150))
    local = 3 * 700 // 4
    for shard in range(4):
        got = kernels.densify_rows(idx, stream_words, starts, lens, local,
                                   shard * local)
        assert torch.equal(got, kernels.densify_rows_plain(
            idx, stream_words, starts, lens, local, shard * local))
        pool = torch.randint(-2**31, 2**31 - 1, (12, local), dtype=torch.int32,
                             device=cuda_devices[0])
        want = pool.clone()
        slots = [11, 0, 4, 2, 9, 1, 3, 5, 7]
        kernels.densify_rows_into_pool(pool, idx, stream_words, starts, lens,
                                       slots, shard * local)
        kernels.densify_rows_into_pool_plain(want, idx, stream_words, starts,
                                             lens, slots, shard * local)
        assert torch.equal(pool, want)
    torch.cuda.synchronize()


def _on_cards(pattern):
    """One device per entry of `pattern`, card pattern[d] mod the visible
    cards (so the pattern's repeats hold on a one-card machine too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return [torch.device("cuda", p % torch.cuda.device_count())
            for p in pattern]


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", [(0, 0), (0, 1, 0), (0, 0, 1, 1),
                                     (0, 1, 2, 3)])
@pytest.mark.parametrize("n_regs,wild", [(1, True), (8, False),
                                         (vm.MAX_REGS, True)])
def test_k6_matches_plain_on_card(pattern, n_regs, wild):
    """K6 against vm_run_sharded_plain for D in {2, 3, 4} with repeated
    cards and shards of ragged widths (3 x 1,571 words split unevenly):
    wild programs (out-of-range operands, repeated, negative and dropped
    EMIT slots, every mode and b-source), as one long segment (its code
    streams through several tiles) and in random segments (empty and
    one-instruction ones), and a batch of 300 segments that takes the wide
    form. Each call launches K6 once per distinct card and K1 never."""
    devices = _on_cards(pattern)
    rng = np.random.default_rng(len(pattern) * 100 + n_regs)
    pw = 3 * 1571
    bank, dyn, sparse, full = _bank(rng, pw)
    ops, opers, specs = _program(rng, 1200, n_regs, wild)
    n_instr = vm._round_instr(len(ops))
    code = _t(vm.pack_code_array(2048, ops, opers, specs))
    args = [[_t(part).to(device) for part, device in zip(
        np.array_split(a, len(devices), axis=-1), devices)]
        for a in (bank, dyn, sparse, full)]
    for segments in (None, _random_segments(rng, n_instr, 40),
                     _random_segments(rng, n_instr, 299)):
        kernels.reset_counts()
        words, counts = kernels.vm_run_sharded(code, n_instr, *args, n_regs,
                                               segments)
        assert kernels.VM_RUN_SHARDED.launches == len(set(devices))
        assert kernels.VM_RUN.launches == 0
        assert not any(k.plain_launches for k in kernels.KERNELS)
        plain_words, plain_counts = kernels.vm_run_sharded_plain(
            code, n_instr, *args, n_regs, segments)
        assert counts.device == devices[0]
        assert torch.equal(counts, plain_counts)
        for got, want, device in zip(words, plain_words, devices):
            assert got.device == device and torch.equal(got, want)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_one_shard_on_card_runs_k1():
    """A single shard launches K1 as vm_run does, and K6 not at all."""
    (device,) = _on_cards((0,))
    rng = np.random.default_rng(5)
    bank, dyn, sparse, full = (_t(a).to(device) for a in _bank(rng, 523))
    ops, opers, specs = _program(rng, 40, 8, wild=True)
    n_instr = vm._round_instr(len(ops))
    code = _t(vm.pack_code_array(128, ops, opers, specs))
    segments = _random_segments(rng, n_instr, 5)
    kernels.reset_counts()
    (words,), counts = kernels.vm_run_sharded(code, n_instr, [bank], [dyn],
                                              [sparse], [full], 8, segments)
    assert (kernels.VM_RUN.launches, kernels.VM_RUN_SHARDED.launches) == (1, 0)
    want_words, want_counts = kernels.vm_run_plain(code, n_instr, bank, dyn,
                                                   sparse, full, 8, segments)
    assert torch.equal(words, want_words) and torch.equal(counts, want_counts)


@pytest.mark.cuda
def test_sharded_engine_on_card_matches_cpu(cuda_devices, two_tier_db):
    """The sharded two-tier engine on the card against the same shards on
    the CPU: pooled and poolless counts, words and Mutations."""
    card = DeviceEngine(two_tier_db, cuda_devices[0], sparse_min_words=1,
                        devices=cuda_devices)
    cpu = DeviceEngine(two_tier_db, CPU, sparse_min_words=1,
                       devices=[CPU] * 4)
    card._pool_update_k_cap = cpu._pool_update_k_cap = 8
    filters = _filters(sample_count_queries(two_tier_db, 32, seed=6))
    lowered = [cpu.lower(f)[0] for f in filters]
    want = cpu.count_programs(lowered)
    assert card.count_programs(lowered) == want
    dispatches = card.count_dispatches(lowered, force_poolless=True)
    assert card.count_finish([None] * len(lowered), list(range(len(lowered))),
                             dispatches) == want
    for f in filters[:6]:
        for a, b in zip(card.evaluate(f), cpu.evaluate(f)):
            np.testing.assert_array_equal(a, b)
    mut = Query(MUTATION_QUERY).filter
    np.testing.assert_array_equal(
        card.mutation_counts_many("nuc", ["main"], card.device_filter(mut))[
            "main"],
        cpu.mutation_counts_many("nuc", ["main"], cpu.evaluate(mut))["main"])
