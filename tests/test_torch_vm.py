"""The port's filter VM against the JAX package's.

The plain version (lapis_silo_torch/ops/kernels.py vm_run_plain, which the
wrapper runs for CPU tensors) must give bit-equal reg[0] words and EMIT
counts to the XLA interpreter (lapis_silo_tpu/ops/vm.py _interpreter, the
form the JAX package runs on the CPU) on random programs, clamped operands
and the EMIT edge cases included, and to the Mosaic kernel in interpret mode
on programs where the two JAX forms agree. A program split into segments
runs each segment from fresh registers, as the XLA interpreter runs that
segment alone, and adds the segments' counts. All values are integers: the
tolerance is exact equality. The CUDA kernel is held to the plain version on
the card (marked `cuda`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapis_silo_tpu.ops import pallas_kernels as pk
from lapis_silo_tpu.ops import vm as ref_vm
from lapis_silo_torch.ops import kernels
from lapis_silo_torch.ops import vm

N_ROWS, N_DYN, N_SPARSE = 24, 3, 2


def _bank(rng, pw):
    bank = rng.integers(0, 1 << 32, size=(N_ROWS, pw), dtype=np.uint32)
    dyn = rng.integers(0, 1 << 32, size=(N_DYN, pw), dtype=np.uint32)
    sparse = rng.integers(0, 1 << 32, size=(N_SPARSE, pw), dtype=np.uint32)
    full = np.full(pw, 0xFFFFFFFF, dtype=np.uint32)
    full[-3:] = 0x7  # ragged tail like a real partition mask
    return bank, dyn, sparse, full


def _program(rng, n_alu, n_regs, wild):
    """Random ALU/EMIT mix. `wild` adds what only the XLA form defines:
    register indices past n_regs, row operands outside their table, modes
    and sources past the named ones, EMIT operands outside [0, 4096)
    (negative ones too) and EMITs repeated onto one slot."""
    ops, opers, specs = [], [], []

    def emit(op, operand, dst, ra=0, rb=0, mode=0, bsrc=vm.B_REG):
        ops.append(op)
        opers.append(operand)
        specs.append(dst | (ra << 8) | (rb << 16) | (mode << 24) | (bsrc << 28))

    reg_hi = 64 if wild else n_regs
    slot = 0
    for _ in range(n_alu):
        bsrc = int(rng.integers(0, 16 if wild else 6))
        rows = {vm.B_BANK: N_ROWS, vm.B_DYN: N_DYN, vm.B_SPARSE: N_SPARSE}
        hi = rows.get(bsrc, 1)
        operand = (int(rng.integers(-3, hi + 3)) if wild
                   else int(rng.integers(0, hi)))
        emit(vm.ALU, operand, int(rng.integers(0, reg_hi)),
             int(rng.integers(0, reg_hi)), int(rng.integers(0, reg_hi)),
             int(rng.integers(0, 16 if wild else 5)), bsrc)
        if rng.random() < 0.4:
            emit(vm.EMIT_COUNT, slot, vm.NO_DST, int(rng.integers(0, reg_hi)))
            slot += 1
    if wild:
        # slot 0 written twice (the second value stays), operands past 4095
        # dropped, negatives wrapped once by the XLA scatter (-1 -> 4095,
        # -4095 -> 1) or dropped (-5000)
        emit(vm.ALU, 0, 1, mode=vm.M_MOVB, bsrc=vm.B_BANK)
        emit(vm.EMIT_COUNT, 0, vm.NO_DST, 1)
        emit(vm.ALU, 1, 1, mode=vm.M_MOVB, bsrc=vm.B_BANK)
        for operand in (0, 4096, 5000, -1, -4095, -5000):
            emit(vm.EMIT_COUNT, operand, vm.NO_DST, 1)
    return ops, opers, specs


def _run_xla(code, n_instr, bank, dyn, sparse, full, n_regs):
    bucket, pw = code.shape[1], full.shape[0]
    blob = jnp.asarray(np.append(code.reshape(-1), np.int32(n_instr)))
    args = (blob, jnp.asarray(bank), jnp.asarray(dyn), jnp.asarray(sparse),
            jnp.asarray(full))
    words, counts = (
        np.asarray(ref_vm._interpreter(bucket, N_ROWS, N_DYN, N_SPARSE, pw,
                                       output, n_regs=n_regs)(*args))
        for output in ("words", "multi_count"))
    return words, counts


def _run_plain(code, n_instr, bank, dyn, sparse, full, n_regs,
               segments=None):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))

    words, counts = kernels.vm_run(t(code), n_instr, t(bank), t(dyn),
                                   t(sparse), t(full), n_regs, segments)
    return words.numpy().view(np.uint32), counts.numpy()


def _random_segments(rng, n_instr, n_cuts):
    """Segment starts from 0 to n_instr with `n_cuts` random cuts, repeats
    (empty segments) allowed."""
    cuts = np.sort(rng.integers(0, n_instr + 1, size=n_cuts))
    return np.concatenate([[0], cuts, [n_instr]]).astype(np.int32)


@pytest.mark.parametrize("n_regs,pw,wild", [
    (4, 2048, False), (8, 77, True), (16, 2048, True), (32, 300, True),
])
def test_plain_vm_matches_xla_interpreter(n_regs, pw, wild):
    rng = np.random.default_rng(n_regs * 1000 + pw)
    bank, dyn, sparse, full = _bank(rng, pw)
    ops, opers, specs = _program(rng, 40, n_regs, wild)
    n_instr = vm._round_instr(len(ops))
    code = vm.pack_code_array(64, ops, opers, specs)
    want_words, want_counts = _run_xla(code, n_instr, bank, dyn, sparse, full,
                                       n_regs)
    got_words, got_counts = _run_plain(code, n_instr, bank, dyn, sparse, full,
                                       n_regs)
    np.testing.assert_array_equal(got_words, want_words)
    np.testing.assert_array_equal(got_counts, want_counts)
    if wild:
        last = int(np.bitwise_count(bank[1]).sum())
        assert want_counts[0] == want_counts[1] == want_counts[4095] == last


def test_plain_vm_matches_mosaic_kernel_interpreted():
    """Where the Mosaic kernel and the XLA interpreter agree (registers,
    rows, modes and sources in range, each EMIT slot written once), the
    plain version matches the kernel too."""
    rng = np.random.default_rng(5)
    pw, n_regs = 16 * 128, 8
    bank, dyn, sparse, full = _bank(rng, pw)
    ops, opers, specs = _program(rng, 16, n_regs, wild=False)
    n_instr = vm._round_instr(len(ops))
    code = vm.pack_code_array(64, ops, opers, specs)
    want_words, want_counts = pk.vm_run(
        jnp.asarray(code[0]), jnp.asarray(code[1]),
        jnp.asarray([n_instr], dtype=np.int32), jnp.asarray(bank),
        jnp.asarray(dyn), jnp.asarray(sparse), jnp.asarray(full),
        n_regs=n_regs, interpret=True)
    got_words, got_counts = _run_plain(code, n_instr, bank, dyn, sparse, full,
                                       n_regs)
    np.testing.assert_array_equal(got_words, np.asarray(want_words))
    np.testing.assert_array_equal(got_counts, np.asarray(want_counts))


@pytest.mark.parametrize("n_regs,pw,n_cuts", [
    (4, 2048, 1), (8, 77, 5), (16, 300, 12), (32, 130, 30)])
def test_plain_vm_segments_match_xla_per_segment(n_regs, pw, n_cuts):
    """Random segment lists over wild programs: the words are those of the
    XLA interpreter running the last segment alone, and the counts the sum
    of its runs of each segment alone (an empty segment adds nothing and
    leaves zero words)."""
    rng = np.random.default_rng(n_regs * 7 + n_cuts)
    bank, dyn, sparse, full = _bank(rng, pw)
    ops, opers, specs = _program(rng, 40, n_regs, wild=True)
    n_instr = vm._round_instr(len(ops))
    code = vm.pack_code_array(128, ops, opers, specs)
    starts = _random_segments(rng, n_instr, n_cuts)
    want_words = np.zeros(pw, dtype=np.uint32)
    want_counts = np.zeros(vm.MAX_BATCH_QUERIES, dtype=np.int64)
    for lo, hi in zip(starts, starts[1:]):
        seg_code = vm.pack_code_array(128, [], [], [])
        seg_code[:, : hi - lo] = code[:, lo:hi]
        want_words, counts = (
            _run_xla(seg_code, hi - lo, bank, dyn, sparse, full, n_regs)
            if hi > lo else (np.zeros(pw, dtype=np.uint32), 0))
        want_counts += counts
    got_words, got_counts = _run_plain(code, n_instr, bank, dyn, sparse, full,
                                       n_regs, starts)
    np.testing.assert_array_equal(got_words, want_words)
    np.testing.assert_array_equal(got_counts, want_counts)
    # one segment given explicitly is the whole program
    np.testing.assert_array_equal(
        _run_plain(code, n_instr, bank, dyn, sparse, full, n_regs,
                   [0, n_instr])[1],
        _run_xla(code, n_instr, bank, dyn, sparse, full, n_regs)[1])


@pytest.mark.parametrize("segments", [[0], [1, 8], [0, 4, 7], [0, 6, 4, 8],
                                      [[0, 8]], [0.0, 8.0]])
def test_vm_wrapper_rejects_bad_segments(segments):
    pw = 64
    code = torch.zeros((2, 16), dtype=torch.int32)
    rows = torch.zeros((1, pw), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.vm_run(code, 8, rows, rows, rows, rows[0], 4, segments)


def test_vm_wrapper_runs_plain_version_on_cpu_and_counts_it():
    rng = np.random.default_rng(2)
    bank, dyn, sparse, full = _bank(rng, 64)
    code = vm.pack_code_array(16, [vm.ALU, vm.EMIT_COUNT], [3, 0],
                              [0 | (vm.B_BANK << 28), vm.NO_DST])
    before = (kernels.VM_RUN.launches, kernels.VM_RUN.plain_launches)
    _words, counts = _run_plain(code, 4, bank, dyn, sparse, full, 4)
    assert counts[0] == int(np.bitwise_count(bank[3]).sum())
    assert (kernels.VM_RUN.launches, kernels.VM_RUN.plain_launches) == (
        before[0], before[1] + 1)


@pytest.mark.parametrize("bad", ["dtype", "shape", "n_instr", "n_regs",
                                 "contiguous", "code_device"])
def test_vm_wrapper_rejects_bad_inputs(bad):
    pw = 64
    code = torch.zeros((2, 16), dtype=torch.int32)
    bank = torch.zeros((4, pw), dtype=torch.int32)
    dyn = torch.zeros((1, pw), dtype=torch.int32)
    sparse = torch.zeros((1, pw), dtype=torch.int32)
    full = torch.zeros(pw, dtype=torch.int32)
    n_instr, n_regs = 4, 4
    if bad == "dtype":
        bank = bank.to(torch.int64)
    elif bad == "shape":
        dyn = torch.zeros((1, pw + 1), dtype=torch.int32)
    elif bad == "n_instr":
        n_instr = 17
    elif bad == "n_regs":
        n_regs = vm.MAX_REGS + 1
    elif bad == "code_device":  # the code block is built on the host
        code = torch.zeros((2, 16), dtype=torch.int32, device="meta")
    else:
        bank = torch.zeros((pw, 4), dtype=torch.int32).t()
    with pytest.raises(ValueError):
        kernels.vm_run(code, n_instr, bank, dyn, sparse, full, n_regs)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_regs,pw", [(4, 2048), (32, 300)])
def test_vm_kernel_matches_plain_on_card(cuda_device, n_regs, pw):
    rng = np.random.default_rng(n_regs + pw)
    host = _bank(rng, pw)
    ops, opers, specs = _program(rng, 200, n_regs, wild=True)
    code = vm.pack_code_array(512, ops, opers, specs)
    args = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
            for a in (code, *host)]
    n_instr = vm._round_instr(len(ops))
    want = kernels.vm_run(args[0], n_instr, *args[1:], n_regs)
    got = kernels.vm_run(args[0], n_instr,
                         *(a.to(cuda_device) for a in args[1:]), n_regs)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("n_regs,pw,n_cuts", [(4, 2048, 3), (16, 300, 40),
                                              (32, 2045, 150)])
def test_vm_kernel_segments_match_plain_on_card(cuda_device, n_regs, pw,
                                                n_cuts):
    """Random segment lists (empty segments, segments of one instruction,
    repeated and out-of-range EMITs inside a segment) on the card against
    the plain version."""
    rng = np.random.default_rng(n_regs * 3 + n_cuts)
    host = _bank(rng, pw)
    ops, opers, specs = _program(rng, 200, n_regs, wild=True)
    code = vm.pack_code_array(512, ops, opers, specs)
    args = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
            for a in (code, *host)]
    n_instr = vm._round_instr(len(ops))
    starts = _random_segments(rng, n_instr, n_cuts)
    want = kernels.vm_run(args[0], n_instr, *args[1:], n_regs, starts)
    got = kernels.vm_run(args[0], n_instr,
                         *(a.to(cuda_device) for a in args[1:]), n_regs,
                         starts)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
