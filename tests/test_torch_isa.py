"""The port's ISA (lapis_silo_torch/ops/vm.py) against the JAX package's:
every constant, bucket table and encoder must be identical, since both
packages emit and run the same wire-format programs."""

import numpy as np
import pytest

from lapis_silo_tpu.ops import vm as ref_vm
from lapis_silo_torch.ops import vm

ISA_NAMES = [
    "ALU", "EMIT_COUNT", "NOP",
    "B_REG", "B_BANK", "B_DYN", "B_SPARSE", "B_FULL", "B_ZERO",
    "M_MOVB", "M_AND", "M_OR", "M_XOR", "M_ANDN", "NO_DST",
    "WIRE_DST_MASK", "WIRE_RA_SHIFT", "WIRE_RB_SHIFT", "WIRE_MODE_SHIFT",
    "WIRE_BSRC_SHIFT", "WIRE_OP_SHIFT", "WIRE_NOP",
    "_LEN_BUCKETS", "_BATCH_LEN_BUCKETS", "SERVE_LEN_BUCKET", "_DYN_BUCKETS",
    "MAX_BATCH_QUERIES", "MAX_REGS", "_REG_BUCKETS", "_UNROLL",
    "SPARSE_DENSITY_CUTOFF", "SPARSE_BANK_BUDGET_GB",
    "_SPARSE_K_BUCKETS", "_SPARSE_K_BYTE_CAP", "_SPARSE_K_SMEM_BYTE_CAP",
]


@pytest.mark.parametrize("name", ISA_NAMES)
def test_isa_constant_matches_reference(name):
    assert getattr(vm, name) == getattr(ref_vm, name)


def test_sparse_entry_limit_and_k_cap_match_reference():
    """The poolless entry limit is the reference's top entry bucket, and the
    K cap agrees for every partition count, including the refusal past
    16,384 partitions (4 leaves x 16,384 x 4 bytes fill the budget)."""
    assert vm._SPARSE_E_MAX == ref_vm._SPARSE_E_BUCKETS[-1]
    for n_partitions in (1, 2, 3, 8, 16, 32, 100, 1024, 8192, 16384):
        assert vm._smem_k_cap(n_partitions) == ref_vm._smem_k_cap(n_partitions)
    with pytest.raises(vm.ProgramTooLarge):
        vm._smem_k_cap(16385)
    with pytest.raises(ref_vm.ProgramTooLarge):
        ref_vm._smem_k_cap(16385)


def test_wire_field_readers_match_reference():
    rng = np.random.default_rng(4)
    opcodes, _operands, regspec = _random_program(rng, 200)
    packed = vm.pack_wire(opcodes, regspec)
    np.testing.assert_array_equal(vm.wire_opcode(packed),
                                  ref_vm.wire_opcode(packed))
    np.testing.assert_array_equal(vm.wire_bsrc(packed), ref_vm.wire_bsrc(packed))
    np.testing.assert_array_equal(vm.wire_opcode(packed), opcodes)


def _random_program(rng, n):
    opcodes = rng.integers(0, 3, size=n)
    dst = rng.integers(0, 64, size=n)
    dst[rng.random(n) < 0.2] = ref_vm.NO_DST
    regspec = (dst | (rng.integers(0, 64, size=n) << 8)
               | (rng.integers(0, 64, size=n) << 16)
               | (rng.integers(0, 16, size=n) << 24)
               | (rng.integers(0, 16, size=n) << 28))
    operands = rng.integers(-2**31, 2**31, size=n)
    return opcodes, operands, regspec


@pytest.mark.parametrize("n", [0, 1, 13, 256])
def test_pack_wire_and_code_array_match_reference(n):
    rng = np.random.default_rng(n)
    opcodes, operands, regspec = _random_program(rng, n)
    np.testing.assert_array_equal(vm.pack_wire(opcodes, regspec),
                                  ref_vm.pack_wire(opcodes, regspec))
    bucket = max(16, n)
    got = vm.pack_code_array(bucket, opcodes, operands, regspec)
    want = ref_vm.pack_code_array(bucket, opcodes, operands, regspec)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_round_instr_and_program_container_match_reference():
    assert [vm._round_instr(n) for n in range(40)] == [
        ref_vm._round_instr(n) for n in range(40)]
    progs = []
    for module in (vm, ref_vm):
        p = module._Program()
        p.load(1, module.B_BANK, 7)
        p.alu_src(module.M_OR, 1, 1, module.B_DYN, p.add_dyn([np.zeros(2)]))
        p.alu(module.M_ANDN, 0, 1, 2)
        p.emit(module.EMIT_COUNT, 3)
        assert p.add_sparse(9) == p.add_sparse(9) == 0
        progs.append(p)
    port, ref = progs
    assert (port.opcodes, port.operands, port.regspec, port.sparse_leaves) == (
        ref.opcodes, ref.operands, ref.regspec, ref.sparse_leaves)
