"""Filter-VM instruction set, wire format, shape buckets and program container.

A copy, without JAX, of the ISA half of ``lapis_silo_tpu/ops/vm.py``: the
lowering and the device engine of the port need these names, and the JAX
module imports ``jax`` at its top. ``tests/test_torch_isa.py`` holds every
constant and encoder here equal to the reference. The executable builders of
the reference module have no counterpart here: the VM runs as the CUDA kernel
``csrc/vm_run.cu`` and the densify steps as ``csrc/densify.cu`` (plain
versions in ``ops/kernels.py``).
"""

from __future__ import annotations

import numpy as np

# Opcodes: a register machine. Every instruction performs exactly one
# unconditional register write, reg[dst] = mode(reg[ra], b), where b is one
# of six sources; no-write instructions target the trash register.
ALU = 0          # reg[dst] = mode(reg[ra], b(bsrc, operand/rb))
EMIT_COUNT = 1   # out[operand] = popcount(reg[ra]); used by batched queries
NOP = 2

# b-operand sources (regspec bits 28..31)
B_REG = 0     # reg[rb]
B_BANK = 1    # bank[operand]            (static plane row)
B_DYN = 2     # dyn[operand]             (per-query dynamic row)
B_SPARSE = 3  # sparse_rows[operand]     (densified sparse-tier row)
B_FULL = 4    # full_mask
B_ZERO = 5    # 0

# ALU modes (regspec bits 24..27). NOT(x) = XOR with b = full_mask (exact
# under the invariant that rows carry no bits beyond the valid sequences).
M_MOVB = 0  # b
M_AND = 1   # a & b
M_OR = 2    # a | b
M_XOR = 3   # a ^ b
M_ANDN = 4  # a & (b ^ full_mask)

# no-write destination: the register file carries one trailing trash slot and
# destinations clamp onto it
NO_DST = 255

# Wire format: two int32 per instruction, the operand and a packed word.
# Packed layout (28 bits used): dst bits 0-5 (NO_DST saturates to 63 and
# still clamps onto the trash slot), ra 6-11, rb 12-17, mode 18-21,
# bsrc 22-25, opcode 26-27.
WIRE_DST_MASK = 0x3F
WIRE_RA_SHIFT, WIRE_RB_SHIFT = 6, 12
WIRE_MODE_SHIFT, WIRE_BSRC_SHIFT, WIRE_OP_SHIFT = 18, 22, 26


def pack_wire(opcodes, regspec):
    """Vectorized host regspec+opcode -> packed wire word (int32)."""
    spec = np.asarray(regspec, dtype=np.int64)
    dst = np.minimum(spec & 0xFF, WIRE_DST_MASK)
    packed = (dst
              | (((spec >> 8) & 0x3F) << WIRE_RA_SHIFT)
              | (((spec >> 16) & 0x3F) << WIRE_RB_SHIFT)
              | (((spec >> 24) & 0xF) << WIRE_MODE_SHIFT)
              | (((spec >> 28) & 0xF) << WIRE_BSRC_SHIFT)
              | (np.asarray(opcodes, dtype=np.int64) << WIRE_OP_SHIFT))
    return packed.astype(np.int32)


# a padded wire slot: opcode NOP, dst -> trash, b-source B_REG
WIRE_NOP = int(pack_wire(np.int64(NOP), np.int64(NO_DST)))


def wire_opcode(packed):
    return (packed >> WIRE_OP_SHIFT) & 0x3


def wire_bsrc(packed):
    return (packed >> WIRE_BSRC_SHIFT) & 0xF


def pack_code_array(bucket: int, opcodes, operands, regspec) -> np.ndarray:
    """[2, bucket] wire code block: row 0 = operands, row 1 = packed words
    (NOP-padded tail)."""
    code = np.zeros((2, bucket), dtype=np.int32)
    code[1, :] = WIRE_NOP
    n = len(opcodes)
    if n:
        code[0, :n] = operands
        code[1, :n] = pack_wire(opcodes, regspec)
    return code


# The reference's program-length buckets (a single query, a batch, the
# serving batch) and dyn-row buckets. The port uses only their caps: the
# lowering refuses past _LEN_BUCKETS[-1] instructions or _DYN_BUCKETS[-1] dyn
# rows, and a batch splits at SERVE_LEN_BUCKET (served), _BATCH_LEN_BUCKETS[-1]
# or _DYN_BUCKETS[-1]. The CUDA kernels take the lengths at run time, so the
# port packs each program at its own length (_round_instr) and uploads
# exactly its dyn rows.
_LEN_BUCKETS = (16, 64, 256, 512)
_BATCH_LEN_BUCKETS = (64, 256, 1024, 4096, 8192, 16384, 32768, 65536)
SERVE_LEN_BUCKET = 8192
_DYN_BUCKETS = (1, 4, 16, 64, 256)
# EMIT_COUNT slots per dispatch, and the register-file bound
MAX_BATCH_QUERIES = 4096
MAX_REGS = 32
_REG_BUCKETS = (4, 8, 16, MAX_REGS)
# callers round instruction counts up to a multiple of this; the padded tail
# is NOPs, which write only the trash register
_UNROLL = 4


def _round_instr(n: int) -> int:
    return -(-n // _UNROLL) * _UNROLL


# Rows whose word-level density is below 1/SPARSE_DENSITY_CUTOFF move to the
# sparse tier (a CSR stream of the rows' non-zero words), which switches on
# only when the all-dense bank would exceed SPARSE_BANK_BUDGET_GB (override:
# SILO_DENSE_BANK_BUDGET_GB).
SPARSE_DENSITY_CUTOFF = 8
SPARSE_BANK_BUDGET_GB = 12.0


class StructureMismatch(Exception):
    """Per-partition IRs diverged structurally; caller falls back to host."""


class ProgramTooLarge(Exception):
    pass


# Sparse-tier caps, kept equal to the reference's so that a program is
# refused, and a batch split, where the reference refuses and splits it:
# the widest K bucket whose densified [K, PW] block fits _SPARSE_K_BYTE_CAP
# is the poolless leaf cap (max_sparse_k), and _smem_k_cap bounds both it and
# the pool-update chunk. The SMEM budget is a TPU limit the CUDA kernels do
# not have; the port keeps it as a chunking rule only.
_SPARSE_K_BUCKETS = (0, 4, 16, 64, 256, 1024, 2048, 4096)
_SPARSE_K_BYTE_CAP = 384 << 20
_SPARSE_K_SMEM_BYTE_CAP = 256 << 10
# live stream entries one poolless densify may gather (the reference's top
# entry bucket; the port has no entry buckets below it)
_SPARSE_E_MAX = 1 << 24


def _smem_k_cap(n_partitions: int) -> int:
    """Widest K bucket whose [K * n_partitions] int32 starts/lens fit
    _SPARSE_K_SMEM_BYTE_CAP; raises ProgramTooLarge past 16,384 partitions,
    as the reference does."""
    fit = [b for b in _SPARSE_K_BUCKETS[1:]
           if b * n_partitions * 4 <= _SPARSE_K_SMEM_BYTE_CAP]
    if not fit:
        raise ProgramTooLarge(
            f"sparse-tier densify needs K>={_SPARSE_K_BUCKETS[1]} x "
            f"{n_partitions} partitions of i32 bounds, over the "
            f"{_SPARSE_K_SMEM_BYTE_CAP >> 10} KB budget: reduce the "
            "partition count or disable the sparse tier "
            "(SILO_DENSE_BANK_BUDGET_GB)")
    return max(fit)


class _Program:
    def __init__(self):
        self.opcodes: list[int] = []
        self.operands: list[int] = []
        self.regspec: list[int] = []  # dst | ra<<8 | rb<<16 | mode<<24
        self.dyn_rows: list[list[np.ndarray]] = []  # per dyn leaf: per partition words
        # per sparse leaf: the global sparse-row id; B_SPARSE operands index
        # this list until dispatch maps them onto densified or pool rows
        self.sparse_leaves: list[int] = []
        self._sparse_cache: dict = {}
        self.max_regs = MAX_REGS
        # bit masks of the registers read, written, and read before any
        # write, for reads_first
        self._reads = self.writes = self._reads_first = 0

    def emit(self, opcode: int, operand: int = 0, dst: int = NO_DST,
             ra: int = 0, rb: int = 0, mode: int = 0, bsrc: int = B_REG):
        self.opcodes.append(opcode)
        self.operands.append(operand)
        self.regspec.append(
            dst | (ra << 8) | (rb << 16) | (mode << 24) | (bsrc << 28)
        )
        # a destination past MAX_REGS is the trash register under every
        # register bucket, so what such an instruction reads is dropped,
        # but an EMIT_COUNT's popcount of reg[ra]
        reads = (1 << ra) if opcode == EMIT_COUNT else 0
        if dst < MAX_REGS:
            if mode != M_MOVB:
                reads |= 1 << ra
            if bsrc == B_REG:
                reads |= 1 << rb
        self._reads_first |= reads & ~self.writes
        self._reads |= reads
        if dst < MAX_REGS:
            self.writes |= 1 << dst

    @property
    def reads_first(self) -> int:
        """Bit mask of the registers the program, followed by an EMIT_COUNT
        of reg[0], reads before writing them: what it takes from a program
        run before it. Every bit (-1) when it touches a register at or past
        max_regs, where a batch's register bucket may clamp its indices."""
        if (self._reads | self.writes) >> self.max_regs:
            return -1
        return self._reads_first | (~self.writes & 1)

    def alu(self, mode: int, dst: int, ra: int, rb: int = 0):
        """reg[dst] = mode(reg[ra], reg[rb])"""
        self.emit(ALU, 0, dst, ra, rb, mode)

    def alu_src(self, mode: int, dst: int, ra: int, bsrc: int, operand: int = 0):
        """reg[dst] = mode(reg[ra], <bsrc source>)"""
        self.emit(ALU, operand, dst, ra, 0, mode, bsrc)

    def load(self, dst: int, bsrc: int, operand: int = 0):
        """reg[dst] = <bsrc source>"""
        self.emit(ALU, operand, dst, 0, 0, M_MOVB, bsrc)

    def add_dyn(self, rows_per_partition: list[np.ndarray]) -> int:
        self.dyn_rows.append(rows_per_partition)
        return len(self.dyn_rows) - 1

    def add_sparse(self, sparse_row_id: int) -> int:
        cached = self._sparse_cache.get(sparse_row_id)
        if cached is not None:
            return cached
        self.sparse_leaves.append(sparse_row_id)
        leaf = len(self.sparse_leaves) - 1
        self._sparse_cache[sparse_row_id] = leaf
        return leaf
