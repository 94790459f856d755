"""Device engine of the port: filters, counts and Mutations on a torch device.

The counterpart of ``lapis_silo_tpu/ops/device_engine.py`` with its public
surface for the host layers (``query/engine.py``, ``query/actions.py``), for
the dense tier only:

- The index lives on the device as ONE bank ``[R, PW]`` of int32-held u32
  words: R = every stored (segment, symbol, position) row, PW = partitions x
  words per partition (the partition axis folds into the word axis, so
  partition p's sequences occupy words [p*W, (p+1)*W)). Rows are contiguous
  and unaligned: the reference's 3-D ``[R, PW/128, 128]`` layout and
  ROW_BLOCK alignment are TPU tiling workarounds, and without them the port's
  ``row_map`` and word offsets equal the JAX engine's on the CPU.
- A filter lowers to a register-machine program (``ops/lowering.py``); a
  batch of count queries concatenates into one program with one EMIT_COUNT
  per query and runs as ONE launch of the VM kernel (``ops/kernels.py``).
- Mutations reduces popcount(row & filter) for every stored row with the
  Mutations kernel; majority rows reconstruct as |filter| minus the stored
  counts at their position.

Databases whose all-dense bank exceeds the reference's budget would need the
two-tier bank (CSR sparse tier and hot-leaf pool), which is not ported: the
engine refuses them at construction with NotImplementedError.
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from lapis_silo_tpu.ops import bitset

from . import kernels, lowering
from .reductions import popcount_words
from .vm import (
    ALU, B_BANK, B_DYN, B_FULL, B_REG, B_SPARSE, B_ZERO, EMIT_COUNT, M_AND,
    M_MOVB, M_OR, M_XOR, MAX_BATCH_QUERIES, NO_DST, SERVE_LEN_BUCKET,
    SPARSE_BANK_BUDGET_GB, _BATCH_LEN_BUCKETS, _DYN_BUCKETS, _LEN_BUCKETS,
    _REG_BUCKETS, _Program, _round_instr, pack_code_array, ProgramTooLarge,
)
from .words import to_device, to_host


@dataclass
class DenseState:
    """What the engine keeps resident: per-segment row layout, the bank
    [R, PW] and the valid-sequence masks [PW] (int32 tensors)."""

    segment_meta: dict
    bank: torch.Tensor
    full_masks: torch.Tensor


class VmArgs(NamedTuple):
    """One VM launch, on the host: the wire code block [2, bucket], the
    instruction count to run (rounded), the dyn rows (per dyn leaf, per
    partition words), the dyn bucket and the register bucket."""

    code: np.ndarray
    n_instr: int
    dyn_rows: list
    n_dyn: int
    n_regs: int


def _segments(database) -> list[tuple[str, str]]:
    return ([("nuc", name) for name in sorted(database.nuc_sequences)]
            + [("aa", name) for name in sorted(database.aa_sequences)])


def _segment(partition, kind: str, name: str):
    return (partition.nuc_sequences[name] if kind == "nuc"
            else partition.aa_sequences[name])


def build_state(database, device: torch.device) -> DenseState:
    """The dense bank of `database` on `device`, laid out as the reference's
    DeviceEngine does on one device without Pallas (device_engine.py:123-297):
    per segment, every (symbol, position) row present in some partition and
    not the global majority symbol at its position, position-major."""
    partitions = database.partitions
    n_partitions = len(partitions)
    n_words = max(bitset.words_for(p.sequence_count) for p in partitions)
    segments = _segments(database)
    totals_by_segment = {}
    for kind, name in segments:
        totals = None
        for partition in partitions:
            cnt = _segment(partition, kind, name).set_bits_matrix()
            totals = cnt if totals is None else totals + cnt
        totals_by_segment[(kind, name)] = totals

    # the reference's tier decision (device_engine.py:161-171) with this
    # layout's row alignment of 1: the sparse tier switches on only when the
    # all-dense bank would exceed the budget
    projected_rows = 0
    for totals in totals_by_segment.values():
        present = totals > 0
        present[np.argmax(totals, axis=0), np.arange(totals.shape[1])] = False
        projected_rows += int(present.sum())
    budget = int(float(os.environ.get(
        "SILO_DENSE_BANK_BUDGET_GB", SPARSE_BANK_BUDGET_GB)) * 2**30)
    if 4 * n_partitions * projected_rows * n_words > budget:
        raise NotImplementedError("two-tier bank not ported yet")

    segment_meta: dict[tuple[str, str], dict] = {}
    offset = 0
    for kind, name in segments:
        totals = totals_by_segment[(kind, name)]
        majority = np.argmax(totals, axis=0)  # [L]
        s_count, length = totals.shape
        present = totals > 0
        present[majority, np.arange(length)] = False  # majority not stored
        sym_ids, pos_ids = np.nonzero(present)
        order = np.lexsort((sym_ids, pos_ids))  # position-major
        sym_ids, pos_ids = sym_ids[order], pos_ids[order]
        row_map = np.full((s_count, length), -1, dtype=np.int64)
        row_map[majority, np.arange(length)] = -2
        row_map[sym_ids, pos_ids] = offset + np.arange(len(sym_ids))
        segment_meta[(kind, name)] = {
            "offset": offset, "n_stored": len(sym_ids),
            "length": length, "s_count": s_count, "row_map": row_map,
            "majority": majority, "totals": totals.astype(np.int64),
            "sym_ids": sym_ids, "pos_ids": pos_ids,
            "sparse_map": np.full((s_count, length), -1, dtype=np.int64),
            "sparse_base": 0,
            "sparse_sym_ids": sym_ids[:0], "sparse_pos_ids": pos_ids[:0],
        }
        offset += len(sym_ids)
    n_rows = max(offset, 1)

    # filled one partition (one column band of the bank) at a time, so the
    # host never holds more than [R, W] of it
    bank = torch.zeros((n_rows, n_partitions * n_words), dtype=torch.int32,
                       device=device)
    full = np.zeros((n_partitions, n_words), dtype=np.uint32)
    for pi, partition in enumerate(partitions):
        w = bitset.words_for(partition.sequence_count)
        full[pi, :w] = partition.full
        band = np.zeros((n_rows, n_words), dtype=np.uint32)
        for kind, name in segments:
            seg = _segment(partition, kind, name)
            meta = segment_meta[(kind, name)]
            start, n_stored = meta["offset"], meta["n_stored"]
            if not n_stored:
                continue
            # stored rows gather from the compact host segment; where the
            # global row is this partition's implicit majority, reconstruct
            idx = seg.row_map[meta["sym_ids"], meta["pos_ids"]]
            stored = np.nonzero(idx >= 0)[0]
            band[start + stored, :w] = seg.store.materialize(idx[stored])
            for j in np.nonzero(idx == -2)[0]:
                band[start + j, :w] = seg.plane(
                    int(meta["sym_ids"][j]), int(meta["pos_ids"][j]))
        bank[:, pi * n_words:(pi + 1) * n_words] = to_device(band, device)
        del band
    return DenseState(segment_meta, bank, to_device(full.reshape(-1), device))


def state_from_reference(bank, full_masks, segment_meta,
                         device: torch.device) -> DenseState:
    """The port's state from a JAX DeviceEngine's arrays (numpy or anything
    np.asarray takes): its bank (2-D or the 3-D [R, PW/128, 128] form),
    full_masks and segment_meta. Only dense-tier engines convert."""
    if any(len(meta["sparse_sym_ids"]) for meta in segment_meta.values()):
        raise NotImplementedError("two-tier bank not ported yet")
    bank = np.asarray(bank)
    return DenseState(
        segment_meta,
        to_device(bank.reshape(bank.shape[0], -1), device),
        to_device(np.asarray(full_masks).reshape(-1), device))


class DeviceEngine:
    def __init__(self, database, device: torch.device,
                 state: DenseState | None = None):
        self.db = database
        self.device = torch.device(device)
        partitions = database.partitions
        if not partitions:
            raise NotImplementedError("empty database")
        self.n_partitions = len(partitions)
        self.part_rows = [p.sequence_count for p in partitions]
        if state is None:
            state = build_state(database, self.device)
        self.segment_meta = state.segment_meta
        self.bank = state.bank
        self.full_masks = state.full_masks
        self.n_rows = self.bank.shape[0]
        self.n_flat_words = self.full_masks.shape[0]
        self.n_words = self.n_flat_words // self.n_partitions
        self._full_host = to_host(self.full_masks).reshape(
            self.n_partitions, self.n_words)  # host_count interprets on it
        # ingest-time row cardinalities (the reference's stored-cardinality
        # fast path): single-leaf counts need no device work at all
        self._dense_row_counts = np.zeros(self.n_rows, dtype=np.int64)
        for meta in self.segment_meta.values():
            if meta["n_stored"]:
                self._dense_row_counts[
                    meta["offset"]: meta["offset"] + meta["n_stored"]
                ] = meta["totals"][meta["sym_ids"], meta["pos_ids"]]
        # the dense tier has no sparse leaves: lowering never emits B_SPARSE,
        # and the VM's sparse operand is one zero row
        self.sparse_batch_cap = 0
        self.sparse_shape_ladder: list = []
        self.pool_slots = 0
        self._sparse_rows = torch.zeros((1, self.n_flat_words),
                                        dtype=torch.int32, device=self.device)
        self._zero_dyn_cache: dict[int, torch.Tensor] = {}
        self._filters_memo: tuple | None = None
        self._lower_lock = threading.Lock()
        self._batcher: _MicroBatcher | None = None
        self._program_memo: OrderedDict[str, tuple] = OrderedDict()
        self._program_memo_lock = threading.Lock()

    # -- lowering -----------------------------------------------------------

    def lower(self, filter_expr):
        """Compile a filter to ONE partition-uniform VM program; see
        ops/lowering.py."""
        return lowering.lower(self, filter_expr)

    def lower_cached(self, filter_expr, key: str | None = None):
        """lower() with an LRU memo keyed by the filter's canonical JSON:
        serving workloads repeat filters, and lowering walks every partition
        in pure Python. Lowered programs are read-only downstream."""
        if key is None:
            return self.lower(filter_expr)
        memo = self._program_memo
        with self._program_memo_lock:
            hit = memo.get(key)
            if hit is not None:
                memo.move_to_end(key)
                return hit
        result = self.lower(filter_expr)
        with self._program_memo_lock:
            memo[key] = result
            if len(memo) > 4096:
                memo.popitem(last=False)
        return result

    def _pad(self, words: np.ndarray) -> np.ndarray:
        if len(words) == self.n_words:
            return words
        out = np.zeros(self.n_words, dtype=np.uint32)
        out[: len(words)] = words
        return out

    # -- VM launches ------------------------------------------------------------

    def _prepare_program(self, program: _Program) -> VmArgs:
        n = len(program.opcodes)
        bucket = next(b for b in _LEN_BUCKETS if b >= n)
        code = pack_code_array(bucket, program.opcodes, program.operands,
                               program.regspec)
        n_dyn = next(b for b in _DYN_BUCKETS if b >= len(program.dyn_rows))
        n_regs = next(b for b in _REG_BUCKETS if b >= program.max_regs)
        return VmArgs(code, _round_instr(n), program.dyn_rows, n_dyn, n_regs)

    def batch_args(self, lowered: list[_Program], min_bucket: int = 0) -> VmArgs:
        """The programs concatenated into one, each followed by an
        EMIT_COUNT of reg[0] into its query's slot; dyn operands rebased onto
        the merged dyn rows. Packed once: per-program packing costs numpy
        small-array overhead per query."""
        flat_ops: list[int] = []
        flat_opers: list[int] = []
        flat_spec: list[int] = []
        dyn_rows: list = []
        for qi, program in enumerate(lowered):
            dyn_base = len(dyn_rows)
            operands = list(program.operands)
            if dyn_base:
                for i, opcode in enumerate(program.opcodes):
                    if (opcode == ALU
                            and (program.regspec[i] >> 28) & 0xF == B_DYN):
                        operands[i] += dyn_base
            dyn_rows.extend(program.dyn_rows)
            flat_ops.extend(program.opcodes)
            flat_opers.extend(operands)
            flat_spec.extend(program.regspec)
            # every program leaves its result in reg[0] (lowered with dst=0)
            flat_ops.append(EMIT_COUNT)
            flat_opers.append(qi)
            flat_spec.append(NO_DST)  # ra = 0 implied
        if len(flat_ops) > _BATCH_LEN_BUCKETS[-1]:
            raise ProgramTooLarge(len(flat_ops))
        bucket = next(b for b in _BATCH_LEN_BUCKETS
                      if b >= max(len(flat_ops), min_bucket))
        code = pack_code_array(bucket, flat_ops, flat_opers, flat_spec)
        n_dyn = next(b for b in _DYN_BUCKETS if b >= len(dyn_rows))
        n_regs = next(b for b in _REG_BUCKETS
                      if b >= max(p.max_regs for p in lowered))
        return VmArgs(code, _round_instr(len(flat_ops)), dyn_rows, n_dyn,
                      n_regs)

    def _dyn_tensor(self, dyn_rows: list, n_dyn: int) -> torch.Tensor:
        """[n_dyn, PW] dyn rows on the device (a cached zero block when the
        program has none: data-free queries upload only their code)."""
        if not dyn_rows:
            cached = self._zero_dyn_cache.get(n_dyn)
            if cached is None:
                cached = torch.zeros((n_dyn, self.n_flat_words),
                                     dtype=torch.int32, device=self.device)
                self._zero_dyn_cache[n_dyn] = cached
            return cached
        dyn = np.zeros((n_dyn, self.n_partitions, self.n_words),
                       dtype=np.uint32)
        for di, rows in enumerate(dyn_rows):
            for pi, row in enumerate(rows):
                dyn[di, pi] = row
        return to_device(dyn.reshape(n_dyn, self.n_flat_words), self.device)

    def kernel_inputs(self, args: VmArgs) -> tuple:
        """The positional arguments of kernels.vm_run for one launch: the
        code block's first n_instr columns and the dyn rows uploaded."""
        code = torch.from_numpy(np.ascontiguousarray(args.code[:, :args.n_instr]))
        return (code.to(self.device), args.n_instr, self.bank,
                self._dyn_tensor(args.dyn_rows, args.n_dyn),
                self._sparse_rows, self.full_masks, args.n_regs)

    def _run(self, args: VmArgs) -> tuple[torch.Tensor, torch.Tensor]:
        return kernels.vm_run(*self.kernel_inputs(args))

    # -- filters ----------------------------------------------------------------

    def _trivial_words(self, program: _Program) -> torch.Tensor | None:
        """The words of a single full/empty load, which needs no launch."""
        if len(program.opcodes) == 1 and program.opcodes[0] == ALU:
            spec = program.regspec[0]
            if (spec >> 24) & 0xF == M_MOVB:
                if (spec >> 28) & 0xF == B_FULL:
                    return self.full_masks
                if (spec >> 28) & 0xF == B_ZERO:
                    return self._dyn_tensor([], 1)[0]
        return None

    def evaluate_device(self, filter_expr) -> torch.Tensor:
        """The FLAT [PW] global-word filter bitset on the device (partition
        p's words live at [p*W, (p+1)*W))."""
        program, _regs = self.lower(filter_expr)
        trivial = self._trivial_words(program)
        if trivial is not None:
            return trivial
        words, _counts = self._run(self._prepare_program(program))
        return words

    def evaluate(self, filter_expr) -> list[np.ndarray]:
        """Per-partition packed bitsets (host numpy, trimmed)."""
        host = to_host(self.evaluate_device(filter_expr)).reshape(
            self.n_partitions, self.n_words)
        return [
            host[pi, : bitset.words_for(n)] for pi, n in enumerate(self.part_rows)
        ]

    def evaluate_compact(self, filter_expr) -> list[np.ndarray]:
        """evaluate(); the fused nonzero-word extraction of the reference is
        not ported yet."""
        return self.evaluate(filter_expr)

    def device_filter(self, filter_expr) -> "DeviceFilter":
        """Evaluate the filter and KEEP it on the device: Mutations needs
        only device reductions."""
        return DeviceFilter(self, self.evaluate_device(filter_expr))

    def group_counts(self, filter_expr, column_names: list[str]):
        """Not ported yet: None is the reference's "use the host path"."""
        return None

    # -- counts -------------------------------------------------------------------

    def count_async(self, filter_expr, program: _Program | None = None) -> torch.Tensor:
        """Filter + popcount on the device without blocking: a 0-d tensor."""
        if program is None:
            program = self.lower(filter_expr)[0]
        words, _counts = self._run(self._prepare_program(program))
        return popcount_words(words)

    def count(self, filter_expr) -> int:
        """One count: host-answerable programs need no device work."""
        program, _regs = self.lower(filter_expr)
        host = self.host_count(program)
        if host is not None:
            return host
        return int(self.count_async(filter_expr, program=program))

    def count_batch(self, filter_exprs: list, min_bucket: int = 0) -> list[int]:
        """Many counts in one launch (the programs concatenate, each ending
        with EMIT_COUNT)."""
        return self.count_programs([self.lower(f)[0] for f in filter_exprs],
                                   min_bucket)

    def host_count(self, program: _Program,
                   allow_interpret: bool = True) -> int | None:
        """A count answerable with NO device work, or None: (a) single
        static-row loads (the row's ingest-time popcount), (b) programs
        touching no bank rows, interpreted over numpy words (skipped when
        `allow_interpret` is False: inside a wide batch the launch is shared
        and serial host numpy is the worse trade)."""
        n = len(program.opcodes)
        if n == 1 and program.opcodes[0] == ALU:
            spec = program.regspec[0]
            if (spec >> 24) & 0xF == M_MOVB:
                bsrc = (spec >> 28) & 0xF
                operand = program.operands[0]
                if bsrc == B_BANK:
                    return int(self._dense_row_counts[operand])
                if bsrc == B_FULL:
                    return sum(self.part_rows)
                if bsrc == B_ZERO:
                    return 0
                if bsrc == B_DYN:
                    return sum(int(bitset.popcount(row))
                               for row in program.dyn_rows[operand])
        if not allow_interpret or n > 64:  # keep host-side cost bounded
            return None
        for i in range(n):
            if program.opcodes[i] != ALU:
                return None
            if (program.regspec[i] >> 28) & 0xF in (B_BANK, B_SPARSE):
                return None
        full = self._full_host  # [P, W]
        n_regs = program.max_regs
        regs = np.zeros((n_regs + 1,) + full.shape, dtype=np.uint32)
        for i in range(n):
            spec = program.regspec[i]
            dst = min(spec & 0xFF, n_regs)
            ra = min((spec >> 8) & 0xFF, n_regs - 1) if n_regs else 0
            rb = min((spec >> 16) & 0xFF, n_regs - 1) if n_regs else 0
            mode = (spec >> 24) & 0xF
            bsrc = (spec >> 28) & 0xF
            a = regs[ra]
            if bsrc == B_REG:
                b = regs[rb]
            elif bsrc == B_DYN:
                b = np.stack(program.dyn_rows[program.operands[i]])
            elif bsrc == B_FULL:
                b = full
            else:  # B_ZERO
                b = np.zeros_like(full)
            if mode == M_MOVB:
                regs[dst] = b
            elif mode == M_AND:
                regs[dst] = a & b
            elif mode == M_OR:
                regs[dst] = a | b
            elif mode == M_XOR:
                regs[dst] = a ^ b
            else:  # M_ANDN
                regs[dst] = a & (b ^ full)
        return int(bitset.popcount(regs[0].reshape(-1)))

    def count_split(self, lowered: list[_Program], min_bucket: int = 0,
                    max_bucket: int | None = None):
        """Phase 1 of a batched count (non-blocking): answer host-computable
        programs and enqueue the device launches. Returns
        (results-with-None-at-device-slots, device_idx, dispatches); finish
        with count_finish."""
        results: list[int | None] = [None] * len(lowered)
        device_idx: list[int] = []
        device_programs: list[_Program] = []
        allow_interpret = len(lowered) <= 8
        for i, program in enumerate(lowered):
            host = self.host_count(program, allow_interpret=allow_interpret)
            if host is None:
                device_idx.append(i)
                device_programs.append(program)
            else:
                results[i] = host
        dispatches = []
        if device_programs:
            dispatches = self.count_dispatches(device_programs, min_bucket,
                                               max_bucket=max_bucket)
        return results, device_idx, dispatches

    @staticmethod
    def count_finish(results, device_idx, dispatches) -> list[int]:
        """Phase 2 (blocking): read the launches' counts back and fill the
        device slots of a count_split result."""
        flat = (c for counts, q in dispatches for c in counts[:q].tolist())
        for i, count in zip(device_idx, flat):
            results[i] = count
        return results

    def count_programs(self, lowered: list[_Program], min_bucket: int = 0,
                       max_bucket: int | None = None) -> list[int]:
        """count_batch over already-lowered programs (the micro-batcher
        lowers per query so one bad query can't poison a whole batch)."""
        return self.count_finish(*self.count_split(
            lowered, min_bucket, max_bucket=max_bucket))

    def count_dispatches(self, lowered: list[_Program], min_bucket: int = 0,
                         max_bucket: int | None = None,
                         ) -> list[tuple[torch.Tensor, int]]:
        """Non-blocking: (device counts [4096], n_queries) per launch; callers
        slice each [:n_queries]. A batch splits where it exceeds the EMIT
        slots, the instruction cap (`max_bucket`, else the largest bucket) or
        the dyn-row cap."""
        q = len(lowered)
        if q > MAX_BATCH_QUERIES:
            out = []
            for i in range(0, q, MAX_BATCH_QUERIES):
                out.extend(self.count_dispatches(
                    lowered[i: i + MAX_BATCH_QUERIES], min_bucket,
                    max_bucket=max_bucket))
            return out
        len_cap = max_bucket or _BATCH_LEN_BUCKETS[-1]
        total = sum(len(p.opcodes) + 1 for p in lowered)
        total_dyn = sum(len(p.dyn_rows) for p in lowered)
        if q > 1 and (total > len_cap or total_dyn > _DYN_BUCKETS[-1]):
            acc_len = acc_dyn = 0
            split = q
            for i, p in enumerate(lowered):
                acc_len += len(p.opcodes) + 1
                acc_dyn += len(p.dyn_rows)
                if i and (acc_len > len_cap or acc_dyn > _DYN_BUCKETS[-1]):
                    split = i
                    break
            return (self.count_dispatches(lowered[:split], min_bucket,
                                          max_bucket=max_bucket)
                    + self.count_dispatches(lowered[split:], min_bucket,
                                            max_bucket=max_bucket))
        _words, counts = self._run(self.batch_args(lowered, min_bucket))
        return [(counts, q)]

    def count_coalesced(self, filter_expr, key: str | None = None) -> int:
        """Count through the serving micro-batcher: concurrent callers are
        coalesced into ONE launch (EMIT_COUNT program concat)."""
        with self._lower_lock:
            if self._batcher is None:
                self._batcher = _MicroBatcher(self)
            batcher = self._batcher
        return batcher.count(filter_expr, key)

    # -- Mutations ------------------------------------------------------------------

    def _filters_for(self, filter_words) -> torch.Tensor:
        """Device [PW] flat filter for a host word list or DeviceFilter
        (memoized by identity: one Mutations query reduces every segment
        against the same filter)."""
        if isinstance(filter_words, DeviceFilter):
            return filter_words.words
        key = tuple(id(w) for w in filter_words)
        memo = self._filters_memo
        if memo is not None and memo[0] == key:
            return memo[2]
        dyn = np.zeros((self.n_partitions, self.n_words), dtype=np.uint32)
        for pi, words in enumerate(filter_words):
            dyn[pi, : len(words)] = words
        filters = to_device(dyn.reshape(self.n_flat_words), self.device)
        # hold a reference to the keyed arrays so ids stay valid
        self._filters_memo = (key, list(filter_words), filters)
        return filters

    def mutation_counts(self, kind: str, name: str, filter_words):
        """counts[S, L] for one segment (see mutation_counts_many)."""
        return self.mutation_counts_many(kind, [name], filter_words)[name]

    def mutation_counts_many(self, kind: str, names: list[str], filter_words):
        """{name: counts[S, L]}: per (symbol, position) popcount of plane &
        filter, summed over partitions. Stored rows reduce on the device;
        majority rows reconstruct as |filter| - sum(stored counts at pos)
        (exact under the one-symbol-per-position invariant). Every segment's
        launch is issued before the first readback."""
        if isinstance(filter_words, DeviceFilter):
            filter_total = filter_words.popcount()
        else:
            filter_total = sum(bitset.popcount(w) for w in filter_words)
        full = filter_total == sum(self.part_rows)
        results: dict[str, np.ndarray] = {}
        pending = []
        for name in names:
            meta = self.segment_meta[(kind, name)]
            # full/empty filters answer from the ingest-time count matrix
            if full:
                results[name] = meta["totals"].copy()
                continue
            if filter_total == 0:
                results[name] = np.zeros(
                    (meta["s_count"], meta["length"]), dtype=np.int64)
                continue
            dev = None
            if meta["n_stored"]:
                dev = kernels.mutation_counts(
                    self.bank, self._filters_for(filter_words),
                    meta["offset"], meta["n_stored"])
            pending.append((name, meta, dev))
        for name, meta, dev in pending:
            length, s_count = meta["length"], meta["s_count"]
            counts = np.zeros((s_count, length), dtype=np.int64)
            per_pos = np.zeros(length, dtype=np.int64)
            if dev is not None:
                stored = dev.cpu().numpy().astype(np.int64)
                counts[meta["sym_ids"], meta["pos_ids"]] = stored
                np.add.at(per_pos, meta["pos_ids"], stored)
            counts[meta["majority"], np.arange(length)] = filter_total - per_pos
            results[name] = counts
        return results


class DeviceFilter:
    """A filter result resident on the device: FLAT [PW] global words and a
    lazy popcount. Accepted by mutation_counts in place of host word lists."""

    def __init__(self, engine: DeviceEngine, words: torch.Tensor):
        self.engine = engine
        self.words = words
        self._popcount: int | None = None

    def popcount(self) -> int:
        if self._popcount is None:
            self._popcount = int(popcount_words(self.words))
        return self._popcount


class _MicroBatcher:
    """Coalesces concurrent count() callers into single-launch batches.

    The dispatcher thread loops: drain everything queued (up to
    MAX_BATCH_QUERIES), lower each query individually (so a ProgramTooLarge
    / StructureMismatch fails only its own caller), run the batch in one
    launch, deliver results. Queries arriving while a launch is in flight
    form the next batch. Holds only a weakref to the engine, so dropping the
    engine also ends the thread.
    """

    def __init__(self, engine: DeviceEngine):
        self._engine_ref = weakref.ref(engine)
        self._cv = threading.Condition()
        self._queue: list[dict] = []
        self._thread = threading.Thread(
            target=self._loop, name="silo-torch-microbatch", daemon=True)
        self._thread.start()

    def count(self, filter_expr, key: str | None = None) -> int:
        item = {"filter": filter_expr, "key": key, "done": threading.Event(),
                "result": None, "error": None}
        with self._cv:
            self._queue.append(item)
            self._cv.notify()
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue:
                    if not self._cv.wait(timeout=1.0) and self._engine_ref() is None:
                        return
                batch = self._queue[:MAX_BATCH_QUERIES]
                del self._queue[: len(batch)]
            engine = self._engine_ref()
            if engine is None:
                for item in batch:
                    item["error"] = RuntimeError("device engine was dropped")
                    item["done"].set()
                return
            ready = []
            for item in batch:
                try:
                    item["program"] = engine.lower_cached(
                        item["filter"], item.get("key"))[0]
                    ready.append(item)
                except Exception as ex:  # noqa: BLE001 — per-query isolation
                    item["error"] = ex
                    item["done"].set()
            if not ready:
                continue
            try:
                counts = engine.count_programs(
                    [item["program"] for item in ready],
                    min_bucket=SERVE_LEN_BUCKET, max_bucket=SERVE_LEN_BUCKET)
                for item, count in zip(ready, counts):
                    item["result"] = count
            except Exception as ex:  # noqa: BLE001 — delivered to every caller
                for item in ready:
                    item["error"] = ex
            for item in ready:
                item["done"].set()
            del engine
