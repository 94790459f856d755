"""Device engine of the port: filters, counts and Mutations on a torch device.

The counterpart of ``lapis_silo_tpu/ops/device_engine.py`` with its public
surface for the host layers (``query/engine.py``, ``query/actions.py``, the
watcher and the fast path):

- Every stored (segment, symbol, position) row that is not the global
  majority symbol at its position lives in one of two tiers. The dense bank
  ``[R, PW]`` holds int32-held u32 words over the flat global word axis (PW =
  partitions x words per partition; partition p's sequences occupy words
  [p*W, (p+1)*W)). Rows are contiguous and unaligned: the reference's 3-D
  ``[R, PW/128, 128]`` layout and ROW_BLOCK alignment are TPU tiling
  workarounds, and without them ``row_map`` equals the JAX engine's on the
  CPU.
- When the all-dense bank would exceed the reference's budget
  (SILO_DENSE_BANK_BUDGET_GB, 12 GiB), rows with fewer than PW/8 non-zero
  words that are no partition's implicit majority move to the sparse tier: a
  CSR stream of their non-zero words, two flat int32 tensors ``idx`` (global
  word index) and ``words``, partition-major, with one (start, len) per
  (leaf, partition). The reference's block-interleaved stream and its
  padding are Mosaic workarounds and are gone.
- A filter lowers to a register-machine program (``ops/lowering.py``); a
  batch of count queries concatenates into one program with one EMIT_COUNT
  per query and runs as ONE launch of the VM kernel, each self-contained
  query in a segment of its own that the kernel runs beside the others
  (``batch_args``). A single filter whose total or compact blocks a route
  needs (``count_async``, ``device_filter``, ``evaluate_compact``) gets
  them from the same launch (``kernels.vm_filter_sharded``). B_SPARSE
  operands name
  sparse leaves: before the VM launch, missed leaves are densified into rows
  of the hot-leaf pool ``[C + 1, PW]`` (an SLRU cache of leaf rows) and the
  VM reads the pool; without the pool, or on the cold-sweep bypass, the
  leaves are densified into a ``[K, PW]`` block the VM reads instead.
- Mutations reduces popcount(row & filter) for every dense row of the
  query's segments with the Mutations kernel, and for every sparse row of
  its alphabet with the sparse-counts kernel, which reads the stream's
  segments only in the partitions where the filter has a set bit; majority
  rows reconstruct as |filter| minus the stored counts at their position.

The engine launches on the device's default stream, whichever thread calls
(the micro-batcher's or a caller's): a pool update may overwrite a slot that
an earlier VM launch reads, and one stream runs them in order.

With ``devices`` of two or more entries the engine shards the flat word axis
over them, as the reference does over a Mesh of its local devices
(device_engine.py:74-120; ``parallel/shards.py``): shard d holds the words
[d*PW/D, (d+1)*PW/D) of the bank, the full masks, the dyn rows, the
densified blocks and the pool, and n_words is padded to a multiple of D. The
CSR stream is copied once to each distinct device. The VM and the dense
Mutations run per shard (``kernels.vm_run_sharded``,
``kernels.mutation_counts_sharded``), densify is window-local per shard, the
sparse Mutations splits the stream's entries over the shards, and counts
are summed on the primary device ``devices[0]``. Each shard launches on its
device's default stream. One device is one shard (D = 1): the same code
makes the same launches, with no sum and no copy.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import weakref
from collections import Counter, OrderedDict
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from ..parallel.shards import (
    ShardLayout, gather_words, resolve, split_words,
)
from . import bitset, kernels, lowering
from .reductions import clip_segments, entry_chunks
from .vm import (
    ALU, B_BANK, B_DYN, B_FULL, B_REG, B_SPARSE, B_ZERO, EMIT_COUNT, M_AND,
    M_MOVB, M_OR, M_XOR, MAX_BATCH_QUERIES, NO_DST, SERVE_LEN_BUCKET,
    SPARSE_BANK_BUDGET_GB, SPARSE_DENSITY_CUTOFF, _BATCH_LEN_BUCKETS,
    _DYN_BUCKETS, _REG_BUCKETS, _SPARSE_E_MAX,
    _SPARSE_K_BUCKETS, _SPARSE_K_BYTE_CAP, _Program, _round_instr,
    _smem_k_cap, pack_code_array, ProgramTooLarge, wire_bsrc, wire_opcode,
)
from .words import to_device, to_host

# the densify and sparse-counts kernels take stream offsets as int32
_INT32_MAX = int(np.iinfo(np.int32).max)


@dataclass
class BankState:
    """What the engine keeps resident: per-segment row layout, the dense
    bank and the valid-sequence masks as one word shard per device (banks
    [R, PW/D], fulls [PW/D], int32 tensors; D = 1 on one device), and with
    the sparse tier on, its CSR stream (idx, words [E] int32 tensors, on the
    first shard's device) and the per-(leaf, partition) bounds into it (host
    int64 [n_sparse, P])."""

    segment_meta: dict
    banks: list
    fulls: list
    sparse_idx: torch.Tensor | None = None
    sparse_words: torch.Tensor | None = None
    sparse_starts_pp: np.ndarray | None = None
    sparse_lengths_pp: np.ndarray | None = None


class VmArgs(NamedTuple):
    """One VM launch, on the host: the wire code block [2, n_instr] (the
    program's instructions and a NOP tail up to the multiple of _UNROLL
    that n_instr is), n_instr, the dyn rows (per dyn leaf, per partition
    words; the launch uploads exactly these), the register bucket, the
    sparse leaves (global sparse-row ids) that B_SPARSE operands index,
    and the segment starts (int32 [n_seg + 1], the last n_instr; None: the
    whole program is one segment) that kernels.vm_run runs apart."""

    code: np.ndarray
    n_instr: int
    dyn_rows: list
    n_regs: int
    sparse_leaves: list
    seg_starts: np.ndarray | None = None


def _segments(database) -> list[tuple[str, str]]:
    return ([("nuc", name) for name in sorted(database.nuc_sequences)]
            + [("aa", name) for name in sorted(database.aa_sequences)])


def _segment(partition, kind: str, name: str):
    return (partition.nuc_sequences[name] if kind == "nuc"
            else partition.aa_sequences[name])


def _sparse_mask(partitions, kind: str, name: str, sym_ids, pos_ids,
                 flat_words: int) -> np.ndarray:
    """Which stored rows go sparse (device_engine.py:190-204): no partition
    holds them as its implicit majority, and their non-zero words, summed
    over partitions, are at most 1/SPARSE_DENSITY_CUTOFF of the flat row."""
    total_nnz = np.zeros(len(sym_ids), dtype=np.int64)
    majority_somewhere = np.zeros(len(sym_ids), dtype=bool)
    for partition in partitions:
        seg = _segment(partition, kind, name)
        local = seg.row_map[sym_ids, pos_ids]
        majority_somewhere |= local == -2
        stored = local >= 0
        total_nnz[stored] += seg.store.row_nnz()[local[stored]]
    return ~majority_somewhere & (
        total_nnz * SPARSE_DENSITY_CUTOFF <= flat_words)


def _sparse_stream(partitions, segments, segment_meta, n_sparse: int,
                   n_words: int):
    """The partition-major CSR stream of the sparse rows
    (device_engine.py:310-347): for each partition, each segment's sparse
    rows in sparse-id order, each row's non-zero words as (global word
    index, word). Returns (idx int32 [E], words uint32 [E], starts and
    lengths int64 [n_sparse, P])."""
    starts_pp = np.zeros((n_sparse, len(partitions)), dtype=np.int64)
    lens_pp = np.zeros((n_sparse, len(partitions)), dtype=np.int64)
    idx_chunks, word_chunks = [], []
    offset = 0
    for pi, partition in enumerate(partitions):
        for kind, name in segments:
            meta = segment_meta[(kind, name)]
            if not len(meta["sparse_sym_ids"]):
                continue
            local = _segment(partition, kind, name).row_map[
                meta["sparse_sym_ids"], meta["sparse_pos_ids"]]
            stored = np.nonzero(local >= 0)[0]
            if not len(stored):
                continue
            idx, words, lengths = _segment(
                partition, kind, name).store.gather_rows_csr(local[stored])
            leaves = meta["sparse_base"] + stored
            within = np.zeros(len(lengths), dtype=np.int64)
            np.cumsum(lengths[:-1], out=within[1:])
            starts_pp[leaves, pi] = offset + within
            lens_pp[leaves, pi] = lengths
            offset += int(lengths.sum())
            idx_chunks.append(idx.astype(np.int64) + pi * n_words)
            word_chunks.append(words)
    idx = (np.concatenate(idx_chunks) if idx_chunks
           else np.zeros(0, np.int64)).astype(np.int32)
    words = (np.concatenate(word_chunks) if word_chunks
             else np.zeros(0, np.uint32))
    return idx, words, starts_pp, lens_pp


def _check_stream(idx: np.ndarray, starts: np.ndarray,
                  lens: np.ndarray, n_words: int | None = None) -> None:
    """The densify kernels' contract (csrc/densify.cu): within every (leaf,
    partition) segment the word indices strictly ascend. `_sparse_stream`
    keeps it by construction (the row stores give each row's words in
    ascending order: np.nonzero over a dense row, CsrRowStore.from_coo's
    lexsort). One vectorised pass: a step of the stream that does not ascend
    may only fall between two segments; ValueError otherwise. With
    `n_words`, the sparse-counts kernel's: partition p's segments index only
    its own words [p * n_words, (p + 1) * n_words), so a partition where
    the filter has no set bit holds nothing that counts."""
    falls = np.flatnonzero(idx[1:] <= idx[:-1]) + 1
    starts = np.asarray(starts, dtype=np.int64).reshape(-1)
    ends = np.minimum(starts + np.asarray(lens, dtype=np.int64).reshape(-1),
                      len(idx))
    starts = np.maximum(starts, 0)
    inside = (np.searchsorted(falls, ends, "left")
              - np.searchsorted(falls, starts, "right"))
    bad = np.flatnonzero((ends > starts) & (inside > 0))
    if bad.size:
        raise ValueError(f"{bad.size} stream segments do not strictly ascend "
                         f"(first: flat segment {int(bad[0])})")
    if n_words is None:
        return
    ends = ends.reshape(np.shape(lens))
    starts = starts.reshape(np.shape(lens))
    for p in range(ends.shape[1]):
        live = ends[:, p] > starts[:, p]
        if not live.any():
            continue
        # partition-major: the partition's entries are one range
        words = idx[starts[live, p].min():ends[live, p].max()]
        if words.min() < p * n_words or words.max() >= (p + 1) * n_words:
            raise ValueError(f"partition {p}'s stream segments index words "
                             f"outside [{p * n_words}, {(p + 1) * n_words})")


def build_state(database, device: torch.device,
                sparse_min_words: int | None = None,
                devices=None) -> BankState:
    """The two-tier bank of `database` on `device`, laid out as the
    reference's DeviceEngine does without Pallas (device_engine.py:123-414):
    per segment, every (symbol, position) row present in some partition and
    not the global majority symbol at its position, position-major, split
    between the dense bank and the sparse tier. The tier is on when the
    all-dense bank would exceed the budget, or, with `sparse_min_words`
    (tests), when the flat row has at least that many words. With `devices`
    (two or more) the words shard over them and n_words pads to a multiple
    of their count (device_engine.py:84-85); the stream lies on
    devices[0]."""
    partitions = database.partitions
    n_partitions = len(partitions)
    n_words = max(bitset.words_for(p.sequence_count) for p in partitions)
    shard_devices = list(devices) if devices else [device]
    n_words += -n_words % len(shard_devices)
    layout = ShardLayout(shard_devices, n_partitions, n_words)
    flat_words = n_partitions * n_words
    segments = _segments(database)
    totals_by_segment = {}
    for kind, name in segments:
        totals = None
        for partition in partitions:
            cnt = _segment(partition, kind, name).set_bits_matrix()
            totals = cnt if totals is None else totals + cnt
        totals_by_segment[(kind, name)] = totals

    # the reference's tier decision (device_engine.py:150-171) with this
    # layout's row alignment of 1
    if sparse_min_words is not None:
        sparse_enabled = flat_words >= sparse_min_words
    else:
        projected_rows = 0
        for totals in totals_by_segment.values():
            present = totals > 0
            present[np.argmax(totals, axis=0), np.arange(totals.shape[1])] = False
            projected_rows += int(present.sum())
        budget = int(float(os.environ.get(
            "SILO_DENSE_BANK_BUDGET_GB", SPARSE_BANK_BUDGET_GB)) * 2**30)
        sparse_enabled = 4 * projected_rows * flat_words > budget

    segment_meta: dict[tuple[str, str], dict] = {}
    offset = n_sparse = 0
    for kind, name in segments:
        totals = totals_by_segment[(kind, name)]
        majority = np.argmax(totals, axis=0)  # [L]
        s_count, length = totals.shape
        present = totals > 0
        present[majority, np.arange(length)] = False  # majority not stored
        sym_ids, pos_ids = np.nonzero(present)
        order = np.lexsort((sym_ids, pos_ids))  # position-major
        sym_ids, pos_ids = sym_ids[order], pos_ids[order]
        if sparse_enabled and len(sym_ids):
            sparse = _sparse_mask(partitions, kind, name, sym_ids, pos_ids,
                                  flat_words)
        else:
            sparse = np.zeros(len(sym_ids), dtype=bool)
        dense = ~sparse
        n_dense, n_seg_sparse = int(dense.sum()), int(sparse.sum())
        row_map = np.full((s_count, length), -1, dtype=np.int64)
        row_map[majority, np.arange(length)] = -2
        row_map[sym_ids[dense], pos_ids[dense]] = offset + np.arange(n_dense)
        sparse_map = np.full((s_count, length), -1, dtype=np.int64)
        sparse_map[sym_ids[sparse], pos_ids[sparse]] = (
            n_sparse + np.arange(n_seg_sparse))
        segment_meta[(kind, name)] = {
            "offset": offset, "n_stored": n_dense,
            "length": length, "s_count": s_count, "row_map": row_map,
            "majority": majority, "totals": totals.astype(np.int64),
            "sym_ids": sym_ids[dense], "pos_ids": pos_ids[dense],
            "sparse_map": sparse_map, "sparse_base": n_sparse,
            "sparse_sym_ids": sym_ids[sparse],
            "sparse_pos_ids": pos_ids[sparse],
        }
        offset += n_dense
        n_sparse += n_seg_sparse
    n_rows = max(offset, 1)

    # filled one partition (one column band of the bank) at a time, so the
    # host never holds more than [R, W] of it; each shard takes the part of
    # the band inside its window
    banks = [torch.zeros((n_rows, layout.local_words), dtype=torch.int32,
                         device=shard) for shard in layout.devices]
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
        for shard, (bank, lo) in enumerate(zip(banks, layout.offsets)):
            a = max(lo, pi * n_words)
            b = min(lo + layout.local_words, (pi + 1) * n_words)
            if a < b:
                bank[:, a - lo:b - lo] = to_device(
                    band[:, a - pi * n_words:b - pi * n_words],
                    layout.devices[shard])
        del band
    state = BankState(segment_meta, banks,
                      split_words(full.reshape(-1), layout.devices))
    if n_sparse:
        idx, words, starts_pp, lens_pp = _sparse_stream(
            partitions, segments, segment_meta, n_sparse, n_words)
        _check_stream(idx, starts_pp, lens_pp, n_words)
        state.sparse_idx = to_device(idx, layout.devices[0])
        state.sparse_words = to_device(words, layout.devices[0])
        state.sparse_starts_pp, state.sparse_lengths_pp = starts_pp, lens_pp
    return state


def state_from_reference(bank, full_masks, segment_meta, device: torch.device,
                         sparse_stream=None, sparse_starts_pp=None,
                         sparse_lengths_pp=None, devices=None) -> BankState:
    """The port's state from a JAX DeviceEngine's arrays (numpy or anything
    np.asarray takes, so a mesh engine's arrays gather whole): its bank
    (2-D or the 3-D [R, PW/128, 128] form), full_masks and segment_meta,
    and for a two-tier engine its combined sparse stream
    (``sparse_stream[0]``), sparse_starts_pp and sparse_lengths_pp. The
    combined stream's block interleave (per 1,024 entries: 8 rows of 128
    indices, then 8 rows of 128 words) is undone here and the stream trimmed
    to its live entries. With `devices` (two or more) the words split into
    one shard per device and the stream lies on devices[0]; the reference's
    PW, padded as its own mesh padded it, must split evenly."""
    bank = np.asarray(bank)
    shard_devices = list(devices) if devices else [device]
    device = shard_devices[0]
    state = BankState(
        segment_meta,
        split_words(bank.reshape(bank.shape[0], -1), shard_devices),
        split_words(np.asarray(full_masks).reshape(-1), shard_devices))
    if not any(len(meta["sparse_sym_ids"]) for meta in segment_meta.values()):
        return state
    if sparse_stream is None or sparse_starts_pp is None \
            or sparse_lengths_pp is None:
        raise ValueError("a two-tier engine converts with its sparse stream "
                         "and bounds")
    starts = np.asarray(sparse_starts_pp, dtype=np.int64)
    lens = np.asarray(sparse_lengths_pp, dtype=np.int64)
    n_live = int(lens.sum())
    groups = np.asarray(sparse_stream, dtype=np.uint32).reshape(-1, 2, 8, 128)
    idx = groups[:, 0].reshape(-1)[:n_live]
    _check_stream(idx, starts, lens, bank.reshape(bank.shape[0], -1).shape[1]
                  // lens.shape[1])
    state.sparse_idx = to_device(idx, device)
    state.sparse_words = to_device(groups[:, 1].reshape(-1)[:n_live], device)
    state.sparse_starts_pp, state.sparse_lengths_pp = starts, lens
    return state


def blocks_to_host(stacks: list[torch.Tensor], cap: int,
                   n_flat_words: int) -> np.ndarray | None:
    """Host flat words [n_flat_words] from the shards' compact blocks (one
    int32 tensor [k, 1 + 2 cap] per card, as compact_nonzero_sharded and
    kernels.vm_filter_sharded give them): each card's blocks in one copy
    into one pinned host block, kept for the next call (a copy into
    pageable memory would wait for the stream's queued work as a whole),
    and the host's rebuild. None when more than `cap` words are
    non-zero."""
    if stacks[0].device.type != "cuda":
        return rebuild_from_blocks(torch.cat(stacks).numpy(), cap,
                                   n_flat_words)
    staged = _take_pinned((sum(stack.shape[0] for stack in stacks),
                           1 + 2 * cap))
    try:
        row = 0
        for stack in stacks:
            staged[row:row + stack.shape[0]].copy_(stack, non_blocking=True)
            row += stack.shape[0]
        for stack in stacks:
            torch.cuda.current_stream(stack.device).synchronize()
        return rebuild_from_blocks(staged.numpy(), cap, n_flat_words)
    finally:
        _give_pinned(staged)


# blocks_to_host's pinned host blocks, free ones by shape: a call takes one
# that no other call holds (a server answers from many threads), and pins
# no memory once the pool holds as many as calls run at once
_pinned_free: dict = {}
_pinned_lock = threading.Lock()


def _take_pinned(shape: tuple) -> torch.Tensor:
    with _pinned_lock:
        free = _pinned_free.get(shape)
        if free:
            return free.pop()
    return torch.empty(shape, dtype=torch.int32, pin_memory=True)


def _give_pinned(block: torch.Tensor) -> None:
    with _pinned_lock:
        _pinned_free.setdefault(tuple(block.shape), []).append(block)


@contextlib.contextmanager
def counts_on_host(counts: torch.Tensor):
    """An int32 tensor's values as numpy for the with-block: a card's
    through one copy into a pinned host block, kept for the next call, a
    CPU tensor's as they are. A copy into pageable memory stages through
    the host and stalls on it: a group-by's 1.90 MB read back so took
    39.9 us at the 5th percentile and up to 350.5 us, 47.1 us on average
    (NVIDIA H100 80GB HBM3, 700 W, 404 copies of one run of
    lineage1m_dash.variant_page)."""
    if counts.device.type != "cuda":
        yield counts.numpy()
        return
    staged = _take_pinned(tuple(counts.shape))
    try:
        staged.copy_(counts, non_blocking=True)
        torch.cuda.current_stream(counts.device).synchronize()
        yield staged.numpy()
    finally:
        _give_pinned(staged)


def rebuild_from_blocks(packed: np.ndarray, cap: int,
                        n_flat_words: int) -> np.ndarray | None:
    """The host's half of blocks_to_host: flat uint32 words
    [n_flat_words] from the shards' blocks (int32 [D, 1 + 2 cap]), or None
    when their counts pass `cap`."""
    counts = packed[:, 0].astype(np.int64)
    if counts.sum() > cap:
        return None
    host = np.zeros(n_flat_words, dtype=np.uint32)
    for shard_block, n in zip(packed, counts):
        # numpy scatters through intp indices; casting first is faster
        host[shard_block[1:1 + n].astype(np.intp)] = (
            shard_block[1 + cap:1 + cap + n].view(np.uint32))
    return host


def group_rows(per_part: np.ndarray, n_groups: int, decode) -> list:
    """[(decode(g), count)] of the groups with a count, from the per
    partition counts [P, >= n_groups] of a group-by, in the host path's row
    order: groups appear when first seen scanning partitions in order,
    sorted by code within each partition's novel set."""
    per_part = per_part[:, :n_groups]
    totals = per_part.sum(axis=0, dtype=np.int64)
    hits = np.nonzero(totals)[0]
    first_partition = np.argmax(per_part[:, hits] > 0, axis=0)
    order = np.lexsort((hits, first_partition))
    return [(decode(int(g)), int(totals[g])) for g in hits[order]]


class DeviceEngine:
    """The port's device engine over one device, or with `devices` (two or
    more, repeats allowed) sharded over them with devices[0] the primary:
    `device` must then name devices[0]. A given `state` must have been built
    for the same devices."""

    def __init__(self, database, device: torch.device,
                 state: BankState | None = None,
                 sparse_min_words: int | None = None, devices=None):
        self.db = database
        self.device = torch.device(device)
        partitions = database.partitions
        if not partitions:
            raise NotImplementedError("empty database")
        self.n_partitions = len(partitions)
        self.part_rows = [p.sequence_count for p in partitions]
        if devices is None:
            devices = [self.device]
        devices = [resolve(d) for d in devices]
        if not devices or resolve(self.device) != devices[0]:
            raise ValueError(f"device {self.device} is not the first of "
                             f"devices {devices}")
        self.device = devices[0]
        if state is None:
            state = build_state(database, self.device, sparse_min_words,
                                devices)
        self.segment_meta = state.segment_meta
        self.banks = state.banks
        self.fulls = state.fulls
        self.n_rows = self.banks[0].shape[0]
        self.n_flat_words = sum(full.shape[0] for full in self.fulls)
        self.n_words = self.n_flat_words // self.n_partitions
        self.shards = ShardLayout(devices, self.n_partitions, self.n_words)
        for shard, (bank, full) in enumerate(zip(self.banks, self.fulls)):
            if (len(self.banks) != len(self.shards)
                    or full.device != self.shards.devices[shard]
                    or bank.device != full.device
                    or bank.shape != (self.n_rows, self.shards.local_words)):
                raise ValueError("the state's shards do not match the "
                                 "engine's devices")
        # host_count interprets on it
        self._full_host = self._gather_host(self.fulls).reshape(
            self.n_partitions, self.n_words)
        # K2's row pieces on each shard: every partition's own words in the
        # shard's window (a partition across a window's edge has pieces on
        # both shards), so a Mutations reduction reads neither the padding
        # nor the partitions its filter leaves empty
        own_words = [bitset.words_for(n) for n in self.part_rows]
        self._dense_pieces = [
            torch.from_numpy(kernels.dense_pieces(
                self.n_words, own_words, lo, lo + self.shards.local_words)
            ).to(shard)
            for shard, lo in zip(self.shards.devices, self.shards.offsets)]
        self.sparse_idx = state.sparse_idx
        self.sparse_words = state.sparse_words
        self.sparse_starts_pp = state.sparse_starts_pp
        self.sparse_lengths_pp = state.sparse_lengths_pp
        self.n_sparse = sum(len(meta["sparse_sym_ids"])
                            for meta in self.segment_meta.values())
        # where the stream's segments end (_launch_bounds)
        self._stream_end = (int((self.sparse_starts_pp
                                 + self.sparse_lengths_pp).max())
                            if self.n_sparse else 0)
        # the stream once on each distinct device (the reference replicates
        # it over the mesh, device_engine.py:383-394)
        self._stream_on = {}
        if self.n_sparse:
            self._stream_on = {
                shard: (self.sparse_idx.to(shard), self.sparse_words.to(shard))
                for shard in self.shards.distinct}
        # every shard device's default stream, the primary's entered last so
        # that it is the current device inside _on_stream
        self._cuda_streams = (
            [torch.cuda.default_stream(shard)
             for shard in self.shards.distinct[1:] + self.shards.distinct[:1]]
            if self.device.type == "cuda" else [])

        # ingest-time row cardinalities (the reference's stored-cardinality
        # fast path): single-leaf counts need no device work at all
        self._dense_row_counts = np.zeros(self.n_rows, dtype=np.int64)
        self._sparse_row_counts = np.zeros(max(self.n_sparse, 1),
                                           dtype=np.int64)
        for meta in self.segment_meta.values():
            if meta["n_stored"]:
                self._dense_row_counts[
                    meta["offset"]: meta["offset"] + meta["n_stored"]
                ] = meta["totals"][meta["sym_ids"], meta["pos_ids"]]
            n_seg_sparse = len(meta["sparse_sym_ids"])
            if n_seg_sparse:
                self._sparse_row_counts[
                    meta["sparse_base"]: meta["sparse_base"] + n_seg_sparse
                ] = meta["totals"][meta["sparse_sym_ids"],
                                   meta["sparse_pos_ids"]]
        # the sparse Mutations reduction's work, resident. Each alphabet
        # owns a contiguous range of sparse rows, {kind: (its index,
        # row_base, n_rows)}. The shards split the stream's entries
        # (reductions.py:99-146), each shard holding its chunk with the
        # non-empty (row, partition) segments inside it and K3's grid for
        # each alphabet: (idx, words, rows, starts, {kind: blocks}). One
        # device's chunk is the whole stream
        self._sparse_alphabets: dict[str, tuple[int, int, int]] = {}
        self._sparse_chunks: list[tuple] = []
        if self.n_sparse:
            row_bounds = [0]
            for kind in ("nuc", "aa"):
                metas = [meta for (k, _), meta in self.segment_meta.items()
                         if k == kind and len(meta["sparse_sym_ids"])]
                n_kind = sum(len(meta["sparse_sym_ids"]) for meta in metas)
                if any(not row_bounds[-1] <= meta["sparse_base"]
                       <= row_bounds[-1] + n_kind - len(meta["sparse_sym_ids"])
                       for meta in metas):
                    raise ValueError(f"the {kind} sparse rows are not one "
                                     f"range after the previous alphabet's")
                self._sparse_alphabets[kind] = (len(row_bounds) - 1,
                                                row_bounds[-1], n_kind)
                row_bounds.append(row_bounds[-1] + n_kind)
            segments = kernels.sparse_segments(
                self.sparse_starts_pp, self.sparse_lengths_pp, row_bounds)
            for shard, (lo, hi) in zip(self.shards.devices, entry_chunks(
                    self.sparse_idx.shape[0], len(self.shards))):
                if hi - lo > _INT32_MAX:  # K3 takes chunk offsets as int32
                    raise ValueError(f"a stream chunk of {hi - lo} entries "
                                     f"exceeds int32: shard the words over "
                                     f"more devices")
                idx, words = self._stream_on[shard]
                chunk = clip_segments(segments, lo, hi)
                self._sparse_chunks.append((
                    idx[lo:hi], words[lo:hi],
                    *(torch.from_numpy(a.astype(np.int32)).to(shard)
                      for a in (chunk.rows, chunk.starts)),
                    {kind: torch.from_numpy(kernels.sparse_blocks(
                        chunk, alphabet)).to(shard)
                     for kind, (alphabet, _, _)
                     in self._sparse_alphabets.items()}))
        self._sparse_counts_memo: tuple | None = None

        # the reference's caps (device_engine.py:424-431, 560-564): the
        # poolless leaf cap keeps the densified [K, PW] block under
        # _SPARSE_K_BYTE_CAP; pool updates chunk at the same bound's cap;
        # a batch splits at the slot count (all of a launch's leaves must be
        # resident at once) or, without the pool, at the poolless cap
        smem_cap = (_smem_k_cap(self.n_partitions) if self.n_sparse
                    else _SPARSE_K_BUCKETS[-1])
        self.max_sparse_k = min(
            max((b for b in _SPARSE_K_BUCKETS
                 if b * self.n_flat_words * 4 <= _SPARSE_K_BYTE_CAP),
                default=_SPARSE_K_BUCKETS[1]),
            smem_cap)
        self._pool_update_k_cap = smem_cap

        # HOT-LEAF POOL: [C + 1, PW/D] rows per shard of densified sparse
        # leaves (row C is scratch; slot c is row c of every shard),
        # SLRU-managed by leaf id: leaves hit on a second distinct call move
        # to _protected (at most 80% of the slots), and eviction takes
        # unprotected LRU leaves first, so a one-pass scan cannot flush the
        # repeatedly hit working set
        self.pool_slots = self._pool_slot_count()
        self.sparse_batch_cap = self.pool_slots or self.max_sparse_k
        self.leaf_pool: list | None = None  # allocated on first use
        self._leaf_slot: OrderedDict[int, int] = OrderedDict()  # LRU
        self._protected: OrderedDict[int, None] = OrderedDict()
        self._protected_cap = max(1, (self.pool_slots * 4) // 5)
        self._free_slots: list[int] = []
        self._pool_lock = threading.RLock()
        # observability: cumulative hit, miss and update traffic
        self.pool_hits = 0
        self.pool_misses = 0
        self.pool_update_dispatches = 0
        # lowerings of partition-free filters (compiled in one partition)
        # and of the rest (compiled in every partition); memo hits in
        # lower_cached count in neither
        self.lowered_once = 0
        self.lowered_per_partition = 0
        # Mutations reductions: queries for which K2 or K3 launched, by
        # alphabet ("nuc", "aa"), the rows K2 (dense) and K3 (sparse, its
        # alphabet's) reduced, the bank words K2 read (its rows times the
        # words of the pieces the filter reaches), K3's reductions (one
        # launch per shard each) and the stream entries they read
        self.mutation_queries = {"nuc": 0, "aa": 0}
        self.mutation_dense_rows = 0
        self.mutation_dense_words_read = 0
        self.mutation_sparse_rows = 0
        self.mutation_sparse_launches = 0
        self.mutation_sparse_entries_read = 0
        self._mutation_lock = threading.Lock()
        # group-bys answered on the card, the cells of their read-backs
        # (partitions times the bucket's columns) and of their key spaces
        # (n_groups), under _group_codes_lock
        self.group_queries = 0
        self.group_cells_read = 0
        self.group_key_cells = 0

        # group codes of the GROUP_CODES_CACHED column lists used last
        # (group_codes_for; None: unsupported), least recent first
        self._group_codes: OrderedDict[tuple, tuple | None] = OrderedDict()
        self._group_codes_lock = threading.Lock()
        # one zero row per shard: the sparse rows and the dyn block of a
        # launch that has none
        self._zero_row = [
            torch.zeros((1, self.shards.local_words), dtype=torch.int32,
                        device=shard) for shard in self.shards.devices]
        self._filters_memo: tuple | None = None
        self._lower_lock = threading.Lock()
        self._batcher: _MicroBatcher | None = None
        self._program_memo: OrderedDict[str, tuple] = OrderedDict()
        self._program_memo_lock = threading.Lock()

    def _on_stream(self):
        """The engine's streams as the current ones: each shard device's
        default stream (no-op off CUDA)."""
        stack = contextlib.ExitStack()
        for stream in self._cuda_streams:
            stack.enter_context(torch.cuda.stream(stream))
        return stack

    def _gather_host(self, parts: list) -> np.ndarray:
        """Per-shard words [..., PW/D] -> host uint32 words [..., PW]."""
        return to_host(gather_words(parts, "cpu"))

    # -- hot-leaf pool ------------------------------------------------------

    def _pool_slot_count(self) -> int:
        """The reference's pool sizing (device_engine.py:483-531), without
        its bank3 condition: SILO_LEAF_POOL_GB, else what the dense-bank
        budget leaves beside the bank and the stream, less 2 GiB of
        headroom, at most 6 GiB and none below 1 GiB; one slot per PW/D
        words, at most 8,192 and the leaf count, none below 64 or with
        SILO_LEAF_POOL=0. Per device, as the reference accounts a mesh
        (device_engine.py:496-517): the bank and the pool shard, the stream
        is whole on every device. Devices may repeat, so the device holding
        the most shards is charged for all of its shards' bank and pool
        rows."""
        per_device = max(Counter(self.shards.devices).values())
        row_bytes = 4 * self.shards.local_words * per_device
        env_pool_gb = os.environ.get("SILO_LEAF_POOL_GB")
        if env_pool_gb is not None:
            pool_budget = float(env_pool_gb) * 2**30
        else:
            budget_bytes = int(float(os.environ.get(
                "SILO_DENSE_BANK_BUDGET_GB", SPARSE_BANK_BUDGET_GB)) * 2**30)
            bank_bytes = self.n_rows * row_bytes
            stream_bytes = (8 * self.sparse_idx.shape[0]
                            if self.sparse_idx is not None else 0)
            free = budget_bytes - bank_bytes - stream_bytes
            pool_budget = min(6 * 2**30, free - 2 * 2**30)
            if pool_budget < 1 * 2**30:
                pool_budget = 0
        want_slots = int(pool_budget // row_bytes)
        if (self.n_sparse > 0 and os.environ.get("SILO_LEAF_POOL", "1") != "0"
                and want_slots >= 64):
            return min(want_slots, self.n_sparse, 8192)
        return 0

    def _alloc_pool(self) -> list[torch.Tensor]:
        """The zeroed pool, one [C + 1, PW/D] word shard per device (slot c
        is row c of every shard)."""
        return [torch.zeros((self.pool_slots + 1, self.shards.local_words),
                            dtype=torch.int32, device=shard)
                for shard in self.shards.devices]

    def _plan_residency(self, leaf_ids: list[int]):
        """Slot-assign every leaf (SLRU bookkeeping) and return (leaf id ->
        slot, update chunks): each chunk is an (ids, slots) pair of at most
        _pool_update_k_cap misses to densify. The caller holds _pool_lock
        and launches the updates and the VM on the engine's stream, so an
        evicted slot is overwritten only after the launches that read it."""
        C = self.pool_slots
        if self.leaf_pool is None:
            self.leaf_pool = self._alloc_pool()
            self._free_slots = list(range(C))
        slot_map: dict[int, int] = {}
        misses: list[int] = []
        for leaf in leaf_ids:
            slot = self._leaf_slot.get(leaf)
            if slot is not None:
                self._leaf_slot.move_to_end(leaf)
                # second distinct touch -> protected segment (SLRU)
                self._protected[leaf] = None
                self._protected.move_to_end(leaf)
                if len(self._protected) > self._protected_cap:
                    self._protected.popitem(last=False)  # demote, stays resident
                slot_map[leaf] = slot
            else:
                misses.append(leaf)
        self.pool_hits += len(slot_map)
        self.pool_misses += len(misses)
        if not misses:
            return slot_map, []
        needed = set(leaf_ids)
        n_evict = len(misses) - len(self._free_slots)
        victims: list[int] = []
        if n_evict > 0:
            # one pass in global LRU order: probationary victims first,
            # protected LRU only when probation can't cover the misses
            protected_spare: list[int] = []
            for old in self._leaf_slot:
                if old in needed:
                    continue
                if old in self._protected:
                    protected_spare.append(old)
                else:
                    victims.append(old)
                    if len(victims) == n_evict:
                        break
            if len(victims) < n_evict:
                victims.extend(protected_spare[: n_evict - len(victims)])
            if len(victims) < n_evict:
                raise ProgramTooLarge(
                    f"leaf pool ({C} slots) smaller than one batch")
        victims.reverse()  # pop() below takes probationary-LRU first
        for leaf in misses:
            if self._free_slots:
                slot = self._free_slots.pop()
            else:
                old = victims.pop()
                slot = self._leaf_slot.pop(old)
                self._protected.pop(old, None)
            self._leaf_slot[leaf] = slot
            slot_map[leaf] = slot
        step = self._pool_update_k_cap
        chunks = [(misses[i: i + step],
                   [slot_map[leaf] for leaf in misses[i: i + step]])
                  for i in range(0, len(misses), step)]
        return slot_map, chunks

    def _drop_pool(self):
        """A failed update must not leave the cache claiming leaves whose
        slots were never written (every later hit would read wrong rows):
        the pool is a cache, so drop it wholesale and let the next launch
        reallocate it."""
        self.leaf_pool = None
        self._leaf_slot.clear()
        self._protected.clear()
        self._free_slots = []

    def _eager_update_chunks(self, chunks) -> None:
        """Densify each update chunk into its pool slots. Caller holds
        _pool_lock and drops the pool on failure."""
        for ids, slots in chunks:
            self._update_pools(self.leaf_pool, ids, slots)
            self.pool_update_dispatches += 1

    def _update_pools(self, pools: list, leaf_ids, slots) -> None:
        """One update chunk into `pools` (one [C + 1, PW/D] tensor per
        shard): the slots are checked once, and the chunk's bounds and slots
        go to each distinct device as one block (kernels.densify_inputs);
        then one K5 launch per shard writes the shard's window."""
        bounds = self._launch_bounds(leaf_ids)
        slots = kernels.check_slots(slots, len(leaf_ids), self.pool_slots + 1)
        inputs = {device: kernels.densify_inputs(bounds, slots, device)
                  for device in self.shards.distinct}
        for device, pool, w_off in zip(self.shards.devices, pools,
                                       self.shards.offsets):
            kernels.densify_rows_into_pool(pool, *self._stream_on[device],
                                           *inputs[device], w_off)

    def warm_pool_updates(self):
        """Allocate the pool before a snapshot goes live (the watcher calls
        this): the reference also compiled its update executables here, and
        the CUDA kernels need no compiling."""
        if not self.pool_slots:
            return
        with self._pool_lock, self._on_stream():
            if self.leaf_pool is None:
                self.leaf_pool = self._alloc_pool()
                self._free_slots = list(range(self.pool_slots))

    def _rewrite_sparse_operands(self, code: np.ndarray,
                                 leaf_ids: list[int],
                                 slot_map: dict[int, int]) -> np.ndarray:
        """B_SPARSE operands index the program's leaf list; the pooled VM
        reads pool slots instead."""
        mask = (wire_opcode(code[1]) == ALU) & (wire_bsrc(code[1]) == B_SPARSE)
        if not mask.any():
            return code
        table = np.asarray([slot_map[leaf] for leaf in leaf_ids],
                           dtype=code.dtype)
        code = code.copy()
        code[0, mask] = table[code[0, mask]]
        return code

    # -- sparse leaves --------------------------------------------------------

    def _bounds(self, leaf_ids) -> np.ndarray:
        """int64 [2, K, P]: the (start, len) of each leaf's stream segment in
        each partition."""
        ids = np.asarray(leaf_ids, dtype=np.int64)
        return np.stack([self.sparse_starts_pp[ids],
                         self.sparse_lengths_pp[ids]])

    def _launch_bounds(self, leaf_ids) -> np.ndarray:
        """_bounds of a densify launch's leaves, which the kernels take as
        int32. Where the stream ends past int32 (measured at build), a
        launch whose offsets pass it raises ProgramTooLarge on either route,
        the reference's check (device_engine.py:903-905); a stream that
        ends within int32 needs no per-launch look."""
        bounds = self._bounds(leaf_ids)
        if (self._stream_end > _INT32_MAX and bounds.size
                and int((bounds[0] + bounds[1]).max()) > _INT32_MAX):
            raise ProgramTooLarge("sparse stream offsets exceed int32")
        return bounds

    def _assemble_sparse(self, sparse_leaves: list[int]) -> np.ndarray:
        """The bounds of a poolless launch's leaves, with the reference's
        two checks (device_engine.py:897-905): the live entries fit the
        entry limit, and every stream offset fits int32."""
        bounds = self._launch_bounds(sparse_leaves)
        e_needed = int(bounds[1].sum())
        if e_needed > _SPARSE_E_MAX:
            raise ProgramTooLarge(f"sparse entries {e_needed}")
        return bounds

    def _densified(self, sparse_leaves: list[int]) -> list[torch.Tensor]:
        """[K, PW/D] densified rows of the leaves, in their order, per
        shard; the bounds go to each distinct device as one block."""
        bounds = self._assemble_sparse(sparse_leaves)
        inputs = {device: kernels.densify_inputs(bounds, None, device)
                  for device in self.shards.distinct}
        return [kernels.densify_rows(*self._stream_on[device], *inputs[device],
                                     self.shards.local_words, w_off)
                for device, w_off in zip(self.shards.devices,
                                         self.shards.offsets)]

    # -- lowering -----------------------------------------------------------

    def lower(self, filter_expr):
        """Compile a filter to ONE partition-uniform VM program; see
        ops/lowering.py."""
        return lowering.lower(self, filter_expr)

    def lower_cached(self, filter_expr, key: str | None = None):
        """lower() with an LRU memo keyed by the filter's canonical JSON:
        serving workloads repeat filters, and lowering compiles in pure
        Python. Lowered programs are read-only downstream."""
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
        n_instr = _round_instr(len(program.opcodes))
        code = pack_code_array(n_instr, program.opcodes, program.operands,
                               program.regspec)
        n_regs = next(b for b in _REG_BUCKETS if b >= program.max_regs)
        return VmArgs(code, n_instr, program.dyn_rows, n_regs,
                      list(program.sparse_leaves))

    def batch_args(self, lowered: list[_Program]) -> VmArgs:
        """The programs concatenated into one, each followed by an
        EMIT_COUNT of reg[0] into its query's slot; dyn operands rebased onto
        the merged dyn rows, and sparse leaves deduplicated across the batch
        (queries in a batch often share leaves). Packed once: per-program
        packing costs numpy small-array overhead per query. Every program
        that reads no register before writing it (_Program.reads_first 0)
        starts a VM segment of its own, which the kernel runs apart on fresh
        registers; any other program joins the segments before it, back to
        one that writes every register it reads first (or to the first
        segment, which starts from zeros as the serial run does)."""
        flat_ops: list[int] = []
        flat_opers: list[int] = []
        flat_spec: list[int] = []
        dyn_rows: list = []
        sparse_leaves: list[int] = []
        sparse_slots: dict[int, int] = {}  # global sparse row -> merged slot
        # (start, registers read before written, registers written)
        segments: list[tuple[int, int, int]] = []
        for qi, program in enumerate(lowered):
            start, reads, writes = (len(flat_ops), program.reads_first,
                                    program.writes)
            while reads and segments:
                start, seg_reads, seg_writes = segments.pop()
                reads = seg_reads | (reads & ~seg_writes)
                writes |= seg_writes
            segments.append((start, reads, writes))
            dyn_base = len(dyn_rows)
            operands = list(program.operands)
            if dyn_base or program.sparse_leaves:
                for i, opcode in enumerate(program.opcodes):
                    if opcode != ALU:
                        continue
                    bsrc = (program.regspec[i] >> 28) & 0xF
                    if bsrc == B_DYN:
                        operands[i] += dyn_base
                    elif bsrc == B_SPARSE:
                        row_id = program.sparse_leaves[operands[i]]
                        slot = sparse_slots.get(row_id)
                        if slot is None:
                            slot = sparse_slots[row_id] = len(sparse_leaves)
                            sparse_leaves.append(row_id)
                        operands[i] = slot
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
        n_instr = _round_instr(len(flat_ops))
        code = pack_code_array(n_instr, flat_ops, flat_opers, flat_spec)
        n_regs = next(b for b in _REG_BUCKETS
                      if b >= max(p.max_regs for p in lowered))
        # the NOP tail joins the last segment
        seg_starts = [start for start, _, _ in segments] + [n_instr]
        return VmArgs(code, n_instr, dyn_rows, n_regs, sparse_leaves,
                      np.asarray(seg_starts, dtype=np.int32))

    def _dyn_tensor(self, dyn_rows: list) -> list[torch.Tensor]:
        """[len(dyn_rows), PW/D] dyn rows per shard on its device; one zero
        row per shard (`_zero_row`) when the program has none, so a
        data-free query uploads only its code."""
        if not dyn_rows:
            return self._zero_row
        dyn = np.zeros((len(dyn_rows), self.n_partitions, self.n_words),
                       dtype=np.uint32)
        for di, rows in enumerate(dyn_rows):
            for pi, row in enumerate(rows):
                dyn[di, pi] = row
        return split_words(dyn.reshape(len(dyn_rows), self.n_flat_words),
                           self.shards.devices)

    def kernel_inputs(self, args: VmArgs, sparse_rows: list | None = None,
                      ) -> tuple:
        """The positional arguments of kernels.vm_run_sharded for one
        launch: the code block as it is (no copy: it is n_instr columns
        wide), the dyn rows uploaded, the rows B_SPARSE operands read
        (`sparse_rows`, one tensor per shard; one zero row for programs
        without sparse leaves), and the segment starts."""
        code = torch.from_numpy(args.code)
        dyns = self._dyn_tensor(args.dyn_rows)
        rows = self._zero_row if sparse_rows is None else sparse_rows
        return (code, args.n_instr, self.banks, dyns, rows, self.fulls,
                args.n_regs, args.seg_starts)

    def _vm(self, args: VmArgs, sparse_rows: list | None = None,
            tail: bool = False, cap: int | None = None):
        """One VM launch per shard: (reg[0] words per shard, counts [4096]
        on the primary device). With `tail` (one program), the launch with
        the filter's epilogue (kernels.vm_filter_sharded): a
        kernels.VmFilter that also holds the words' total and, with `cap`,
        each shard's compact block."""
        inputs = self.kernel_inputs(args, sparse_rows)
        if not tail:
            return kernels.vm_run_sharded(*inputs)
        if args.seg_starts is not None:
            raise ValueError("the filter's epilogue takes one program")
        return kernels.vm_filter_sharded(*inputs[:-1],
                                         offsets=self.shards.offsets, cap=cap)

    def _run(self, args: VmArgs, use_pool: bool = True, tail: bool = False,
             cap: int | None = None):
        """One VM launch on the engine's streams. With sparse leaves, the VM
        reads the hot-leaf pool (misses densified into their slots first,
        all under _pool_lock) or, without the pool or with `use_pool` off,
        a [K, PW] block densified for this launch. Returns (reg[0] words per
        shard, counts), or with `tail` a kernels.VmFilter (see _vm)."""
        with self._on_stream():
            if not args.sparse_leaves:
                return self._vm(args, tail=tail, cap=cap)
            if self.pool_slots and use_pool:
                with self._pool_lock:
                    slot_map, chunks = self._plan_residency(args.sparse_leaves)
                    code = self._rewrite_sparse_operands(
                        args.code, args.sparse_leaves, slot_map)
                    try:
                        self._eager_update_chunks(chunks)
                        return self._vm(args._replace(code=code),
                                        self.leaf_pool, tail, cap)
                    except Exception:
                        self._drop_pool()
                        raise
            return self._vm(args, self._densified(args.sparse_leaves), tail,
                            cap)

    # -- filters ----------------------------------------------------------------

    @staticmethod
    def _trivial(program: _Program) -> int | None:
        """B_FULL or B_ZERO for a single full/empty load, which needs no
        launch, else None."""
        if len(program.opcodes) == 1 and program.opcodes[0] == ALU:
            spec = program.regspec[0]
            bsrc = (spec >> 28) & 0xF
            if (spec >> 24) & 0xF == M_MOVB and bsrc in (B_FULL, B_ZERO):
                return bsrc
        return None

    def _trivial_words(self, program: _Program) -> list | None:
        """The words of a single full/empty load."""
        kind = self._trivial(program)
        if kind is None:
            return None
        if kind == B_FULL:
            return self.fulls
        return [zero[0] for zero in self._zero_row]

    def _trivial_total(self, program: _Program) -> int | None:
        """The total of a single full/empty load, known on the host: every
        sequence, or none."""
        kind = self._trivial(program)
        if kind is None:
            return None
        return sum(self.part_rows) if kind == B_FULL else 0

    def evaluate_device(self, filter_expr) -> list[torch.Tensor]:
        """The FLAT global-word filter bitset on the devices (partition p's
        words live at [p*W, (p+1)*W)): [PW/D] words per shard, one [PW]
        tensor on one device."""
        program, _regs = self.lower(filter_expr)
        trivial = self._trivial_words(program)
        if trivial is not None:
            return trivial
        words, _counts = self._run(self._prepare_program(program))
        return words

    def _per_partition(self, host: np.ndarray) -> list[np.ndarray]:
        """Host flat words [PW] -> per-partition packed bitsets, trimmed."""
        host = host.reshape(self.n_partitions, self.n_words)
        return [
            host[pi, : bitset.words_for(n)] for pi, n in enumerate(self.part_rows)
        ]

    def evaluate(self, filter_expr) -> list[np.ndarray]:
        """Per-partition packed bitsets (host numpy, trimmed)."""
        return self._per_partition(
            self._gather_host(self.evaluate_device(filter_expr)))

    # from this many flat words on, evaluate_compact copies the non-zero
    # words instead of the bitset: the reference's (device_engine.py:784),
    # and the smallest size swept at which the VM launch with its compact
    # blocks, one copy into pinned memory and the host's rebuild was faster
    # per call than the VM and the bitset copy at both 400 and 16,384
    # non-zero words in every run, on an NVIDIA H100 80GB HBM3 at 700.00 W
    # (scripts/torch_fused_ab.py, five runs): at 131,072 words
    # 0.2751-0.4289 and 0.3042-0.4723 ms against 0.4371-1.0205 and
    # 0.3839-0.5879. The cap is the reference's (device_engine.py:785).
    COMPACT_MIN_WORDS = 131072
    COMPACT_CAP_WORDS = 16384

    def evaluate_compact(self, filter_expr) -> list[np.ndarray]:
        """evaluate() for row-materializing actions at scale (Details, Fasta,
        Insertions; the reference's device_engine.py:782-822): the VM launch
        that writes the filter also writes each shard's count of non-zero
        words and the first COMPACT_CAP_WORDS of their (global index, word)
        pairs (kernels.vm_filter_sharded, one launch per card, as the
        reference's dispatch does), one copy per card brings the counts and
        pairs to the host, which rebuilds the bitsets (blocks_to_host).
        When the pairs overflow the cap, the words the VM already wrote are
        copied instead (no second pass). Trivial FULL/ZERO filters and
        corpora under COMPACT_MIN_WORDS flat words copy the bitset."""
        if self.n_flat_words < self.COMPACT_MIN_WORDS:
            return self.evaluate(filter_expr)
        program, _regs = self.lower(filter_expr)
        trivial = self._trivial_words(program)
        if trivial is not None:
            return self._per_partition(self._gather_host(trivial))
        out = self._run(self._prepare_program(program), tail=True,
                        cap=self.COMPACT_CAP_WORDS)
        with self._on_stream():
            host = blocks_to_host(out.blocks, self.COMPACT_CAP_WORDS,
                                  self.n_flat_words)
        if host is None:
            host = self._gather_host(out.words)
        return self._per_partition(host)

    def device_filter(self, filter_expr, span: int = 0) -> "DeviceFilter":
        """Evaluate the filter and KEEP it on the device, with its total
        from the same VM launch (known on the host for a trivial filter):
        Mutations needs only device reductions. `span`: the traced span
        its reductions record under, or 0."""
        program, _regs = self.lower(filter_expr)
        trivial = self._trivial_words(program)
        if trivial is not None:
            return DeviceFilter(self, trivial,
                                self._trivial_total(program), span)
        out = self._run(self._prepare_program(program), tail=True)
        return DeviceFilter(self, out.words, out.total, span)

    # -- group-by (Aggregated with groupByFields) -------------------------

    _GROUP_BUCKETS = (64, 1024, 16384, 1 << 20)
    # column lists whose codes stay on the devices: each holds 1, 2 or 4
    # bytes per sequence slot on every shard (kernels.code_dtype), outside
    # the pool's budget, and the lists come from the clients, so the cache
    # drops the least recent
    GROUP_CODES_CACHED = 8

    def group_codes_for(self, column_names: list[str]):
        """Per-sequence combined group codes for a column list, cached for
        the GROUP_CODES_CACHED lists used last: (codes per shard, n_groups,
        decode(group_id) -> per-column raw code tuple). The codes are built
        on the host ([P, W*32] in the narrowest type that holds them and the
        padding code n_groups, kernels.code_dtype: uint8 up to 255 groups,
        int16 up to 32,767, else int32) and split over the word shards like
        the words: shard d holds the codes of its words' bits, [32 * PW/D]
        on its device. None
        where a column kind cannot be coded densely or the key space exceeds
        the largest bucket, 2^20 groups (the reference's
        device_engine.py:1436-1508, whose host path then answers). The key
        keeps the list's order: the codes, and so the rows' order, follow
        it."""
        key = tuple(column_names)
        with self._group_codes_lock:
            if key in self._group_codes:
                self._group_codes.move_to_end(key)
                return self._group_codes[key]
        result = self._build_group_codes(column_names)
        with self._group_codes_lock:
            self._group_codes[key] = result
            while len(self._group_codes) > self.GROUP_CODES_CACHED:
                self._group_codes.popitem(last=False)
        return result

    def _build_group_codes(self, column_names: list[str]):
        """group_codes_for's value for one column list, uncached."""
        sizes = []
        per_column_codes = []  # per column: list per partition of int64[N]
        per_column_values = []  # per column: sorted unique raw codes | None
        for name in column_names:
            columns = [p.columns[name] for p in self.db.partitions]
            kind = columns[0].kind
            if kind in ("string", "indexed_string", "indexed_pango_lineage",
                        "nuc_insertion", "aa_insertion"):
                codes = [c.ids.astype(np.int64) for c in columns]
                size = max((int(c.max()) + 1 if len(c) else 1) for c in codes)
                per_column_values.append(None)
            elif kind in ("date", "int", "float"):
                if kind == "float":
                    # canonicalize before taking bit patterns: -0.0 == 0.0
                    # and every NaN must be ONE group (host groups by value)
                    raws = []
                    for c in columns:
                        vals = c.values.copy()
                        vals[vals == 0.0] = 0.0
                        vals[np.isnan(vals)] = np.nan
                        raws.append(vals.view(np.int64))
                else:
                    raws = [c.values.astype(np.int64) for c in columns]
                uniq = np.unique(np.concatenate(raws)) if raws else np.zeros(0)
                codes = [np.searchsorted(uniq, r) for r in raws]
                size = max(len(uniq), 1)
                per_column_values.append(uniq)
            else:
                return None
            sizes.append(size)
            per_column_codes.append(codes)
        n_groups = 1
        for size in sizes:
            n_groups *= size
        if n_groups > self._GROUP_BUCKETS[-1]:
            return None
        dtype = {torch.uint8: np.uint8, torch.int16: np.int16,
                 torch.int32: np.int32}[kernels.code_dtype(n_groups)]
        combined = np.full((self.n_partitions, self.n_words * 32), n_groups,
                           dtype=dtype)
        for pi, partition in enumerate(self.db.partitions):
            acc = np.zeros(partition.sequence_count, dtype=np.int64)
            for ci in range(len(column_names)):
                acc = acc * sizes[ci] + per_column_codes[ci][pi]
            combined[pi, : partition.sequence_count] = acc

        def decode(group_id: int):
            out = []
            for ci in range(len(column_names) - 1, -1, -1):
                group_id, code = divmod(group_id, sizes[ci])
                if per_column_values[ci] is not None:
                    code = int(per_column_values[ci][code])
                out.append(code)
            return tuple(reversed(out))

        flat = combined.reshape(-1)
        local = 32 * self.shards.local_words
        codes_on = [torch.from_numpy(flat[d * local:(d + 1) * local]).to(shard)
                    for d, shard in enumerate(self.shards.devices)]
        return codes_on, n_groups, decode

    def group_counts(self, filter_expr, column_names: list[str]):
        """Aggregated with groupByFields on the device: the filter's words,
        then the group-count kernel over every shard's words and codes, one
        launch per card ([P, G] counts, the cards' added on the primary
        device), G the first bucket that holds n_groups, plus one, read back
        through a pinned block (counts_on_host). Returns
        [(decoded group tuple, count)] in the host path's row order, or
        None when the columns are unsupported (group_codes_for). Where the
        calling thread serves a traced group-by (``tracing.SERVING``),
        records ``groupby.filter`` (its parse's end to the filter's launch)
        and ``groupby.reduce`` (the kernel and its read-back) under its
        request, and notes the read-back's end there."""
        prepared = self.group_codes_for(column_names)
        if prepared is None:
            return None
        codes_on, n_groups, decode = prepared
        bucket = next(b for b in self._GROUP_BUCKETS if b >= n_groups)
        traced = tracing.SERVING.group_by
        words = self.evaluate_device(filter_expr)
        filtered = time.time_ns() if traced else 0
        with self._on_stream(), counts_on_host(kernels.group_counts_sharded(
                words, codes_on, self.shards.offsets, self.n_words,
                self.n_partitions, bucket + 1)) as per_part:
            with self._group_codes_lock:
                self.group_queries += 1
                self.group_cells_read += per_part.size
                self.group_key_cells += n_groups
            if traced:
                span, start, _ = traced
                traced[2] = read = time.time_ns()
                recorder = tracing.RECORDER
                recorder.record(tracing.GROUPBY_FILTER, start, filtered,
                                recorder.new_id(), span)
                recorder.record(tracing.GROUPBY_REDUCE, filtered, read,
                                recorder.new_id(), span)
            return group_rows(per_part, n_groups, decode)

    # -- counts -------------------------------------------------------------------

    def count_async(self, filter_expr, program: _Program | None = None) -> torch.Tensor:
        """Filter + popcount on the device without blocking: a 0-d int64
        tensor on the primary device, the total of the VM launch that
        writes the filter (a trivial filter's, known on the host, needs no
        launch)."""
        if program is None:
            program = self.lower(filter_expr)[0]
        known = self._trivial_total(program)
        if known is not None:
            return torch.tensor(known, dtype=torch.int64, device=self.device)
        return self._run(self._prepare_program(program), tail=True).total

    def count(self, filter_expr) -> int:
        """One count: host-answerable programs need no device work."""
        program, _regs = self.lower(filter_expr)
        host = self.host_count(program)
        if host is not None:
            return host
        return int(self.count_async(filter_expr, program=program))

    def count_batch(self, filter_exprs: list) -> list[int]:
        """Many counts, lowered and run through count_programs: the
        programs concatenate, each ending with EMIT_COUNT, in as few
        launches as the caps allow."""
        return self.count_programs([self.lower(f)[0] for f in filter_exprs])

    def host_count(self, program: _Program,
                   allow_interpret: bool = True) -> int | None:
        """A count answerable with NO device work, or None: (a) single
        static-row loads (the row's ingest-time popcount), (b) programs
        touching no bank or sparse rows, interpreted over numpy words
        (skipped when `allow_interpret` is False: inside a wide batch the
        launch is shared and serial host numpy is the worse trade)."""
        n = len(program.opcodes)
        if n == 1 and program.opcodes[0] == ALU:
            spec = program.regspec[0]
            if (spec >> 24) & 0xF == M_MOVB:
                bsrc = (spec >> 28) & 0xF
                operand = program.operands[0]
                if bsrc == B_BANK:
                    return int(self._dense_row_counts[operand])
                if bsrc == B_SPARSE:
                    return int(self._sparse_row_counts[
                        program.sparse_leaves[operand]])
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

    def count_split(self, lowered: list[_Program],
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
            dispatches = self.count_dispatches(device_programs,
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

    def count_programs(self, lowered: list[_Program],
                       max_bucket: int | None = None,
                       span: int = 0) -> list[int]:
        """count_batch over already-lowered programs (the micro-batcher
        lowers per query so one bad query can't poison a whole batch).
        With `span`, the id of a traced batch, the call is recorded under
        it as ``batch.count`` and its count_finish as ``batch.readback``."""
        start = time.time_ns()
        split = self.count_split(lowered, max_bucket=max_bucket)
        read = time.time_ns()
        counts = self.count_finish(*split)
        end = time.time_ns()
        if not span:
            return counts
        recorder = tracing.RECORDER
        count_span = recorder.new_id()
        recorder.record(tracing.BATCH_COUNT, start, end, count_span, span,
                        len(lowered))
        recorder.record(tracing.BATCH_READBACK, read, end, recorder.new_id(),
                        count_span)
        return counts

    def count_dispatches(self, lowered: list[_Program],
                         max_bucket: int | None = None,
                         force_poolless: bool = False,
                         ) -> list[tuple[torch.Tensor, int]]:
        """Non-blocking: (device counts [4096], n_queries) per launch; callers
        slice each [:n_queries]. A batch splits where it exceeds the EMIT
        slots, the instruction cap (`max_bucket`, else the largest bucket),
        the dyn-row cap or the sparse-leaf cap (the pool's slot count; with
        `force_poolless`, the poolless densify cap)."""
        q = len(lowered)
        if q > MAX_BATCH_QUERIES:
            out = []
            for i in range(0, q, MAX_BATCH_QUERIES):
                out.extend(self.count_dispatches(
                    lowered[i: i + MAX_BATCH_QUERIES],
                    max_bucket=max_bucket, force_poolless=force_poolless))
            return out
        # Cold-sweep pool bypass (device_engine.py:1270-1292): when a batch's
        # leaf set is mostly misses and the poolless densify would take fewer
        # launches than pool updates + VM, ride it; the resident hot set
        # survives the sweep
        if self.pool_slots and not force_poolless:
            distinct = {r for p in lowered for r in p.sparse_leaves}
            if len(distinct) > self.max_sparse_k:
                with self._pool_lock:
                    misses = sum(1 for leaf in distinct
                                 if leaf not in self._leaf_slot)
                pooled_n = -(-misses // max(self._pool_update_k_cap, 1)) + 1
                poolless_n = -(-len(distinct) // max(self.max_sparse_k, 1))
                if (2 * misses > len(distinct) and misses > 0
                        and poolless_n < pooled_n):
                    return self.count_dispatches(
                        lowered, max_bucket=max_bucket, force_poolless=True)
        len_cap = max_bucket or _BATCH_LEN_BUCKETS[-1]
        sparse_cap = (self.max_sparse_k if force_poolless
                      else self.sparse_batch_cap)
        total = sum(len(p.opcodes) + 1 for p in lowered)
        total_dyn = sum(len(p.dyn_rows) for p in lowered)
        total_sparse = len({r for p in lowered for r in p.sparse_leaves})
        if q > 1 and (total > len_cap or total_dyn > _DYN_BUCKETS[-1]
                      or total_sparse > sparse_cap):
            acc_len = acc_dyn = 0
            acc_sparse: set[int] = set()
            split = q
            for i, p in enumerate(lowered):
                acc_len += len(p.opcodes) + 1
                acc_dyn += len(p.dyn_rows)
                acc_sparse.update(p.sparse_leaves)
                if i and (acc_len > len_cap or acc_dyn > _DYN_BUCKETS[-1]
                          or len(acc_sparse) > sparse_cap):
                    split = i
                    break
            return (self.count_dispatches(lowered[:split],
                                          max_bucket=max_bucket,
                                          force_poolless=force_poolless)
                    + self.count_dispatches(lowered[split:],
                                            max_bucket=max_bucket,
                                            force_poolless=force_poolless))
        _words, counts = self._run(self.batch_args(lowered),
                                   use_pool=not force_poolless)
        return [(counts, q)]

    def count_coalesced(self, filter_expr, key: str | None = None,
                        span: int = 0, parsed: int = 0) -> int:
        """Count through the serving micro-batcher: concurrent callers are
        coalesced into ONE launch (EMIT_COUNT program concat). `span`: the
        traced request it serves, or 0; `parsed`: when its parse ended."""
        with self._lower_lock:
            if self._batcher is None:
                self._batcher = _MicroBatcher(self)
            batcher = self._batcher
        return batcher.count(filter_expr, key, span, parsed)

    # -- Mutations ------------------------------------------------------------------

    def _filters_for(self, filter_words) -> list[torch.Tensor]:
        """The flat filter, [PW/D] words per shard on its device, for a host
        word list or DeviceFilter (memoized by identity: one Mutations query
        reduces every segment against the same filter)."""
        if isinstance(filter_words, DeviceFilter):
            return filter_words.parts
        key = tuple(id(w) for w in filter_words)
        memo = self._filters_memo
        if memo is not None and memo[0] == key:
            return memo[2]
        dyn = np.zeros((self.n_partitions, self.n_words), dtype=np.uint32)
        for pi, words in enumerate(filter_words):
            dyn[pi, : len(words)] = words
        filters = split_words(dyn.reshape(self.n_flat_words),
                               self.shards.devices)
        # hold a reference to the keyed arrays so ids stay valid
        self._filters_memo = (key, list(filter_words), filters)
        return filters

    def _sparse_counts(self, filter_words,
                       kind: str) -> tuple[np.ndarray, int, int]:
        """(int64 counts of the alphabet's sparse rows, from its row_base
        on; rows launched; entries read): popcount(row & filter) for every
        sparse-tier row of `kind`: one launch of the sparse-counts kernel
        per shard over its entry chunk, against the whole filter on its
        device, reading only the partitions where the filter has a set bit.
        Memoized per filter and alphabet, as the reference memoizes per
        filter; (counts, 0, 0) where the memo answers."""
        key = (kind, id(filter_words) if isinstance(filter_words, DeviceFilter)
               else tuple(id(w) for w in filter_words))
        memo = self._sparse_counts_memo
        if memo is not None and memo[0] == key:
            return memo[2], 0, 0
        _, row_base, n_rows = self._sparse_alphabets[kind]
        filters = self._filters_for(filter_words)
        with self._on_stream():
            whole = {shard: gather_words(filters, shard)
                     for shard in self.shards.distinct}
            counts = kernels.sparse_counts_chunked(
                [(*chunk[:4], chunk[4][kind]) for chunk in self._sparse_chunks],
                [whole[shard] for shard in self.shards.devices],
                self.n_words, row_base, n_rows).cpu().numpy()
        out = counts[:n_rows].astype(np.int64)
        self._sparse_counts_memo = (key, filter_words, out)
        return out, n_rows, int(counts[n_rows])

    def mutation_counts(self, kind: str, name: str, filter_words):
        """counts[S, L] for one segment (see mutation_counts_many)."""
        return self.mutation_counts_many(kind, [name], filter_words)[name]

    def mutation_counts_many(self, kind: str, names: list[str], filter_words):
        """{name: counts[S, L]}: per (symbol, position) popcount of plane &
        filter, summed over partitions. Dense rows reduce with one launch
        of the Mutations kernel per shard over the bank rows of all the
        named segments (one alphabet's segments are one range of rows), in
        the pieces of their partitions' own words where the filter has a
        set bit; sparse rows with one sparse-counts launch over the stream
        for all of the alphabet's segments; majority rows reconstruct as
        |filter| - sum(stored counts at pos) (exact under the
        one-symbol-per-position invariant).
        Both launches are issued before the first readback. A
        DeviceFilter with a span records ``mutations.reduce`` under it."""
        span = getattr(filter_words, "span", 0)
        start = time.time_ns() if span else 0
        if isinstance(filter_words, DeviceFilter):
            filter_total = filter_words.popcount()
        else:
            filter_total = sum(bitset.popcount(w) for w in filter_words)
        full = filter_total == sum(self.part_rows)
        results: dict[str, np.ndarray] = {}
        pending = []
        row_base = self._sparse_alphabets.get(kind, (0, 0, 0))[1]
        with self._on_stream():
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
                pending.append((name, meta))
            dense = [meta for _, meta in pending if meta["n_stored"]]
            dense_lo = min((meta["offset"] for meta in dense), default=0)
            dense_rows = max((meta["offset"] + meta["n_stored"]
                              for meta in dense), default=0) - dense_lo
            dev = (kernels.mutation_counts_sharded(
                self.banks, self._filters_for(filter_words), dense_lo,
                dense_rows, self._dense_pieces) if dense_rows else None)
            need_sparse = any(len(meta["sparse_sym_ids"])
                              for _, meta in pending)
            sparse_all, sparse_rows, sparse_read = (
                self._sparse_counts(filter_words, kind)
                if need_sparse else (None, 0, 0))
            # K2's counts, then the words of each row it read
            dense_all = (dev.cpu().numpy().astype(np.int64)
                         if dense_rows else None)
            dense_read = dense_rows * int(dense_all[-1]) if dense_rows else 0
            if dense_rows or sparse_rows:
                with self._mutation_lock:
                    self.mutation_queries[kind] += 1
                    self.mutation_dense_rows += dense_rows
                    self.mutation_dense_words_read += dense_read
                    self.mutation_sparse_rows += sparse_rows
                    if sparse_rows:
                        self.mutation_sparse_launches += 1
                        self.mutation_sparse_entries_read += sparse_read
            for name, meta in pending:
                length, s_count = meta["length"], meta["s_count"]
                counts = np.zeros((s_count, length), dtype=np.int64)
                per_pos = np.zeros(length, dtype=np.int64)
                if meta["n_stored"]:
                    first = meta["offset"] - dense_lo
                    stored = dense_all[first:first + meta["n_stored"]]
                    counts[meta["sym_ids"], meta["pos_ids"]] = stored
                    np.add.at(per_pos, meta["pos_ids"], stored)
                n_seg_sparse = len(meta["sparse_sym_ids"])
                if n_seg_sparse:
                    first = meta["sparse_base"] - row_base
                    seg_sparse = sparse_all[first: first + n_seg_sparse]
                    counts[meta["sparse_sym_ids"], meta["sparse_pos_ids"]] = (
                        seg_sparse)
                    np.add.at(per_pos, meta["sparse_pos_ids"], seg_sparse)
                counts[meta["majority"], np.arange(length)] = (
                    filter_total - per_pos)
                results[name] = counts
        if span:
            recorder = tracing.RECORDER
            recorder.record(tracing.MUTATIONS_REDUCE, start, time.time_ns(),
                            recorder.new_id(), span)
        return results


class DeviceFilter:
    """A filter result resident on the device: the FLAT global words as
    [PW/D] parts, one per shard, and their total popcount, an int or a 0-d
    tensor on the primary device (the VM launch's, read when first asked).
    Accepted by mutation_counts in place of host word lists. `span`: the
    traced span its reductions record ``mutations.reduce`` under, or 0."""

    def __init__(self, engine: DeviceEngine, parts: list[torch.Tensor],
                 total: int | torch.Tensor, span: int = 0):
        self.engine = engine
        self.parts = parts
        self._total = total
        self.span = span

    def popcount(self) -> int:
        if not isinstance(self._total, int):
            with self.engine._on_stream():
                self._total = int(self._total)
        return self._total


class _MicroBatcher:
    """Coalesces concurrent count() callers into single-launch batches.

    The dispatcher thread loops: drain everything queued (up to
    MAX_BATCH_QUERIES), lower each query individually (so a ProgramTooLarge
    / StructureMismatch fails only its own caller), run the batch in one
    launch, deliver results. Queries arriving while a launch is in flight
    form the next batch. Holds only a weakref to the engine, so dropping the
    engine also ends the thread.

    Traced (``tracing``): an item with a request span is stamped when it is
    queued and when it is released, and its caller records
    ``batcher.enqueue`` (from its parse on), ``batcher.wait`` and
    ``batcher.wake``; a batch taken while tracing is
    on is recorded as ``batch``, with ``batch.lower`` and the launch's
    spans (``count_programs``) under it.
    """

    def __init__(self, engine: DeviceEngine):
        self._engine_ref = weakref.ref(engine)
        self._cv = threading.Condition()
        self._queue: list[dict] = []
        self._thread = threading.Thread(
            target=self._loop, name="silo-torch-microbatch", daemon=True)
        self._thread.start()

    def count(self, filter_expr, key: str | None = None, span: int = 0,
              parsed: int = 0) -> int:
        item = {"filter": filter_expr, "key": key, "done": threading.Event(),
                "result": None, "error": None, "span": span}
        if span:
            item["queued"] = time.time_ns()
        with self._cv:
            self._queue.append(item)
            self._cv.notify()
        item["done"].wait()
        if span:
            woke = time.time_ns()
            recorder = tracing.RECORDER
            recorder.record(tracing.BATCHER_ENQUEUE, parsed, item["queued"],
                            recorder.new_id(), span)
            recorder.record(tracing.BATCHER_WAIT, item["queued"],
                            item["taken"], recorder.new_id(), span)
            recorder.record(tracing.BATCHER_WAKE, item["released"], woke,
                            recorder.new_id(), span, item["batch"])
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    @staticmethod
    def _release(item: dict, taken: int, batch: int = 0) -> None:
        """Hand the item back to its caller; a traced item learns when it
        was taken off the queue and released, and the id of the batch that
        served it."""
        if item["span"]:
            item["taken"] = taken
            item["batch"] = batch
            item["released"] = time.time_ns()
        item["done"].set()

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue:
                    if not self._cv.wait(timeout=1.0) and self._engine_ref() is None:
                        return
                batch = self._queue[:MAX_BATCH_QUERIES]
                del self._queue[: len(batch)]
            taken = time.time_ns()
            engine = self._engine_ref()
            if engine is None:
                for item in batch:
                    item["error"] = RuntimeError("device engine was dropped")
                    self._release(item, taken)
                return
            traced = tracing.enabled()
            recorder = tracing.RECORDER
            batch_span = recorder.new_id() if traced else 0
            ready = []
            for item in batch:
                try:
                    item["program"] = engine.lower_cached(
                        item["filter"], item.get("key"))[0]
                    ready.append(item)
                except Exception as ex:  # noqa: BLE001 — per-query isolation
                    item["error"] = ex
                    self._release(item, taken, batch_span)
            if traced:
                recorder.record(tracing.BATCH_LOWER, taken, time.time_ns(),
                                recorder.new_id(), batch_span, len(batch))
            if ready:
                try:
                    counts = engine.count_programs(
                        [item["program"] for item in ready],
                        max_bucket=SERVE_LEN_BUCKET, span=batch_span)
                    for item, count in zip(ready, counts):
                        item["result"] = count
                except Exception as ex:  # noqa: BLE001 — delivered to every caller
                    for item in ready:
                        item["error"] = ex
                for item in ready:
                    self._release(item, taken, batch_span)
            if traced:
                recorder.record(tracing.BATCH, taken, time.time_ns(),
                                batch_span, 0, len(batch))
            del engine
