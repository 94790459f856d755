"""The port's hand-written CUDA kernels: build, bind, wrap, count.

Six kernels carry the count and Mutations paths over both tiers of the
bank, a seventh the group-by and two more the compact extraction and the
word popcount, each in ``csrc/`` (TPU kernels in
``lapis_silo_tpu/ops/pallas_kernels.py``, or XLA code of the JAX package's
device layer), and two wrappers launch them in the forms the TPU package
wrote as kernels of their own:

- ``vm_run`` (``csrc/vm_run.cu``): the filter VM, replacing ``:526``
  ``vm_run``; a program may come in segments (a batch's queries) that run
  side by side;
- ``mutation_counts`` (``csrc/mutation_counts.cu``): popcount(row & filter)
  per dense bank row, replacing ``:150`` ``mutation_counts_banked`` (naive
  form);
- ``sparse_counts`` (``csrc/sparse_counts.cu``): the same per sparse-tier
  leaf over the CSR stream, replacing ``:438`` ``sparse_filter_popcount``
  and the boundary sums its callers take;
- ``densify_rows`` (``csrc/densify.cu``): sparse leaves into dense rows
  ``[K, PW]``, replacing ``:850`` ``densify_rows``;
- ``densify_rows_into_pool`` (``csrc/densify.cu``): the same, written in
  place into rows of the hot-leaf pool, replacing ``:1252``
  ``densify_rows_into_pool``. Both densify kernels take a word window, so a
  word shard builds only its own words;
- ``vm_run_sharded`` (``csrc/vm_run_sharded.cu``): the filter VM over every
  word shard of a card in one launch per card, the counts summed on the
  card and then across cards on the first shard's device, replacing
  ``:741`` ``vm_run_sharded`` (a single shard runs K1 itself);
- ``mutation_counts_sharded`` (wrapper): K2 on every word shard, the
  shards' counts summed on the first shard's device, replacing ``:777``
  ``mutation_counts_banked_sharded``;
- ``popcount_rows_and_filter`` (wrapper): K2 over every row of a row
  block, replacing ``:104`` ``popcount_rows_and_filter`` (no engine path
  calls it);
- ``group_counts`` and ``group_counts_sharded`` (``csrc/group_counts.cu``):
  the group-by reduction of a filter over per-sequence group codes (uint8,
  int16 or int32), counts per (partition, group), one launch per card over
  all of its word shards, replacing the XLA reduction ``_group_counts_jit``
  (``lapis_silo_tpu/ops/reductions.py:24``), which is no Pallas kernel;
- ``compact_nonzero_sharded`` and ``compact_nonzero`` (``csrc/compact.cu``,
  K10): each word shard's count of non-zero words and the first `cap` of
  their (global index, word) pairs, one launch per card over all of its
  shards, replacing the compact output of the XLA interpreter
  (``lapis_silo_tpu/ops/vm.py:505-514``);
- ``popcount_words_sharded`` and ``popcount_words`` (``csrc/compact.cu``,
  K11): the total population count of the shards' words, one launch per
  card, the cards' totals added on the first shard's device, replacing
  ``_popcount_words_jit`` (``lapis_silo_tpu/ops/reductions.py:19``);
- ``vm_filter_sharded`` (K1 or K6 with the filter's epilogue,
  ``csrc/compact_tile.cuh``): one program's VM launch that also yields the
  total popcount of its words and, with a cap, each shard's compact block,
  as the reference's dispatch yields its ``count`` and ``compact:<cap>``
  outputs (``lapis_silo_tpu/ops/vm.py:500-514``). The engine's routes take
  a filter's total and blocks from it; K10 and K11 serve words already on
  the card.

At first use each source is compiled with its own ``nvcc`` (all started
together) for ``sm_90a`` and the objects are linked into one shared library
with a plain C interface, under ``build/torch_kernels/`` of the checkout,
named by a hash of the sources and flags, and loaded with ``ctypes``. A
build or load that fails raises ``RuntimeError``.

Each wrapper checks device, dtype, shape and contiguity, launches on the
current stream and adds one to its kernel's ``launches``. For tensors on the
CPU it runs the plain PyTorch version instead, which adds one to
``plain_launches``; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..parallel.shards import reduce_sum
from . import reductions
from .vm import (
    B_BANK, B_DYN, B_FULL, B_REG, B_SPARSE, EMIT_COUNT, M_AND, M_MOVB, M_OR,
    M_XOR, MAX_BATCH_QUERIES, MAX_REGS, WIRE_BSRC_SHIFT, WIRE_DST_MASK,
    WIRE_MODE_SHIFT, WIRE_OP_SHIFT, WIRE_RA_SHIFT, WIRE_RB_SHIFT,
)
from .words import popcount

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")


class KernelCounts:
    """Launch counts of one kernel and of its plain version (the serving
    micro-batcher launches from its own thread, hence the lock)."""

    def __init__(self, name: str, source: str):
        self.name = name
        self.source = source
        self.launches = 0
        self.plain_launches = 0
        self._lock = threading.Lock()

    def add(self, plain: bool = False) -> None:
        with self._lock:
            if plain:
                self.plain_launches += 1
            else:
                self.launches += 1


VM_RUN = KernelCounts("vm_run", "lapis_silo_torch/csrc/vm_run.cu")
MUTATION_COUNTS = KernelCounts("mutation_counts",
                               "lapis_silo_torch/csrc/mutation_counts.cu")
SPARSE_COUNTS = KernelCounts("sparse_counts",
                             "lapis_silo_torch/csrc/sparse_counts.cu")
DENSIFY_ROWS = KernelCounts("densify_rows", "lapis_silo_torch/csrc/densify.cu")
DENSIFY_INTO_POOL = KernelCounts("densify_rows_into_pool",
                                 "lapis_silo_torch/csrc/densify.cu")
VM_RUN_SHARDED = KernelCounts("vm_run_sharded",
                              "lapis_silo_torch/csrc/vm_run_sharded.cu")
MUTATION_COUNTS_SHARDED = KernelCounts(
    "mutation_counts_sharded", "lapis_silo_torch/csrc/mutation_counts.cu")
POPCOUNT_ROWS = KernelCounts("popcount_rows_and_filter",
                             "lapis_silo_torch/csrc/mutation_counts.cu")
GROUP_COUNTS = KernelCounts("group_counts",
                            "lapis_silo_torch/csrc/group_counts.cu")
COMPACT_NONZERO = KernelCounts("compact_nonzero",
                               "lapis_silo_torch/csrc/compact.cu")
POPCOUNT_WORDS = KernelCounts("popcount_words",
                              "lapis_silo_torch/csrc/compact.cu")
KERNELS = (VM_RUN, MUTATION_COUNTS, SPARSE_COUNTS, DENSIFY_ROWS,
           DENSIFY_INTO_POOL, VM_RUN_SHARDED, MUTATION_COUNTS_SHARDED,
           POPCOUNT_ROWS, GROUP_COUNTS, COMPACT_NONZERO, POPCOUNT_WORDS)


def reset_counts() -> None:
    for kernel in KERNELS:
        with kernel._lock:
            kernel.launches = 0
            kernel.plain_launches = 0


# -- build and load ---------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "lapis_vm_run": [_P, _I32, _I32, _I32, _P, _I64, _P, _I64, _P, _I64, _P,
                     _I64, _I32, _P, _P, _I32, _P, _I64, _P, _I64, _P, _I64,
                     _I32, _I32, _P],
    "lapis_vm_run_sharded": [_P, _P, _I32, _P, _I32, _P, _P, _P, _I32, _I32,
                             _I32, _I64, _I32, _I32, _I32, _P, _P, _I64, _P,
                             _I64, _I32, _I32, _P],
    "lapis_mutation_counts": [_P, _P, _I64, _I64, _I64, _P, _P],
    "lapis_sparse_counts": [_P, _P, _P, _P, _P, _I64, _I32, _I64, _I64, _P,
                            _P],
    "lapis_densify_rows": [_P, _P, _P, _P, _I64, _I32, _I64, _I64, _I64, _P,
                           _P],
    "lapis_densify_rows_into_pool": [_P, _P, _P, _P, _I64, _I32, _I64, _I64,
                                     _I64, _P, _I64, _P, _P],
    "lapis_group_counts": [ctypes.POINTER(_I64), _I32, _I32, _I32, _I64,
                           _I32, _I32, _I32, _I32, _I32, _I32, _P, _P, _P],
    "lapis_compact_nonzero": [ctypes.POINTER(_I64), _I32, _I32, _I32, _P, _P,
                              _I32, _P],
    "lapis_popcount_words": [ctypes.POINTER(_I64), _I32, _I32, _P, _P, _P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Where the kernels' shared library for the current sources (and the
    headers they include) lives."""
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for source in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        digest.update(source.name.encode())
        digest.update(source.read_bytes())
    return BUILD_DIR / f"liblapis_kernels-{digest.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once; their stderr, or RuntimeError if any
    fails. Every process started here has ended when this returns."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        outs = [proc.communicate(timeout=900) for proc in procs]
    except (OSError, subprocess.TimeoutExpired) as ex:
        raise RuntimeError(f"kernel build failed to run: {ex}") from ex
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for cmd, proc, (_out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"kernel build failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{err}")
    return [err for _out, err in outs]


def build() -> Path:
    """Compile the kernels unless the library for these sources exists: one
    nvcc per source, all at once, then one link. The compiler's resource
    report (-Xptxas -v) lands beside the library as .log."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC_DIR.glob("*.cu"))
    tag = f"{target.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{source.stem}.o" for source in sources]
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    try:
        reports = _run_all([[nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)]
                            for src, obj in zip(sources, objects)])
        _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)]])
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    target.with_suffix(".log").write_text("".join(reports))
    os.replace(tmp, target)
    return target


def load_library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as ex:
                raise RuntimeError(f"kernel library failed to load: {ex}") from ex
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _check(name: str, tensor: torch.Tensor, device: torch.device,
           shape: tuple) -> None:
    """int32, contiguous, on `device`, and of `shape` (None = any size)."""
    if tensor.dtype != torch.int32:
        raise ValueError(f"{name}: dtype {tensor.dtype}, want torch.int32")
    if tensor.device != device:
        raise ValueError(f"{name}: on {tensor.device}, want {device}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if tensor.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(tensor.shape, shape)):
        raise ValueError(f"{name}: shape {tuple(tensor.shape)}, want {shape}")


# -- K1: the filter VM ------------------------------------------------------

def _segment_starts(segments, n_instr: int) -> np.ndarray:
    """`segments` checked as segment starts: int32 [n_seg + 1], 0 first,
    `n_instr` last, non-decreasing (segment s runs instructions
    [starts[s], starts[s + 1])). None is one segment, [0, n_instr]."""
    if segments is None:
        return np.asarray([0, n_instr], dtype=np.int32)
    starts = np.asarray(segments)
    if (starts.ndim != 1 or starts.shape[0] < 2
            or not np.issubdtype(starts.dtype, np.integer)):
        raise ValueError(f"segments: want int starts [n_seg + 1], got "
                         f"{starts.dtype} {starts.shape}")
    if starts[0] != 0 or starts[-1] != n_instr or (np.diff(starts) < 0).any():
        raise ValueError(f"segments must rise from 0 to n_instr {n_instr}")
    return starts.astype(np.int32)


def _list_cap(starts: np.ndarray) -> int:
    """The EMIT list a warp keeps: at most one entry per instruction of its
    segment, and at most one per slot."""
    return min(max(int(np.diff(starts).max()), 1), MAX_BATCH_QUERIES)


def vm_run(code: torch.Tensor, n_instr: int, bank: torch.Tensor,
           dyn: torch.Tensor, sparse_rows: torch.Tensor, full: torch.Tensor,
           n_regs: int, segments=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the first `n_instr` instructions of a wire-format program
    (code [2, L] int32 on the host: operands, packed words) over the flat
    word axis. bank [R, PW], dyn [D, PW], sparse_rows [K, PW] and full [PW]
    hold u32 words as int32. `segments` (host ints, see _segment_starts;
    None: one segment) splits the program into segments that each run on a
    zeroed register file; their EMIT counts add. For the kernel the code
    and the segment starts go to the card as one block, in one copy.
    Returns (reg[0] words of the last segment [PW], EMIT counts [4096]),
    both int32 on the inputs' device."""
    starts = _segment_starts(segments, n_instr)
    _check_vm(code, n_instr, bank, dyn, sparse_rows, full, n_regs)
    if full.device.type == "cpu":
        return vm_run_plain(code, n_instr, bank, dyn, sparse_rows, full, n_regs,
                            starts)
    if full.device.type != "cuda":
        raise ValueError(f"vm_run: no kernel for device {full.device}")
    out = _vm_run(code, n_instr, bank, dyn, sparse_rows, full, n_regs, starts)
    return out.words[0], out.counts


def _vm_run(code: torch.Tensor, n_instr: int, bank: torch.Tensor,
            dyn: torch.Tensor, sparse_rows: torch.Tensor, full: torch.Tensor,
            n_regs: int, starts: np.ndarray, tail: tuple | None = None):
    """K1 over one shard on its card, with checked inputs and segment
    starts; the program and its starts go to the card as one block. With
    `tail` (offsets, cap: one program) the launch runs the filter's
    epilogue, its buffer zeroed by the launch before (_tail_buffer): the
    total and, with a cap, the shard's compact block. A VmFilter."""
    lib = load_library()
    device = full.device
    pw = full.shape[0]
    block = _code_block(code, n_instr, starts).to(device, non_blocking=True)
    words = torch.empty(pw, dtype=torch.int32, device=device)
    offsets, cap = tail if tail is not None else (None, None)
    blocks = None
    if cap is not None:
        blocks = torch.empty((1, 1 + 2 * cap), dtype=torch.int32,
                             device=device)
    # the wide form once its grid gives every SM a CTA of 4 warps, and for
    # a compaction (its tiles fewer and larger)
    wide = (-(-pw // 128) * (starts.shape[0] - 1) >= 4 * _sm_count(device)
            or cap is not None)
    lane_words = 4 if wide else 1
    offset = offsets[0] if offsets else 0
    need = n_fill = None
    if tail is not None:
        _table, _n_tiles, need, n_fill = card_tail(
            (pw,), lane_words, blocks, [offset], cap)
    stream = torch.cuda.current_stream(device)
    with torch.cuda.device(device), _tail_buffer(
            device, stream, need) as (counts, total, epilogue):
        if counts is None:
            counts = torch.zeros(MAX_BATCH_QUERIES, dtype=torch.int32,
                                 device=device)
        err = lib.lapis_vm_run(
            block.data_ptr(), n_instr, starts.shape[0] - 1, _list_cap(starts),
            bank.data_ptr(), bank.shape[0], dyn.data_ptr(), dyn.shape[0],
            sparse_rows.data_ptr(), sparse_rows.shape[0], full.data_ptr(), pw,
            n_regs, words.data_ptr(), counts.data_ptr(), lane_words,
            *epilogue, None if blocks is None else blocks.data_ptr(), offset,
            -1 if cap is None else cap, n_fill or 0, stream.cuda_stream)
        _raise_on(err, "vm_run")
    VM_RUN.add()
    return VmFilter([words], counts, total,
                    None if blocks is None else [blocks])


def _check_vm(code: torch.Tensor, n_instr: int, bank: torch.Tensor,
              dyn: torch.Tensor, sparse_rows: torch.Tensor, full: torch.Tensor,
              n_regs: int) -> int:
    """The VM's inputs checked (the code on the host, the rest int32,
    contiguous and on full's device, one width PW); returns PW."""
    device = full.device
    pw = full.shape[0] if full.dim() == 1 else -1
    _check("full", full, device, (None,))
    _check("code", code, torch.device("cpu"), (2, None))
    _check("bank", bank, device, (None, pw))
    _check("dyn", dyn, device, (None, pw))
    _check("sparse_rows", sparse_rows, device, (None, pw))
    if not 0 <= n_instr <= code.shape[1]:
        raise ValueError(f"n_instr {n_instr} outside [0, {code.shape[1]}]")
    if not 1 <= n_regs <= MAX_REGS:
        raise ValueError(f"n_regs {n_regs} outside [1, {MAX_REGS}]")
    if min(bank.shape[0], dyn.shape[0], sparse_rows.shape[0]) < 1:
        raise ValueError("bank, dyn and sparse_rows need one row at least")
    return pw


def _code_block(code: torch.Tensor, n_instr: int,
                starts: np.ndarray) -> torch.Tensor:
    """The program's code block in pinned host memory, int32
    [2 n_instr + n_seg + 1]: operands, packed words, segment starts. A copy
    to a card from pinned memory does not wait for the stream's queued work,
    as one from pageable memory does, which would serialise the host's
    preparation of each launch with the card's run of the one before."""
    block = torch.empty(2 * n_instr + starts.shape[0], dtype=torch.int32,
                        pin_memory=True)
    out = block.numpy()
    out[:n_instr] = code[0, :n_instr].numpy()
    out[n_instr: 2 * n_instr] = code[1, :n_instr].numpy()
    out[2 * n_instr:] = starts
    return block


def vm_run_plain(code: torch.Tensor, n_instr: int, bank: torch.Tensor,
                 dyn: torch.Tensor, sparse_rows: torch.Tensor,
                 full: torch.Tensor, n_regs: int, segments=None):
    """The plain PyTorch version of vm_run: one Python step per instruction,
    with the clamping and EMIT semantics of the XLA interpreter
    (lapis_silo_tpu/ops/vm.py:625-710), described in csrc/vm_run.cu; each
    segment from fresh registers, its counts added to the others'."""
    VM_RUN.add(plain=True)
    starts = _segment_starts(segments, n_instr).tolist()
    pw = full.shape[0]
    counts = torch.zeros(MAX_BATCH_QUERIES, dtype=torch.int32,
                         device=full.device)
    rows = {B_BANK: bank, B_DYN: dyn, B_SPARSE: sparse_rows}
    operands = code[0, :n_instr].tolist()
    specs = code[1, :n_instr].tolist()
    for lo, hi in zip(starts, starts[1:]):
        regs = torch.zeros((n_regs + 1, pw), dtype=torch.int32,
                           device=full.device)
        seg_counts = torch.zeros_like(counts)
        _run_segment(operands[lo:hi], specs[lo:hi], regs, seg_counts, rows,
                     full, n_regs)
        counts += seg_counts
    return regs[0].clone(), counts


def _run_segment(operands: list, specs: list, regs: torch.Tensor,
                 counts: torch.Tensor, rows: dict, full: torch.Tensor,
                 n_regs: int) -> None:
    """vm_run_plain's interpreter over one segment, in place on `regs`
    [n_regs + 1, PW] and `counts` [4096]."""
    for operand, spec in zip(operands, specs):
        dst = spec & WIRE_DST_MASK
        ra = (spec >> WIRE_RA_SHIFT) & 0x3F
        rb = (spec >> WIRE_RB_SHIFT) & 0x3F
        mode = (spec >> WIRE_MODE_SHIFT) & 0xF
        bsrc = (spec >> WIRE_BSRC_SHIFT) & 0xF
        a = regs[min(ra, n_regs - 1)]
        if bsrc == B_REG:
            b = regs[min(rb, n_regs - 1)]
        elif bsrc in rows:
            src = rows[bsrc]
            b = src[min(max(operand, 0), src.shape[0] - 1)]
        elif bsrc == B_FULL:
            b = full
        else:
            b = torch.zeros_like(full)
        if mode == M_MOVB:
            val = b
        elif mode == M_AND:
            val = a & b
        elif mode == M_OR:
            val = a | b
        elif mode == M_XOR:
            val = a ^ b
        else:
            val = a & (b ^ full)
        if (spec >> WIRE_OP_SHIFT) & 0x3 == EMIT_COUNT:
            # the XLA scatter's index rule: negatives wrap once, the rest
            # of the out-of-range operands are dropped
            slot = operand + MAX_BATCH_QUERIES if operand < 0 else operand
            if 0 <= slot < MAX_BATCH_QUERIES:
                counts[slot] = popcount(a).sum()
        regs[min(dst, n_regs)] = val


def _shard_devices(tensors: list, *per_shard: list) -> list[torch.device]:
    """The shards' devices, those of `tensors` (the kernel wrapper each
    shard runs checks the rest of its inputs); one list entry per shard in
    every argument, and one device type across the shards."""
    if not tensors or any(len(arg) != len(tensors) for arg in per_shard):
        raise ValueError("one entry per shard in every shard list")
    devices = [tensor.device for tensor in tensors]
    if len(devices) > 1 and len({device.type for device in devices}) > 1:
        raise ValueError(f"shards mix device types: {devices}")
    return devices


def _card_members(devices: list) -> dict:
    """{device: the shard indices on it}, devices in first-seen order."""
    members: dict = {}
    for d, device in enumerate(devices):
        members.setdefault(device, []).append(d)
    return members


def vm_run_sharded(code: torch.Tensor, n_instr: int, banks: list,
                   dyns: list, sparse_rows: list, fulls: list,
                   n_regs: int, segments=None) -> tuple[list, torch.Tensor]:
    """vm_run on every word shard: shard d's bank [R, PW_d], dyn rows, sparse
    rows and full mask lie on its device (the VM is word-local; widths may
    differ between shards). Every shard's EMIT counts hold the popcount of
    its own words at a query's last EMIT in each segment, so their sum is
    the global count (the psum of pallas_kernels.py:763). On the cards K6
    (csrc/vm_run_sharded.cu) runs once per distinct card over all of its
    shards, on that card's current stream, and sums their counts there; the
    cards' sums are then added on the first shard's device. A single shard
    runs K1 (vm_run). Returns (reg[0] words per shard, counts [4096]
    int32)."""
    devices = _shard_devices(fulls, banks, dyns, sparse_rows)
    starts = _segment_starts(segments, n_instr)
    for bank, dyn, rows, full in zip(banks, dyns, sparse_rows, fulls):
        _check_vm(code, n_instr, bank, dyn, rows, full, n_regs)
    if devices[0].type == "cpu":
        return vm_run_sharded_plain(code, n_instr, banks, dyns, sparse_rows,
                                    fulls, n_regs, starts)
    if devices[0].type != "cuda":
        raise ValueError(f"vm_run_sharded: no kernel for device {devices[0]}")
    if len(fulls) == 1:
        out = _vm_run(code, n_instr, banks[0], dyns[0], sparse_rows[0],
                      fulls[0], n_regs, starts)
    else:
        out = _vm_run_cards(code, n_instr, banks, dyns, sparse_rows, fulls,
                            n_regs, starts, devices)
    return out.words, out.counts


# K6's shard table: int64 fields per shard, as csrc/vm_run_sharded.cu's
# Shard (bank, its rows, dyn, its rows, sparse rows, their count, full,
# words, width, unused)
SHARD_FIELDS = 10
# K6's aux word per instruction: 1 + a counted EMIT's range-local slot,
# the first instruction of a segment, the destination's byte offset
K6_SLOT_MASK = 0x1FFF
K6_SEG_START = 1 << 13
K6_DST_SHIFT = 14
# warps a K6 launch aims at per SM: about six times the 20 its wide form
# keeps resident at once, so the ranges stay short enough for the SMs to
# finish together (the best of 32-256 at phase 8a's batch on an H100,
# scripts/torch_vm_ab.py); the wide form once it fills every SM's 20
K6_WARPS_PER_SM = 128
K6_RESIDENT_WARPS = 20


class K6Program(NamedTuple):
    """A program as K6 runs it (k6_program): per instruction its operand,
    packed word, register offsets and aux word (int32 [n_instr] each; see
    csrc/vm_run_sharded.cu), the ranges' first instructions and n_instr
    (range_lo [n_ranges + 1]), each range's counted slots
    (range_slots[slot_off[r]:slot_off[r + 1]]), the most slots of a range,
    and whether reg[0] comes out zero (no instruction, or an empty last
    segment)."""

    opers: np.ndarray
    specs: np.ndarray
    regw: np.ndarray
    aux: np.ndarray
    range_lo: np.ndarray
    slot_off: np.ndarray
    range_slots: np.ndarray
    max_slots: int
    zero_words: bool


def k6_program(code: torch.Tensor, n_instr: int, starts: np.ndarray,
               n_ranges: int, n_regs: int, lane_words: int) -> K6Program:
    """The first `n_instr` instructions of `code` [2, L] in segments
    (`starts`, checked) laid out for K6 with `lane_words` words a lane:
    consecutive non-empty segments grouped into at most `n_ranges` ranges
    by the window of n_instr / n_ranges instructions their first
    instruction falls in; each segment's first instruction marked
    K6_SEG_START; registers ra and rb (clamped to n_regs - 1) and the
    destination (clamped to the trash register n_regs) as byte offsets in a
    warp's register file of 128 lane_words bytes a register; each
    EMIT_COUNT that counts (its operand a slot by the XLA scatter's rule,
    negatives in [-4096, 0) wrapped, and no later EMIT of its segment to
    the same slot, which would set it again) given 1 + its slot's index
    among its range's distinct slots."""
    host = code.numpy()
    opers, specs = host[0, :n_instr], host[1, :n_instr]
    stride = 128 * lane_words
    regw = (np.minimum((specs >> WIRE_RA_SHIFT) & 0x3F, n_regs - 1) * stride
            | np.minimum((specs >> WIRE_RB_SHIFT) & 0x3F, n_regs - 1)
            * (stride << 16))
    aux = np.minimum(specs & WIRE_DST_MASK, n_regs) * (stride << K6_DST_SHIFT)
    seg_lo = starts[:-1][starts[:-1] < starts[1:]]
    aux[seg_lo] |= K6_SEG_START
    window = seg_lo // max(-(-n_instr // max(n_ranges, 1)), 1)
    first = np.ones(seg_lo.shape[0], dtype=bool)
    first[1:] = window[1:] != window[:-1]
    range_lo = np.append(seg_lo[first], np.int32(n_instr))
    if not seg_lo.size:
        range_lo = np.zeros(2, dtype=np.int32)  # one empty range
    n_out = range_lo.shape[0] - 1
    emits = np.flatnonzero((specs >> WIRE_OP_SHIFT) & 0x3 == EMIT_COUNT)
    slots = opers[emits]
    slots = np.where(slots < 0, slots + MAX_BATCH_QUERIES, slots)
    if slots.size and not 0 <= slots.min() <= slots.max() < MAX_BATCH_QUERIES:
        keep = (slots >= 0) & (slots < MAX_BATCH_QUERIES)
        emits, slots = emits[keep], slots[keep]
    rng = np.searchsorted(range_lo, emits, side="right") - 1
    if not slots.size or np.bincount(slots).max() <= 1:
        # every slot once (a batch's queries): each EMIT counts, and the
        # ranges' slots are the EMITs in order
        slot_off = np.searchsorted(rng, np.arange(n_out + 1))
        local = np.arange(1, emits.shape[0] + 1) - slot_off[rng]
        range_slots = slots
    else:
        # a segment's last EMIT per slot, first seen from the end
        seg = np.searchsorted(seg_lo, emits, side="right") - 1
        _, last = np.unique((seg * MAX_BATCH_QUERIES + slots)[::-1],
                            return_index=True)
        emits, slots = emits[::-1][last], slots[::-1][last]
        rng = rng[::-1][last]
        keys, local = np.unique(rng * MAX_BATCH_QUERIES + slots,
                                return_inverse=True)
        slot_off = np.searchsorted(keys // MAX_BATCH_QUERIES,
                                   np.arange(n_out + 1))
        local = local.reshape(-1) - slot_off[rng] + 1
        range_slots = keys % MAX_BATCH_QUERIES
    aux[emits] |= local.astype(np.int32)
    return K6Program(
        opers=opers, specs=specs, regw=regw, aux=aux, range_lo=range_lo,
        slot_off=slot_off.astype(np.int32),
        range_slots=range_slots.astype(np.int32),
        max_slots=int((slot_off[1:] - slot_off[:-1]).max()),
        zero_words=bool(n_instr == 0 or starts[-2] == n_instr))


def shard_table(devices: list, shards: list) -> tuple[list, np.ndarray]:
    """K6's table of shards grouped by device in first-seen order: for each
    distinct device (device, its first row, its shards' indices), and the
    table int64 [n_shards, SHARD_FIELDS], one row per shard in that order.
    `shards[d]` is shard d's (bank, bank rows, dyn, dyn rows, sparse rows,
    their count, full, words, width): pointers and counts as ints."""
    for shard in shards:
        if max(shard[1], shard[3], shard[5]) >= 1 << 31 or shard[8] >= 1 << 30:
            raise ValueError("K6 takes row counts under 2^31 and shard "
                             "widths under 2^30 words")
    groups = _card_members(devices)
    order = [index for members in groups.values() for index in members]
    table = np.zeros((len(order), SHARD_FIELDS), dtype=np.int64)
    table[:, :SHARD_FIELDS - 1] = np.asarray([shards[i] for i in order],
                                             dtype=np.int64)
    out, row = [], 0
    for device, members in groups.items():
        out.append((device, row, members))
        row += len(members)
    return out, table


def k6_block(table: np.ndarray, program: K6Program, pin: bool,
             tails: np.ndarray | None = None) -> tuple[torch.Tensor, dict]:
    """K6's inputs for every card as one int32 host block (pinned with
    `pin`, for a copy that does not wait for the card), and the byte offset
    of each part: the shard table at 0 (8-byte aligned), the epilogue's
    table (`tails`, int64 [n_shards, TAIL_FIELDS] in the shard table's
    order; none for a batch), then the operands, packed words, register
    offsets and aux words, range_lo, slot_off and range_slots."""
    if tails is None:
        tails = np.zeros((0, TAIL_FIELDS), dtype=np.int64)
    parts = (("shards", table.view(np.int32).reshape(-1)),
             ("tails", tails.view(np.int32).reshape(-1)),
             ("opers", program.opers), ("specs", program.specs),
             ("regw", program.regw), ("aux", program.aux),
             ("range_lo", program.range_lo),
             ("slot_off", program.slot_off),
             ("range_slots", program.range_slots))
    offsets, size = {}, 0
    for name, part in parts:
        offsets[name] = 4 * size
        size += part.shape[0]
    block = torch.empty(size, dtype=torch.int32, pin_memory=pin)
    host = block.numpy()
    for name, part in parts:
        host[offsets[name] // 4: offsets[name] // 4 + part.shape[0]] = part
    return block, offsets


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _vm_run_cards(code, n_instr, banks, dyns, sparse_rows, fulls, n_regs,
                  starts, devices, tail: tuple | None = None):
    """vm_run_sharded's card route: K6 once per distinct card over all of
    its shards, its shard table and program in one block, launched on
    every card before the cards' counts are summed on devices[0]. A batch
    (no `tail`) adds into one zeroed [4096] counts buffer per card that
    shares one allocation with the card's words. With `tail` (offsets,
    cap: one program) each card's launch runs the filter's epilogue, its
    buffer zeroed by the launch before (_tail_buffer): each shard's word
    blocks rounded up to whole tiles (tail_layout), the card's total and,
    with a cap, its shards' compact blocks; the cards' totals are summed
    as their counts are. A VmFilter."""
    lib = load_library()
    widths = [full.shape[0] for full in fulls]
    members = _card_members(devices)
    offsets, cap = tail if tail is not None else (None, None)
    n_sm = min(map(_sm_count, members))
    target = K6_WARPS_PER_SM * n_sm
    n_live = max(int(np.count_nonzero(starts[1:] > starts[:-1])), 1)
    # wide (8 words a lane) once the card with the fewest word blocks can
    # give every SM the warps it holds at once, and for a compaction (its
    # tiles fewer and larger); ranges enough for that card's warps to reach
    # the target
    n_wblocks = {card: sum(-(-widths[d] // 256) for d in ds)
                 for card, ds in members.items()}
    wide = (min(n_wblocks.values()) * n_live >= K6_RESIDENT_WARPS * n_sm
            or cap is not None)
    if not wide:
        n_wblocks = {card: sum(-(-widths[d] // 32) for d in ds)
                     for card, ds in members.items()}
    n_ranges = min(n_live, -(-target // max(min(n_wblocks.values()), 1)))
    lane_words = 8 if wide else 1
    program = k6_program(code, n_instr, starts, n_ranges, n_regs, lane_words)
    words, counts, tails, blocks = [None] * len(fulls), {}, {}, {}
    for card, ds in members.items():
        head = MAX_BATCH_QUERIES if tail is None else 0
        buf = torch.empty(head + sum(widths[d] for d in ds),
                          dtype=torch.int32, device=card)
        for d, part in zip(ds, buf[head:].split([widths[d] for d in ds])):
            words[d] = part
        if tail is None:
            counts[card] = buf[:head].zero_()
            continue
        if cap is not None:
            blocks[card] = torch.empty((len(ds), 1 + 2 * cap),
                                       dtype=torch.int32, device=card)
        tails[card] = card_tail(
            tuple(widths[d] for d in ds), lane_words, blocks.get(card),
            None if cap is None else [offsets[d] for d in ds], cap)
        n_wblocks[card] = 4 * tails[card][1]
    groups, table = shard_table(devices, [
        (bank.data_ptr(), bank.shape[0], dyn.data_ptr(), dyn.shape[0],
         rows.data_ptr(), rows.shape[0], full.data_ptr(), out.data_ptr(), pw)
        for bank, dyn, rows, full, out, pw in zip(
            banks, dyns, sparse_rows, fulls, words, widths)])
    tail_rows = None
    if tail is not None:
        tail_rows = np.concatenate([tails[card][0]
                                    for card, _row, _ds in groups])
    block, parts = k6_block(table, program, pin=True, tails=tail_rows)
    # 16-byte loads where every row, mask and output is 16-byte aligned
    aligned = not ((table[:, [0, 2, 4, 6, 7, 8]] * [1, 1, 1, 1, 1, 4])
                   % 16).any()
    totals = []
    for card, row, ds in groups:
        _table, _n_tiles, need, n_fill = tails.get(card, (None,) * 4)
        on_card = block.to(card, non_blocking=True)
        base = on_card.data_ptr()
        stream = torch.cuda.current_stream(card)
        with torch.cuda.device(card), _tail_buffer(
                card, stream, need) as (card_counts, total, epilogue):
            counts.setdefault(card, card_counts)
            err = lib.lapis_vm_run_sharded(
                base + 8 * SHARD_FIELDS * row,
                None if tail is None
                else base + parts["tails"] + 8 * TAIL_FIELDS * row, len(ds),
                base + parts["opers"], n_instr, base + parts["range_lo"],
                base + parts["slot_off"], base + parts["range_slots"],
                program.range_lo.shape[0] - 1, lane_words,
                int(wide and aligned), n_wblocks[card], program.max_slots,
                n_regs, int(program.zero_words), counts[card].data_ptr(),
                *epilogue, -1 if cap is None else cap, n_fill or 0,
                stream.cuda_stream)
            _raise_on(err, "vm_run_sharded")
        VM_RUN_SHARDED.add()
        totals.append(total)
    return VmFilter(words, reduce_sum(list(counts.values()), devices[0]),
                    None if tail is None else reduce_sum(totals, devices[0]),
                    None if cap is None else list(blocks.values()))


def vm_run_sharded_plain(code: torch.Tensor, n_instr: int, banks: list,
                         dyns: list, sparse_rows: list, fulls: list,
                         n_regs: int, segments=None) -> tuple[list, torch.Tensor]:
    """The plain PyTorch version of vm_run_sharded: vm_run_plain per shard
    and the same sum."""
    devices = _shard_devices(fulls, banks, dyns, sparse_rows)
    VM_RUN_SHARDED.add(plain=True)
    outs = [vm_run_plain(code, n_instr, bank, dyn, rows, full, n_regs,
                         segments)
            for bank, dyn, rows, full in zip(banks, dyns, sparse_rows, fulls)]
    return ([words for words, _ in outs],
            reduce_sum([counts for _, counts in outs], devices[0]))


# -- K1 and K6 with the filter's epilogue: its total and compact blocks -------

# K1's and K6's epilogue (csrc/compact_tile.cuh): a launch's buffer of
# uint64 holds the EMIT counts (int32 [4096]), the total, the ticket, then
# one descriptor a tile; a shard's epilogue row in K6's block (its block's
# address, offset, first tile, tiles, first fill CTA, fill CTAs); a
# shard's fill CTAs, one per TAIL_FILL_BYTES of the most slots past its
# count (2 cap int32), at most TAIL_MAX_FILL
TAIL_COUNTS = MAX_BATCH_QUERIES // 2
TAIL_HEAD = TAIL_COUNTS + 2
TAIL_FIELDS = 6
TAIL_FILL_BYTES = 8192
TAIL_MAX_FILL = 16


class VmFilter(NamedTuple):
    """One program's VM launch with its epilogue (vm_filter_sharded):
    reg[0] words per shard, the EMIT counts [4096] int32 and the total
    popcount of the words (0-d int64), both on the first shard's device,
    and with a cap one int32 tensor [k, 1 + 2 cap] per distinct device of
    the shards (first-seen order, its rows the blocks of that device's
    shards in shard order), else None."""

    words: list
    counts: torch.Tensor
    total: torch.Tensor
    blocks: list | None


@functools.lru_cache(maxsize=256)
def tail_layout(widths: tuple, block_words: int) -> tuple:
    """The epilogue's tiles over one card's shards of `widths` words: a
    shard's word blocks of `block_words` rounded up to whole tiles of 4
    (an empty shard keeps one: its block is written there), numbered shard
    after shard. Per shard (first tile, tiles), and the launch's tiles."""
    rows, n_tiles = [], 0
    for n in widths:
        tiles = max(1, -(-n // (4 * block_words)))
        rows.append((n_tiles, tiles))
        n_tiles += tiles
    return tuple(rows), n_tiles


def fill_ctas(cap: int) -> int:
    """A shard's fill CTAs in a compaction: one per TAIL_FILL_BYTES of the
    most slots past its count (2 cap int32), at most TAIL_MAX_FILL."""
    return min(TAIL_MAX_FILL, max(1, -(-8 * cap // TAIL_FILL_BYTES)))


def tail_table(blocks: torch.Tensor | None, offsets: list | None,
               rows: tuple, fills: int) -> np.ndarray:
    """K6's epilogue rows for one card's shards, int64 [n_shards,
    TAIL_FIELDS]: the address of each shard's block (a row of `blocks`;
    0 without a cap), its global offset (0 without), its tail_layout row,
    and its first fill CTA and `fills` fill CTAs (numbered shard after
    shard; 0 without a cap)."""
    table = np.zeros((len(rows), TAIL_FIELDS), dtype=np.int64)
    table[:, 2:4] = rows
    if blocks is not None:
        table[:, 0] = [row.data_ptr() for row in blocks]
        table[:, 1] = offsets
        table[:, 4] = fills * np.arange(len(rows))
        table[:, 5] = fills
    return table


def card_tail(widths: tuple, lane_words: int, blocks: torch.Tensor | None,
              offsets: list | None, cap: int | None) -> tuple:
    """One card's epilogue for shards of `widths` words run with
    `lane_words` words a lane: its table (tail_table over tail_layout), its
    tiles, the uint64 its buffer needs (the head, and one descriptor a
    tile with a cap) and its fill CTAs (0 without a cap). K1 over one shard
    takes the same tiles (4 warps of 32 lane_words words)."""
    rows, n_tiles = tail_layout(widths, 32 * lane_words)
    if cap is None:
        return tail_table(None, None, rows, 0), n_tiles, TAIL_HEAD, 0
    fills = fill_ctas(cap)
    return (tail_table(blocks, offsets, rows, fills), n_tiles,
            TAIL_HEAD + n_tiles, fills * len(widths))


def vm_filter_sharded(code: torch.Tensor, n_instr: int, banks: list,
                      dyns: list, sparse_rows: list, fulls: list, n_regs: int,
                      offsets: list | None = None,
                      cap: int | None = None) -> VmFilter:
    """vm_run_sharded for one program (one segment), with the total
    popcount of its words and, with `cap` (and each shard's global word
    offset), each shard's compact block [1 + 2 cap] of its words: the
    count of non-zero words, the first `cap` global indices ascending,
    their words, the fill (compact_nonzero_sharded's blocks). On the cards
    one VM launch per card yields them all: K1 for a single shard, else K6
    per card, each with its epilogue (csrc/compact_tile.cuh); no K10 or
    K11 runs. The words' total is int64; the cards' totals and counts are
    added on the first shard's device."""
    devices = _shard_devices(fulls, banks, dyns, sparse_rows)
    for bank, dyn, rows, full in zip(banks, dyns, sparse_rows, fulls):
        _check_vm(code, n_instr, bank, dyn, rows, full, n_regs)
    if cap is not None:
        if offsets is None:
            raise ValueError("a compaction needs the shards' offsets")
        _check_compact(fulls, offsets, cap)
    if devices[0].type == "cpu":
        return vm_filter_sharded_plain(code, n_instr, banks, dyns,
                                       sparse_rows, fulls, n_regs, offsets,
                                       cap)
    if devices[0].type != "cuda":
        raise ValueError(f"vm_filter_sharded: no kernel for device "
                         f"{devices[0]}")
    starts = _segment_starts(None, n_instr)
    if len(fulls) == 1:
        return _vm_run(code, n_instr, banks[0], dyns[0], sparse_rows[0],
                       fulls[0], n_regs, starts, (offsets, cap))
    return _vm_run_cards(code, n_instr, banks, dyns, sparse_rows, fulls,
                         n_regs, starts, devices, (offsets, cap))


# per (card, stream): the epilogue's buffer the last launch on that stream
# zeroed for the next
_tail_spares: dict = {}
_tail_lock = threading.Lock()


@contextlib.contextmanager
def _tail_buffer(card: torch.device, stream, need: int | None):
    """Under _tail_lock, the epilogue's buffer for a launch on `stream`: at
    least `need` uint64, zeroed (by the launch before on the stream, or by
    a fill the first time and when it grows), and a spare of its size for
    the launch to zero, kept for the next launch once this one is queued
    without error. Yields the EMIT counts (int32 [4096]) and the total
    (0-d int64) in the buffer, and the launch's epilogue arguments (tail,
    its length, spare, its length). A batch (`need` None) takes no buffer:
    (None, None, no epilogue)."""
    if need is None:
        yield None, None, (None, 0, None, 0)
        return
    key = (card, stream.cuda_stream)
    with _tail_lock:
        buf = _tail_spares.pop(key, None)
        if buf is None or buf.shape[0] < need:
            size = max(2 * TAIL_COUNTS, 1 << (need - 1).bit_length())
            buf = torch.zeros(size, dtype=torch.int64, device=card)
        spare = torch.empty_like(buf)
        yield (buf[:TAIL_COUNTS].view(torch.int32), buf[TAIL_COUNTS],
               (buf.data_ptr() + 8 * TAIL_COUNTS, buf.shape[0] - TAIL_COUNTS,
                spare.data_ptr(), spare.shape[0]))
        _tail_spares[key] = spare

def vm_filter_sharded_plain(code: torch.Tensor, n_instr: int, banks: list,
                            dyns: list, sparse_rows: list, fulls: list,
                            n_regs: int, offsets: list | None = None,
                            cap: int | None = None) -> VmFilter:
    """The plain PyTorch version of vm_filter_sharded: vm_run_sharded_plain
    over the one segment, then the plain popcount and (with a cap)
    compaction of its words (ops/reductions.py)."""
    devices = _shard_devices(fulls, banks, dyns, sparse_rows)
    words, counts = vm_run_sharded_plain(code, n_instr, banks, dyns,
                                         sparse_rows, fulls, n_regs)
    total = reduce_sum([reductions.popcount_words(part) for part in words],
                       devices[0])
    blocks = None
    if cap is not None:
        blocks = [torch.stack([reductions.compact_nonzero(words[d], cap,
                                                          offsets[d])
                               for d in ds])
                  for ds in _card_members(devices).values()]
    return VmFilter(words, counts, total, blocks)


# -- K2: the Mutations reduction --------------------------------------------

def mutation_counts(bank: torch.Tensor, filters: torch.Tensor, start: int,
                    n_rows: int) -> torch.Tensor:
    """counts[r] = popcount(bank[start + r] & filters) summed over the word
    axis, for r in [0, n_rows): int32[n_rows] on the inputs' device."""
    device = bank.device
    pw = bank.shape[1] if bank.dim() == 2 else -1
    _check("bank", bank, device, (None, None))
    _check("filters", filters, device, (pw,))
    if start < 0 or n_rows < 0 or start + n_rows > bank.shape[0]:
        raise ValueError(f"rows [{start}, {start + n_rows}) outside the "
                         f"bank's {bank.shape[0]}")
    if device.type == "cpu":
        return mutation_counts_plain(bank, filters, start, n_rows)
    if device.type != "cuda":
        raise ValueError(f"mutation_counts: no kernel for device {device}")
    lib = load_library()
    out = torch.empty(n_rows, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.lapis_mutation_counts(
            bank.data_ptr(), filters.data_ptr(), start, n_rows, pw,
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "mutation_counts")
    MUTATION_COUNTS.add()
    return out


def mutation_counts_plain(bank: torch.Tensor, filters: torch.Tensor,
                          start: int, n_rows: int) -> torch.Tensor:
    """The plain PyTorch version of mutation_counts (ops/reductions.py)."""
    MUTATION_COUNTS.add(plain=True)
    return reductions.mutation_counts(bank, filters, start, n_rows)


def mutation_counts_sharded(banks: list, filters: list, start: int,
                            n_rows: int) -> torch.Tensor:
    """mutation_counts on every word shard (bank [R, PW/D] and filter
    [PW/D] on the shard's device), the per-row counts summed on the first
    shard's device (pallas_kernels.py:777-798): int32[n_rows]."""
    devices = _shard_devices(filters, banks)
    counts = [mutation_counts(bank, filt, start, n_rows)
              for bank, filt in zip(banks, filters)]
    MUTATION_COUNTS_SHARDED.add(plain=devices[0].type == "cpu")
    return reduce_sum(counts, devices[0])


def mutation_counts_sharded_plain(banks: list, filters: list, start: int,
                                  n_rows: int) -> torch.Tensor:
    """The plain PyTorch version of mutation_counts_sharded."""
    devices = _shard_devices(filters, banks)
    MUTATION_COUNTS_SHARDED.add(plain=True)
    return reduce_sum([mutation_counts_plain(bank, filt, start, n_rows)
                       for bank, filt in zip(banks, filters)], devices[0])


def popcount_rows_and_filter(rows: torch.Tensor,
                             filt: torch.Tensor) -> torch.Tensor:
    """counts[i] = popcount(rows[i] & filt) for every row of rows [R, W]:
    K2 over all rows (start 0), int32[R]. It replaces
    popcount_rows_and_filter (pallas_kernels.py:104), whose ROW_BLOCK /
    WORD_BLOCK padding the kernel does not need."""
    out = mutation_counts(rows, filt, 0, rows.shape[0])
    POPCOUNT_ROWS.add(plain=rows.device.type == "cpu")
    return out


def popcount_rows_and_filter_plain(rows: torch.Tensor,
                                   filt: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of popcount_rows_and_filter."""
    POPCOUNT_ROWS.add(plain=True)
    return reductions.mutation_counts(rows, filt, 0, rows.shape[0])


# -- K3: the sparse-tier Mutations reduction --------------------------------

def _check_stream(idx: torch.Tensor, words: torch.Tensor, starts: torch.Tensor,
                  lens: torch.Tensor, device: torch.device) -> None:
    """The CSR stream (idx, words [E]) and per-(leaf, partition) bounds
    (starts, lens [L, P]), all int32 on `device`."""
    _check("idx", idx, device, (None,))
    _check("words", words, device, (idx.shape[0],))
    _check("starts", starts, device, (None, None))
    _check("lens", lens, device, tuple(starts.shape))
    if starts.shape[0] and not starts.shape[1]:
        raise ValueError("starts/lens need one segment per leaf at least")


def sparse_counts(idx: torch.Tensor, words: torch.Tensor,
                  filters: torch.Tensor, starts: torch.Tensor,
                  lens: torch.Tensor) -> torch.Tensor:
    """counts[l] = sum over leaf l's segments [starts[l, p], +lens[l, p]) of
    popcount(words[e] & filters[idx[e]]): int32[L] on the inputs' device.
    Entries past the stream or with idx outside the filter count 0."""
    device = filters.device
    _check("filters", filters, device, (None,))
    _check_stream(idx, words, starts, lens, device)
    if device.type == "cpu":
        return sparse_counts_plain(idx, words, filters, starts, lens)
    if device.type != "cuda":
        raise ValueError(f"sparse_counts: no kernel for device {device}")
    lib = load_library()
    out = torch.empty(starts.shape[0], dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.lapis_sparse_counts(
            idx.data_ptr(), words.data_ptr(), filters.data_ptr(),
            starts.data_ptr(), lens.data_ptr(), starts.shape[0],
            starts.shape[1], filters.shape[0], idx.shape[0], out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "sparse_counts")
    SPARSE_COUNTS.add()
    return out


def sparse_counts_plain(idx: torch.Tensor, words: torch.Tensor,
                        filters: torch.Tensor, starts: torch.Tensor,
                        lens: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of sparse_counts (ops/reductions.py)."""
    SPARSE_COUNTS.add(plain=True)
    return reductions.sparse_counts(idx, words, filters, starts, lens)


def sparse_counts_chunked(chunks: list, filters: list) -> torch.Tensor:
    """sparse_counts over a stream split into entry chunks, one per shard
    (the entry split of reductions.py:99-146): chunk d is (idx, words,
    starts, lens) on shard d's device, its bounds clipped to the chunk
    (reductions.clip_bounds), and filters[d] the WHOLE filter [PW] on that
    device. Every entry lies in one chunk, so the per-leaf sums of the
    chunks, taken on the first chunk's device, are the stream's counts:
    int32[L]."""
    devices = _shard_devices(filters, chunks)
    return reduce_sum([sparse_counts(idx, words, filt, starts, lens)
                       for (idx, words, starts, lens), filt
                       in zip(chunks, filters)], devices[0])


# -- K4 and K5: densify sparse leaves ---------------------------------------

def _check_window(pw: int, w_off: int) -> None:
    if pw < 1:
        raise ValueError(f"pw {pw} < 1")
    if w_off < 0:
        raise ValueError(f"w_off {w_off} < 0")


def check_slots(slots, n_leaves: int, n_rows: int) -> np.ndarray:
    """Host slots (a list, an array or a CPU tensor of ints) checked as the
    rows one K5 launch writes: one per leaf, inside the pool's `n_rows`
    rows, distinct. Returns them as int32 [n_leaves]."""
    host = np.asarray(slots).reshape(-1)
    if host.size and not np.issubdtype(host.dtype, np.integer):
        raise ValueError(f"slots: want ints, got {host.dtype}")
    if host.shape[0] != n_leaves:
        raise ValueError(f"{host.shape[0]} slots for {n_leaves} leaves")
    if host.size and (host.min() < 0 or host.max() >= n_rows):
        raise ValueError(f"slots outside the pool's rows [0, {n_rows})")
    ordered = np.sort(host)
    if (ordered[1:] == ordered[:-1]).any():
        raise ValueError("slots of one launch must be distinct")
    return host.astype(np.int32)


def _staged(size: int, device: torch.device) -> torch.Tensor:
    """An int32 host block of `size` to fill and _send to `device`: pinned
    for a card."""
    return torch.empty(size, dtype=torch.int32,
                       pin_memory=device.type == "cuda")


def _send(block: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A _staged block on `device`: one copy, not waiting for the card."""
    return (block.to(device, non_blocking=True) if device.type == "cuda"
            else block)


def densify_inputs(bounds: np.ndarray, slots: np.ndarray | None,
                   device: torch.device) -> tuple:
    """A densify launch's per-leaf inputs on `device` from ONE block: the
    bounds [2, K, P] (host ints that fit int32) as (starts, lens) [K, P],
    and the K5 slots [K] (checked host int32, or None) after them. For a
    card the block is staged in pinned memory and copied with
    non_blocking=True: a copy from pageable memory would wait for the
    stream's queued work (PyTorch's pinned allocator keeps the block until
    the copy has run, as for _code_block)."""
    n_leaves, n_parts = bounds.shape[1:]
    n_bounds = 2 * n_leaves * n_parts
    block = _staged(n_bounds + (0 if slots is None else n_leaves), device)
    host = block.numpy()
    host[:n_bounds] = bounds.reshape(-1)
    if slots is not None:
        host[n_bounds:] = slots
    block = _send(block, device)
    starts = block[:n_bounds // 2].view(n_leaves, n_parts)
    lens = block[n_bounds // 2:n_bounds].view(n_leaves, n_parts)
    return (starts, lens) if slots is None else (starts, lens,
                                                 block[n_bounds:])


def densify_rows(idx: torch.Tensor, words: torch.Tensor, starts: torch.Tensor,
                 lens: torch.Tensor, pw: int, w_off: int = 0) -> torch.Tensor:
    """[K, pw] int32 rows over the global words [w_off, w_off + pw): row k
    is zero except at the entries of leaf k's segments (starts/lens [K, P])
    whose index lies in that window, where row[idx[e] - w_off] = words[e].
    Entries past the stream or outside the window are skipped. The kernel
    takes the stream's contract: within each (leaf, partition) segment the
    indices strictly ascend, as the engine's stream does by construction
    (device_engine._check_stream); for every stream that keeps it, kernel
    and plain version agree bit for bit."""
    device = idx.device
    _check_stream(idx, words, starts, lens, device)
    _check_window(pw, w_off)
    if device.type == "cpu":
        return densify_rows_plain(idx, words, starts, lens, pw, w_off)
    if device.type != "cuda":
        raise ValueError(f"densify_rows: no kernel for device {device}")
    lib = load_library()
    out = torch.empty((starts.shape[0], pw), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.lapis_densify_rows(
            idx.data_ptr(), words.data_ptr(), starts.data_ptr(),
            lens.data_ptr(), starts.shape[0], starts.shape[1], pw, w_off,
            idx.shape[0], out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "densify_rows")
    DENSIFY_ROWS.add()
    return out


def densify_rows_into_pool(pool: torch.Tensor, idx: torch.Tensor,
                           words: torch.Tensor, starts: torch.Tensor,
                           lens: torch.Tensor, slots, w_off: int = 0) -> None:
    """densify_rows over the window of pool [C + 1, pw] int32 at `w_off`,
    with leaf k written in place into pool row slots[k]; every other pool
    row stays as it was. `slots` are K distinct rows of the pool: host ints,
    which are checked (check_slots) and uploaded, or an int32 tensor [K]
    already on the pool's device, which the caller has checked (the engine
    checks and uploads each update chunk once). The stream's contract is
    densify_rows'."""
    device = pool.device
    _check("pool", pool, device, (None, None))
    _check_stream(idx, words, starts, lens, device)
    _check_window(pool.shape[1], w_off)
    if isinstance(slots, torch.Tensor) and slots.device == device:
        _check("slots", slots, device, (starts.shape[0],))
    else:
        host = check_slots(slots, starts.shape[0], pool.shape[0])
        slots = _staged(host.shape[0], device)
        slots.numpy()[:] = host
        slots = _send(slots, device)
    if device.type == "cpu":
        densify_rows_into_pool_plain(pool, idx, words, starts, lens, slots,
                                     w_off)
        return
    if device.type != "cuda":
        raise ValueError(f"densify_rows_into_pool: no kernel for device {device}")
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.lapis_densify_rows_into_pool(
            idx.data_ptr(), words.data_ptr(), starts.data_ptr(),
            lens.data_ptr(), starts.shape[0], starts.shape[1], pool.shape[1],
            w_off, idx.shape[0], slots.data_ptr(), pool.shape[0],
            pool.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "densify_rows_into_pool")
    DENSIFY_INTO_POOL.add()


def _densify(idx, words, starts, lens, pw, w_off) -> torch.Tensor:
    """The densified rows [K, pw] of the window at `w_off`: torch.zeros,
    then one index assignment of every leaf's entries at (leaf, idx -
    w_off)."""
    n_leaves, n_per_leaf = starts.shape
    n_entries = idx.shape[0]
    out = torch.zeros((n_leaves, pw), dtype=torch.int32, device=idx.device)
    seg_starts = starts.reshape(-1).to(torch.int64)
    seg_lens = lens.reshape(-1).to(torch.int64).clamp(min=0)
    # entry j of segment s sits at stream position starts[s] + j
    seg = torch.repeat_interleave(
        torch.arange(seg_starts.shape[0], device=idx.device), seg_lens)
    first = torch.cumsum(seg_lens, 0) - seg_lens
    pos = (torch.arange(seg.shape[0], device=idx.device) - first[seg]
           + seg_starts[seg])
    inside = (pos >= 0) & (pos < n_entries)
    pos = pos[inside]
    leaf = seg[inside] // n_per_leaf
    col = idx[pos].to(torch.int64) - w_off
    keep = (col >= 0) & (col < pw)
    out[leaf[keep], col[keep]] = words[pos[keep]]
    return out


def densify_rows_plain(idx, words, starts, lens, pw: int,
                       w_off: int = 0) -> torch.Tensor:
    """The plain PyTorch version of densify_rows."""
    DENSIFY_ROWS.add(plain=True)
    return _densify(idx, words, starts, lens, pw, w_off)


def densify_rows_into_pool_plain(pool, idx, words, starts, lens, slots,
                                 w_off: int = 0) -> None:
    """The plain PyTorch version of densify_rows_into_pool: densify_rows'
    rows assigned into pool[slots]."""
    DENSIFY_INTO_POOL.add(plain=True)
    slots = torch.as_tensor(slots, dtype=torch.int64).reshape(-1)
    pool[slots.to(pool.device)] = _densify(idx, words, starts, lens,
                                           pool.shape[1], w_off)


# -- K9: the group-by reduction ---------------------------------------------

# the group codes' types, narrowest first (DeviceEngine stores a column
# list's codes in the first that holds them and the padding code), and the
# bins a code of each can reach: H = min(G, this)
CODE_DTYPES = (torch.uint8, torch.int16, torch.int32)
_CODE_BINS = {torch.uint8: 256, torch.int16: 32768, torch.int32: 1 << 62}
# threads of a K9 CTA, one 16-byte quad of codes each; its [H] bins in
# shared memory up to K9_SMEM_BINS; its output zeroed by the launch before
# on the same stream while it holds up to K9_SPARE_BINS counts
K9_THREADS = 256
K9_SMEM_BINS = 49152
K9_SPARE_BINS = 1 << 20
K9_MAX_CTAS = 4096
K9_MAX_SHARDS = 32  # shards of one card in one launch's shard table


def code_dtype(n_groups: int) -> torch.dtype:
    """The narrowest of CODE_DTYPES that holds the codes [0, n_groups], the
    padding code n_groups included."""
    for dtype in CODE_DTYPES:
        if n_groups <= torch.iinfo(dtype).max:
            return dtype
    raise ValueError(f"{n_groups} groups do not fit int32 codes")


def k9_bins(dtype: torch.dtype, n_groups: int) -> int:
    """H: the bins codes of `dtype` reach when clipped to n_groups - 1."""
    return min(n_groups, _CODE_BINS[dtype])


def k9_block(n_words: int, n_bins: int, code_bytes: int) -> int:
    """Words per K9 CTA for a card's `n_words`: a quad of codes per thread
    (16 / code_bytes codes), more while the CTA's bins outnumber its bits
    (so zeroing and flushing them stays below the bits' own work), and more
    while the grid would pass K9_MAX_CTAS."""
    blk = K9_THREADS * 16 // code_bytes // 32
    while n_bins <= K9_SMEM_BINS and blk < 8192 and blk * 32 < n_bins:
        blk *= 2
    while -(-n_words // blk) > K9_MAX_CTAS:
        blk *= 2
    return blk


@functools.lru_cache(maxsize=256)
def k9_layout(widths: tuple, offsets: tuple, part_words: int,
              blk: int) -> tuple:
    """The numbers of K9's shard table for one card. Shard s holds the
    global words [offsets[s], offsets[s] + widths[s]), partition p the
    global words [p * part_words, (p + 1) * part_words); each CTA takes at
    most `blk` words of one shard inside one partition, shard by shard,
    partition by partition, in word order. Per shard (width, its words in
    its first partition, its first CTA, its CTAs in its first partition,
    its first partition), the CTAs of a whole partition, and the launch's
    CTAs."""
    if len(widths) > K9_MAX_SHARDS:
        raise ValueError(f"K9 takes at most {K9_MAX_SHARDS} shards a card, "
                         f"got {len(widths)}")
    rows, n_ctas = [], 0
    cf = -(-part_words // blk)
    for n, off in zip(widths, offsets):
        p_lo = off // part_words
        len0 = min((p_lo + 1) * part_words - off, n)
        c0 = -(-len0 // blk)
        n_full, tail = divmod(n - len0, part_words)
        rows.append((n, len0, n_ctas, c0, p_lo))
        n_ctas += c0 + n_full * cf + -(-tail // blk)
    return tuple(rows), cf, n_ctas


def k9_table(words: list, codes: list, rows: tuple) -> ctypes.Array:
    """K9's shard table for one card, passed to the kernel by value: int64
    [n_shards, 7], per shard the address of its words and of its codes and
    its k9_layout row."""
    table = (ctypes.c_longlong * (7 * len(rows)))()
    for i, (part, shard_codes, row) in enumerate(zip(words, codes, rows)):
        table[7 * i:7 * i + 7] = (part.data_ptr(), shard_codes.data_ptr(),
                                  *row)
    return table


def _check_group_shard(words: torch.Tensor, codes: torch.Tensor, w_off: int,
                       part_words: int, n_partitions: int,
                       n_groups: int) -> None:
    """One shard's K9 inputs: words int32 [n] and codes [32 n] of a code
    type (16-byte aligned on a card) on one device, the window inside the
    n_partitions x part_words words."""
    device = words.device
    _check("words", words, device, (None,))
    if codes.dtype not in CODE_DTYPES:
        raise ValueError(f"codes: dtype {codes.dtype}, want one of "
                         f"{CODE_DTYPES}")
    if codes.device != device or not codes.is_contiguous():
        raise ValueError(f"codes: want contiguous on {device}")
    if tuple(codes.shape) != (32 * words.shape[0],):
        raise ValueError(f"codes: shape {tuple(codes.shape)}, want "
                         f"({32 * words.shape[0]},)")
    if device.type == "cuda" and codes.data_ptr() % 16:
        raise ValueError("codes: K9 loads them in 16-byte quads; want a "
                         "16-byte aligned start")
    if part_words < 1 or n_groups < 1 or n_partitions < 1:
        raise ValueError(f"part_words {part_words}, n_groups {n_groups} and "
                         f"n_partitions {n_partitions} must be positive")
    if w_off < 0 or w_off + words.shape[0] > part_words * n_partitions:
        raise ValueError(f"window [{w_off}, {w_off + words.shape[0]}) outside "
                         f"the {n_partitions} x {part_words} words")


def group_counts(words: torch.Tensor, codes: torch.Tensor, w_off: int,
                 part_words: int, n_partitions: int,
                 n_groups: int) -> torch.Tensor:
    """counts[p, g] = the number of set bits of the window's words [n] (the
    global words [w_off, w_off + n); partition p owns the global words
    [p * part_words, (p + 1) * part_words)) whose code in codes [n * 32]
    (one per bit, uint8, int16 or int32), clipped to n_groups - 1, is g;
    negative codes count nowhere. int32 [n_partitions, n_groups] on the
    inputs' device."""
    _check_group_shard(words, codes, w_off, part_words, n_partitions,
                       n_groups)
    device = words.device
    if device.type == "cpu":
        return group_counts_plain(words, codes, w_off, part_words,
                                  n_partitions, n_groups)
    if device.type != "cuda":
        raise ValueError(f"group_counts: no kernel for device {device}")
    return _group_counts_cards([words], [codes], [w_off], [device],
                               part_words, n_partitions, n_groups)


def group_counts_sharded(words: list, codes: list, offsets: list,
                         part_words: int, n_partitions: int,
                         n_groups: int) -> torch.Tensor:
    """group_counts over every word shard (shard d's words [n_d] and codes
    [32 n_d], of one code type, on its device, its window at the global word
    offsets[d]), summed: int32 [n_partitions, n_groups] on the first shard's
    device. On the cards K9 runs once per distinct card over all of its
    shards, on that card's current stream, and sums them there; the cards'
    sums are then added on the first shard's device."""
    devices = _shard_devices(words, codes, offsets)
    if len({c.dtype for c in codes}) > 1:
        raise ValueError("shards mix code types")
    for part, shard_codes, offset in zip(words, codes, offsets):
        _check_group_shard(part, shard_codes, offset, part_words,
                           n_partitions, n_groups)
    if devices[0].type == "cpu":
        return group_counts_sharded_plain(words, codes, offsets, part_words,
                                          n_partitions, n_groups)
    if devices[0].type != "cuda":
        raise ValueError(f"group_counts_sharded: no kernel for device "
                         f"{devices[0]}")
    return _group_counts_cards(words, codes, offsets, devices, part_words,
                               n_partitions, n_groups)


# per (card, stream, shape): the output the last K9 launch on that stream
# zeroed for the next
_k9_spares: dict = {}
_k9_spares_lock = threading.Lock()


def _group_counts_cards(words, codes, offsets, devices, part_words,
                        n_partitions, n_groups) -> torch.Tensor:
    """K9 once per distinct card over all of its shards (the card's shard
    table goes with the launch, no copy precedes it), each card's counts
    summed on the card; the cards' counts then added on devices[0]."""
    lib = load_library()
    code_bytes = codes[0].element_size()
    n_bins = k9_bins(codes[0].dtype, n_groups)
    shape = (n_partitions, n_groups)
    partials = []
    for card, ds in _card_members(devices).items():
        widths = tuple(words[d].shape[0] for d in ds)
        blk = k9_block(sum(widths), n_bins, code_bytes)
        rows, cf, n_ctas = k9_layout(widths, tuple(offsets[d] for d in ds),
                                     part_words, blk)
        table = k9_table([words[d] for d in ds], [codes[d] for d in ds], rows)
        stream = torch.cuda.current_stream(card)
        with torch.cuda.device(card), _k9_spares_lock:
            # the lock keeps the launches in the order they take the spares
            key = (card, stream.cuda_stream, shape)
            spare = None
            if n_partitions * n_groups > K9_SPARE_BINS or not n_ctas:
                counts = torch.zeros(shape, dtype=torch.int32, device=card)
            else:
                counts = _k9_spares.pop(key, None)
                if counts is None:
                    counts = torch.zeros(shape, dtype=torch.int32, device=card)
                spare = torch.empty(shape, dtype=torch.int32, device=card)
            partials.append(counts)
            if not n_ctas:
                continue
            err = lib.lapis_group_counts(
                table, len(ds), cf, n_ctas, part_words, blk, K9_THREADS,
                code_bytes, n_groups, n_bins, n_partitions,
                counts.data_ptr(), None if spare is None else spare.data_ptr(),
                stream.cuda_stream)
            _raise_on(err, "group_counts")
            if spare is not None:
                _k9_spares[key] = spare
        GROUP_COUNTS.add()
    return reduce_sum(partials, devices[0])


def group_counts_plain(words: torch.Tensor, codes: torch.Tensor, w_off: int,
                       part_words: int, n_partitions: int,
                       n_groups: int) -> torch.Tensor:
    """The plain PyTorch version of group_counts (ops/reductions.py)."""
    GROUP_COUNTS.add(plain=True)
    return reductions.group_counts(words, codes, w_off, part_words,
                                   n_partitions, n_groups)


def group_counts_sharded_plain(words: list, codes: list, offsets: list,
                               part_words: int, n_partitions: int,
                               n_groups: int) -> torch.Tensor:
    """The plain PyTorch version of group_counts_sharded: group_counts_plain
    per shard and the same sum."""
    devices = _shard_devices(words, codes, offsets)
    return reduce_sum([group_counts_plain(part, shard_codes, offset,
                                          part_words, n_partitions, n_groups)
                       for part, shard_codes, offset
                       in zip(words, codes, offsets)], devices[0])


# -- K10, K11: the compact extraction and the word popcount ------------------

# K10's tiles and K11's CTAs: 1,024 16-byte quads (4,096 words) each, as
# csrc/compact.cu's kTileQuads; shards of one card in one launch's table
COMPACT_TILE_QUADS = 1024
COMPACT_MAX_SHARDS = 32
# K10's scratch per stream holds the ticket and one descriptor a tile, in
# buffers of at least this many entries
_K10_MIN_SCRATCH = 1024


@functools.lru_cache(maxsize=256)
def compact_layout(widths: tuple, heads: tuple) -> tuple:
    """The tiles of K10 and K11 over one card's shards: shard s holds
    widths[s] words starting heads[s] words past a 16-byte boundary, so its
    16-byte quads number ceil((head + n) / 4) and its tiles
    max(1, ceil(quads / COMPACT_TILE_QUADS)) (an empty shard keeps one
    tile: K10 writes its block there), numbered shard after shard. Per
    shard (first tile, tiles), and the launch's tiles."""
    if len(widths) > COMPACT_MAX_SHARDS:
        raise ValueError(f"K10 and K11 take at most {COMPACT_MAX_SHARDS} "
                         f"shards a card, got {len(widths)}")
    rows, n_tiles = [], 0
    for n, head in zip(widths, heads):
        quads = -(-(head + n) // 4)
        tiles = max(1, -(-quads // COMPACT_TILE_QUADS))
        rows.append((n_tiles, tiles))
        n_tiles += tiles
    return tuple(rows), n_tiles


def _heads(words: list) -> tuple:
    """Each shard's first word's place in its 16-byte quad."""
    return tuple(part.data_ptr() % 16 // 4 for part in words)


def compact_table(words: list, blocks: list, offsets: list,
                  rows: tuple) -> ctypes.Array:
    """The shard table of K10 (blocks: each shard's output [1 + 2 cap]) or
    K11 (blocks None), passed to the kernel by value: int64
    [n_shards, 6], per shard its words' address, its block's address (0
    for K11), width, offset (0 for K11) and its compact_layout row."""
    table = (ctypes.c_longlong * (6 * len(rows)))()
    for i, (part, row) in enumerate(zip(words, rows)):
        out = 0 if blocks is None else blocks[i].data_ptr()
        offset = 0 if offsets is None else offsets[i]
        table[6 * i:6 * i + 6] = (part.data_ptr(), out, part.shape[0],
                                  offset, *row)
    return table


def _check_compact(words: list, offsets: list, cap: int) -> list:
    """K10's shards: int32 words [n_d] each, an offset each that keeps the
    global indices inside int32, a cap >= 0; returns the devices."""
    devices = _shard_devices(words, offsets)
    for part, offset in zip(words, offsets):
        _check("words", part, part.device, (None,))
        if offset < 0 or offset + part.shape[0] > 2**31 - 1:
            raise ValueError(f"global words [{offset}, "
                             f"{offset + part.shape[0]}) outside int32")
    if cap < 0:
        raise ValueError(f"cap {cap} < 0")
    return devices


def compact_nonzero_sharded(words: list, offsets: list, cap: int) -> list:
    """Every word shard's non-zero words as one int32 block [1 + 2 cap]
    (shard d's words [n_d] on its device, its word 0 the global word
    offsets[d]): the count of non-zero words, not capped; the global
    indices of the first `cap` of them, ascending; their words; slots past
    the count hold index offsets[d] and the shard's word 0 (0 for an empty
    shard). Returns one int32 tensor [k, 1 + 2 cap] per distinct device of
    the shards, in first-seen order, its rows the blocks of that device's
    shards in shard order. On the cards K10 runs once per card over all of
    its shards, on that card's current stream, queued behind the work that
    wrote the words: nothing waits for the card."""
    devices = _check_compact(words, offsets, cap)
    if devices[0].type == "cpu":
        return compact_nonzero_sharded_plain(words, offsets, cap)
    if devices[0].type != "cuda":
        raise ValueError(f"compact_nonzero_sharded: no kernel for device "
                         f"{devices[0]}")
    return _compact_cards(words, offsets, cap, devices)


def compact_nonzero(words: torch.Tensor, cap: int,
                    offset: int = 0) -> torch.Tensor:
    """compact_nonzero_sharded for one shard: its block [1 + 2 cap]."""
    return compact_nonzero_sharded([words], [offset], cap)[0][0]


# per (card, stream): K10's scratch [clean, spare, entries of the spare
# that the last launch dirtied]
_k10_scratch: dict = {}
_k10_lock = threading.Lock()


def _compact_cards(words, offsets, cap, devices) -> list:
    """K10 once per distinct card over all of its shards; the scratch the
    launch uses arrives zeroed and it zeroes the other for the next."""
    lib = load_library()
    out = []
    for card, ds in _card_members(devices).items():
        shard_words = [words[d] for d in ds]
        rows, n_tiles = compact_layout(
            tuple(part.shape[0] for part in shard_words), _heads(shard_words))
        blocks = torch.empty((len(ds), 1 + 2 * cap), dtype=torch.int32,
                             device=card)
        table = compact_table(shard_words, blocks, [offsets[d] for d in ds],
                              rows)
        stream = torch.cuda.current_stream(card)
        with torch.cuda.device(card), _k10_lock:
            # the lock keeps the launches in the order they take the scratch
            key = (card, stream.cuda_stream)
            state = _k10_scratch.get(key)
            if state is None or state[0].shape[0] < 1 + n_tiles:
                size = max(_K10_MIN_SCRATCH, 1 << n_tiles.bit_length())
                state = [torch.zeros(size, dtype=torch.int64, device=card),
                         torch.zeros(size, dtype=torch.int64, device=card),
                         0]
            clean, spare, dirty = state
            err = lib.lapis_compact_nonzero(
                table, len(ds), n_tiles, cap, clean.data_ptr(),
                spare.data_ptr() if dirty else None, dirty,
                stream.cuda_stream)
            _raise_on(err, "compact_nonzero")
            _k10_scratch[key] = [spare, clean, 1 + n_tiles]
        COMPACT_NONZERO.add()
        out.append(blocks)
    return out


def compact_nonzero_plain(words: torch.Tensor, cap: int,
                          offset: int = 0) -> torch.Tensor:
    """The plain PyTorch version of compact_nonzero (ops/reductions.py)."""
    COMPACT_NONZERO.add(plain=True)
    return reductions.compact_nonzero(words, cap, offset)


def compact_nonzero_sharded_plain(words: list, offsets: list,
                                  cap: int) -> list:
    """The plain PyTorch version of compact_nonzero_sharded:
    compact_nonzero_plain per shard, stacked per device."""
    devices = _check_compact(words, offsets, cap)
    return [torch.stack([compact_nonzero_plain(words[d], cap, offsets[d])
                         for d in ds])
            for ds in _card_members(devices).values()]


def popcount_words_sharded(words: list) -> torch.Tensor:
    """The total population count of every word shard's int32 words (each
    on its device): a 0-d int64 on the first shard's device. On the cards
    K11 runs once per card over all of its shards, on that card's current
    stream, and the cards' totals are added on the first shard's device."""
    devices = _shard_devices(words)
    for part in words:
        _check("words", part, part.device, (None,))
    if devices[0].type == "cpu":
        return popcount_words_sharded_plain(words)
    if devices[0].type != "cuda":
        raise ValueError(f"popcount_words_sharded: no kernel for device "
                         f"{devices[0]}")
    return _popcount_cards(words, devices)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """popcount_words_sharded for one shard."""
    return popcount_words_sharded([words])


# per (card, stream): the int64 total the last K11 launch on that stream
# zeroed for the next
_k11_spares: dict = {}


def _popcount_cards(words, devices) -> torch.Tensor:
    """K11 once per distinct card over all of its shards into a total that
    the launch before zeroed; the totals then added on devices[0]."""
    lib = load_library()
    totals = []
    for card, ds in _card_members(devices).items():
        shard_words = [words[d] for d in ds]
        rows, n_tiles = compact_layout(
            tuple(part.shape[0] for part in shard_words), _heads(shard_words))
        table = compact_table(shard_words, None, None, rows)
        stream = torch.cuda.current_stream(card)
        with torch.cuda.device(card), _k10_lock:
            key = (card, stream.cuda_stream)
            total = _k11_spares.pop(key, None)
            if total is None:
                total = torch.zeros((), dtype=torch.int64, device=card)
            spare = torch.empty((), dtype=torch.int64, device=card)
            err = lib.lapis_popcount_words(table, len(ds), n_tiles,
                                           total.data_ptr(), spare.data_ptr(),
                                           stream.cuda_stream)
            _raise_on(err, "popcount_words")
            _k11_spares[key] = spare
        POPCOUNT_WORDS.add()
        totals.append(total)
    return reduce_sum(totals, devices[0])


def popcount_words_plain(words: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of popcount_words (ops/reductions.py)."""
    POPCOUNT_WORDS.add(plain=True)
    return reductions.popcount_words(words)


def popcount_words_sharded_plain(words: list) -> torch.Tensor:
    """The plain PyTorch version of popcount_words_sharded:
    popcount_words_plain per shard and the same sum."""
    devices = _shard_devices(words)
    return reduce_sum([popcount_words_plain(part) for part in words],
                      devices[0])
