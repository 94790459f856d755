"""The port's hand-written CUDA kernels: build, bind, wrap, count.

Two kernels carry the count and Mutations path, each in ``csrc/``:

- ``vm_run`` (``csrc/vm_run.cu``): the filter VM, replacing
  ``lapis_silo_tpu/ops/pallas_kernels.py:526`` ``vm_run``;
- ``mutation_counts`` (``csrc/mutation_counts.cu``): popcount(row & filter)
  per bank row, replacing ``pallas_kernels.py:150``
  ``mutation_counts_banked`` (naive form).

At first use the sources are compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``build/torch_kernels/`` of
the checkout, named by a hash of the sources and flags, and loaded with
``ctypes``. A build or load that fails raises ``RuntimeError``.

Each wrapper checks device, dtype, shape and contiguity, launches on the
current stream and adds one to its kernel's ``launches``. For tensors on the
CPU it runs the plain PyTorch version instead, which adds one to
``plain_launches``; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from . import reductions
from .vm import (
    B_BANK, B_DYN, B_FULL, B_REG, B_SPARSE, EMIT_COUNT, M_AND, M_MOVB, M_OR,
    M_XOR, MAX_BATCH_QUERIES, MAX_REGS, WIRE_BSRC_SHIFT, WIRE_DST_MASK,
    WIRE_MODE_SHIFT, WIRE_OP_SHIFT, WIRE_RA_SHIFT, WIRE_RB_SHIFT,
)
from .words import popcount

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
KERNELS = (VM_RUN, MUTATION_COUNTS)


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
    "lapis_vm_run": [_P, _P, _I32, _P, _I64, _P, _I64, _P, _I64, _P, _I64,
                     _I32, _P, _P, _P],
    "lapis_mutation_counts": [_P, _P, _I64, _I64, _I64, _P, _P],
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
    """Where the kernels' shared library for the current sources lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for source in sorted(CSRC_DIR.glob("*.cu")):
        digest.update(source.name.encode())
        digest.update(source.read_bytes())
    return BUILD_DIR / f"liblapis_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    The compiler's resource report (-Xptxas -v) lands beside it as .log."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC_DIR.glob("*.cu")))]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    except (OSError, subprocess.TimeoutExpired) as ex:
        raise RuntimeError(f"kernel build failed to run: {ex}") from ex
    if done.returncode != 0:
        raise RuntimeError(f"kernel build failed ({done.returncode}):\n"
                           f"{done.stderr}")
    target.with_suffix(".log").write_text(done.stderr)
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

def vm_run(code: torch.Tensor, n_instr: int, bank: torch.Tensor,
           dyn: torch.Tensor, sparse_rows: torch.Tensor, full: torch.Tensor,
           n_regs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the first `n_instr` instructions of a wire-format program
    (code [2, L] int32: operands, packed words) over the flat word axis.
    bank [R, PW], dyn [D, PW], sparse_rows [K, PW] and full [PW] hold u32
    words as int32. Returns (reg[0] words [PW], EMIT counts [4096]), both
    int32 on the inputs' device."""
    device = full.device
    pw = full.shape[0] if full.dim() == 1 else -1
    _check("full", full, device, (None,))
    _check("code", code, device, (2, None))
    _check("bank", bank, device, (None, pw))
    _check("dyn", dyn, device, (None, pw))
    _check("sparse_rows", sparse_rows, device, (None, pw))
    if not 0 <= n_instr <= code.shape[1]:
        raise ValueError(f"n_instr {n_instr} outside [0, {code.shape[1]}]")
    if not 1 <= n_regs <= MAX_REGS:
        raise ValueError(f"n_regs {n_regs} outside [1, {MAX_REGS}]")
    if min(bank.shape[0], dyn.shape[0], sparse_rows.shape[0]) < 1:
        raise ValueError("bank, dyn and sparse_rows need one row at least")
    if device.type == "cpu":
        return vm_run_plain(code, n_instr, bank, dyn, sparse_rows, full, n_regs)
    if device.type != "cuda":
        raise ValueError(f"vm_run: no kernel for device {device}")
    lib = load_library()
    words = torch.empty(pw, dtype=torch.int32, device=device)
    counts = torch.zeros(MAX_BATCH_QUERIES, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.lapis_vm_run(
            code.data_ptr(), code[1].data_ptr(), n_instr,
            bank.data_ptr(), bank.shape[0], dyn.data_ptr(), dyn.shape[0],
            sparse_rows.data_ptr(), sparse_rows.shape[0], full.data_ptr(), pw,
            n_regs, words.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "vm_run")
    VM_RUN.add()
    return words, counts


def vm_run_plain(code: torch.Tensor, n_instr: int, bank: torch.Tensor,
                 dyn: torch.Tensor, sparse_rows: torch.Tensor,
                 full: torch.Tensor, n_regs: int):
    """The plain PyTorch version of vm_run: one Python step per instruction,
    with the clamping and EMIT semantics of the XLA interpreter
    (lapis_silo_tpu/ops/vm.py:625-710), described in csrc/vm_run.cu."""
    VM_RUN.add(plain=True)
    pw = full.shape[0]
    regs = torch.zeros((n_regs + 1, pw), dtype=torch.int32, device=full.device)
    counts = torch.zeros(MAX_BATCH_QUERIES, dtype=torch.int32,
                         device=full.device)
    rows = {B_BANK: bank, B_DYN: dyn, B_SPARSE: sparse_rows}
    operands = code[0, :n_instr].tolist()
    specs = code[1, :n_instr].tolist()
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
    return regs[0].clone(), counts


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
