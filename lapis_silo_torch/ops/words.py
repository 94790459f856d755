"""Packed-word helpers for torch tensors.

The bitset layout is the reference's (``lapis_silo_tpu/ops/bitset.py``): bit
``i`` of word ``w`` is row ``w*32 + i``. Torch has no popcount and no logical
right shift on signed integers, and its uint32 type lacks shifts on the CPU,
so the port holds u32 words as int32 tensors (a ``view`` of the numpy
uint32 data, no copy) and widens to int64 wherever it shifts.
"""

from __future__ import annotations

import numpy as np
import torch


def to_device(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor of the same bits on `device`."""
    words = np.ascontiguousarray(words)
    if not words.flags.writeable:  # e.g. a view of another framework's array
        words = words.copy()
    return torch.from_numpy(words.view(np.int32)).to(device)


def to_host(words: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy words (a host copy)."""
    return words.detach().to("cpu", copy=True).numpy().view(np.uint32)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count (int64, same shape) of int32-held u32
    words: SWAR over the zero-extended value, so no shift is arithmetic and
    no product wraps (the widest product, 0x0F0F0F0F * 0x01010101, is
    below 2**60)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF
