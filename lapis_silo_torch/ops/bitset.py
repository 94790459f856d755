"""Packed-u32 bitset helpers (host/numpy side).

Convention (used identically on device): a set of row ids in [0, N) is a
vector of W = ceil(N/32) uint32 words; bit ``i`` of word ``w`` is row
``w*32 + i`` (little bit order). This layout is what ``np.packbits(...,
bitorder='little')`` produces and maps 1:1 onto the device bitplane tensors.
"""

from __future__ import annotations

import numpy as np


def words_for(n_rows: int) -> int:
    return (n_rows + 31) // 32


def pack_bool(mask: np.ndarray, n_words: int | None = None) -> np.ndarray:
    """bool[N] (or last-axis N) -> uint32[..., W]."""
    n = mask.shape[-1]
    w = n_words if n_words is not None else words_for(n)
    packed = np.packbits(mask.astype(bool), axis=-1, bitorder="little")
    # pad byte axis to 4*w bytes
    pad = 4 * w - packed.shape[-1]
    if pad:
        packed = np.concatenate(
            [packed, np.zeros(packed.shape[:-1] + (pad,), dtype=np.uint8)], axis=-1
        )
    return packed.view(np.uint32)


def unpack_words(words: np.ndarray, n_rows: int) -> np.ndarray:
    """uint32[..., W] -> bool[..., n_rows]."""
    as_bytes = words.view(np.uint8)
    bits = np.unpackbits(as_bytes, axis=-1, bitorder="little")
    return bits[..., :n_rows].astype(bool)


def pack_ids(row_ids: np.ndarray, n_rows: int) -> np.ndarray:
    """sorted-or-not row id array -> uint32[W] bitset."""
    mask = np.zeros(n_rows, dtype=bool)
    mask[row_ids] = True
    return pack_bool(mask)


def to_ids(words: np.ndarray, n_rows: int) -> np.ndarray:
    """uint32[W] -> ascending row id array."""
    return np.nonzero(unpack_words(words, n_rows))[0].astype(np.uint32)


def popcount(words: np.ndarray) -> int:
    return int(np.bitwise_count(words).sum())


def full_mask(n_rows: int) -> np.ndarray:
    """All rows set; tail bits beyond n_rows are zero (the invariant every
    engine op must maintain so popcounts stay exact)."""
    w = words_for(n_rows)
    out = np.full(w, 0xFFFFFFFF, dtype=np.uint32)
    tail = n_rows % 32
    if tail:
        out[-1] = np.uint32((1 << tail) - 1)
    if n_rows == 0:
        out[:] = 0
    return out


def empty_mask(n_rows: int) -> np.ndarray:
    return np.zeros(words_for(n_rows), dtype=np.uint32)
