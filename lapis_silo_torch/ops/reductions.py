"""Plain reductions over device-resident words.

Counterparts of ``_popcount_words_jit`` and ``_mutation_counts_jit`` in
``lapis_silo_tpu/ops/reductions.py``. ``popcount_words`` runs as plain tensor
ops on every device (the reference left it to XLA, too).
``mutation_counts`` is the plain version of the Mutations kernel
(``csrc/mutation_counts.cu``): ``ops/kernels.py`` calls it for tensors on the
CPU, and the tests and ``chip_smoke.py`` hold the kernel against it.
"""

from __future__ import annotations

import torch

from .words import popcount

# words per slice of the plain Mutations reduction: bounds its int64
# temporaries to a few hundred MB whatever the bank's size
_SLICE_WORDS = 1 << 24


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Total population count of a word tensor (0-d int64, on its device)."""
    return popcount(words).sum()


def mutation_counts(bank: torch.Tensor, filters: torch.Tensor, start: int,
                    n_seg_rows: int) -> torch.Tensor:
    """counts[r] = sum_w popcount(bank[start + r, w] & filters[w]) over the
    flat global word axis (partitions folded into words): int32[n_seg_rows]."""
    step = max(1, _SLICE_WORDS // max(bank.shape[1], 1))
    out = torch.empty(n_seg_rows, dtype=torch.int32, device=bank.device)
    for lo in range(0, n_seg_rows, step):
        hi = min(lo + step, n_seg_rows)
        rows = bank[start + lo : start + hi]
        out[lo:hi] = popcount(rows & filters[None, :]).sum(dim=1).to(torch.int32)
    return out
