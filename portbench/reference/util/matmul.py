# Frozen copy of stardis_tpu_torch/util/matmul.py at commit 9c7d618,
# trimmed to what the benchmark reaches: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""Matrix products in full float32 on the card.

A float32 product on CUDA runs in TF32 (about three decimal digits) when
``torch.backends.cuda.matmul.allow_tf32`` is set, a process-wide switch
that the caller owns.  The bound-free (D, K) x (K, N) product goes through
``full_float32_matmul``: the switch is off while it runs, and comes back as
it was afterwards.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def full_float32():
    """Matrix products in full float32, not TF32, inside the block only:
    the previous setting comes back afterwards."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def full_float32_matmul(a, b):
    """``a @ b`` ([M, K] x [K, N] or [K]) in full float32, whatever the
    process-wide TF32 switch says."""
    if a.ndim != 2 or b.ndim not in (1, 2):
        raise ValueError(f"full_float32_matmul: [M, K] x [K, N] or [K], not {a.shape} x "
                         f"{b.shape}")
    with full_float32():
        return a @ b
