"""Matrix products in full float32 on the card, forward and backward.

A float32 product on CUDA runs in TF32 (about three decimal digits) when
``torch.backends.cuda.matmul.allow_tf32`` is set, a process-wide switch
that the caller owns.  The products the JAX package leaves to XLA in full
precision (the bound-free (D, K) x (K, N) product, the broadening's
windows x kernel) go through ``full_float32_matmul``: the switch is off
while its forward runs and while its backward runs, and comes back as it
was after each, so a gradient's products round as the forward's do.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

#: the switch is one for the whole process: the host threads of a mesh over
#: several cards take these blocks one at a time, so that no product runs
#: after another thread has put the switch back, and the caller's setting
#: is what comes back
_SWITCH = threading.RLock()


@contextmanager
def full_float32():
    """Matrix products in full float32, not TF32, inside the block only:
    the previous setting comes back afterwards."""
    with _SWITCH:
        previous = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = previous


class _Float32Matmul(torch.autograd.Function):
    """``a @ b`` for a 2-D ``a`` and a 2-D or 1-D ``b``, the forward and the
    backward's products inside ``full_float32``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with full_float32():
            return a @ b

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g_a = g_b = None
        with full_float32():
            if ctx.needs_input_grad[0]:
                g_a = torch.outer(grad, b) if b.ndim == 1 else grad @ b.T
            if ctx.needs_input_grad[1]:
                g_b = a.T @ grad
        return g_a, g_b


def full_float32_matmul(a, b):
    """``a @ b`` ([M, K] x [K, N] or [K]) in full float32, its gradient
    too, whatever the process-wide TF32 switch says."""
    if a.ndim != 2 or b.ndim not in (1, 2):
        raise ValueError(f"full_float32_matmul: [M, K] x [K, N] or [K], not {a.shape} x "
                         f"{b.shape}")
    return _Float32Matmul.apply(a, b)
