# Frozen copy of stardis_tpu_torch/opacities/line_kernel.py at commit 9c7d618, cut to its plain
# torch path (no kernel): part of the benchmark's reference.  Keep it as it is.
"""The windows and the in-window Voigt profile of the line sum (Kernel 1's
plain arithmetic): a frozen cut of the program's line_kernel.py."""

from __future__ import annotations

import numpy as np
import torch

from .voigt import PI, SQRT_PI, faddeeva_real, faddeeva_real_region1

MIN_WINDOW_PIXELS = 10
WINDOW_SCALE = 20.0


def grid_min_step(tracing_nus_desc):
    """Smallest frequency step of the (descending) grid; +inf for a
    single-point grid, so the adaptive window collapses to the minimum."""
    grid = np.asarray(tracing_nus_desc)
    if grid.size < 2:
        return float("inf")
    return float(-np.max(np.diff(grid)))


def line_center_indices(tracing_nus_desc, line_nus):
    """Index of the grid point closest-from-above to each line center in the
    descending grid."""
    grid = np.asarray(tracing_nus_desc)
    reversed_grid = grid[::-1]
    return (len(grid) - np.searchsorted(reversed_grid, np.asarray(line_nus))).astype(
        np.int64
    )


def window_pixels(alpha, gamma, doppler, d_nu):
    """Adaptive per-(line, depth) half-window in spectral pixels."""
    win = (gamma + doppler) * alpha / d_nu * WINDOW_SCALE
    return torch.clamp(win, min=float(MIN_WINDOW_PIXELS))


def window_pixels_accuracy(alpha, gamma, doppler, d_nu, epsilon=1e-12):
    """Accuracy-controlled half-window in pixels: the profile is cut where
    its extinction alpha * phi drops below ``epsilon`` [1/cm] (a scalar or
    a tensor broadcast against the [..., L, D] line arrays).

    Lorentzian far wing  dnu = sqrt(alpha gamma / (pi^2 eps));
    Gaussian core        dnu = doppler sqrt(max(0, ln(alpha / (sqrt(pi) doppler eps))));
    floor                4 (gamma + doppler), and at least MIN_WINDOW_PIXELS.
    """
    lorentz = torch.sqrt(alpha * gamma / (PI**2 * epsilon))
    core = torch.log(alpha / (SQRT_PI * doppler * epsilon))
    gauss = doppler * torch.sqrt(torch.clamp(core, min=0.0))
    floor = 4.0 * (gamma + doppler)
    dnu_cut = torch.maximum(torch.maximum(lorentz, gauss), floor)
    return torch.clamp(dnu_cut / d_nu, min=float(MIN_WINDOW_PIXELS))


def window_half_widths(alpha, gamma, doppler, d_nu, n_nu, window_mode="reference",
                       epsilon=None):
    """floor of the half-window as int32 [..., L, D], clamped at n_nu + 1
    (every pixel offset lies in [-n_nu, n_nu - 1], so the clamp keeps the
    mask).

    window_mode : "reference" (window_pixels) or "accuracy"
        (window_pixels_accuracy), which needs ``epsilon``: the absolute
        threshold per depth, [..., D] with the line arrays' leading axes
        (``pipeline.accuracy_epsilon``).
    """
    if window_mode == "accuracy":
        if epsilon is None:
            raise ValueError("accuracy window mode needs the per-depth epsilon")
        eps = epsilon.unsqueeze(-2) if torch.is_tensor(epsilon) else epsilon
        win = window_pixels_accuracy(alpha, gamma, doppler, d_nu, epsilon=eps)
    elif window_mode == "reference":
        win = window_pixels(alpha, gamma, doppler, d_nu)
    else:
        raise ValueError(f"unknown window_mode {window_mode!r}")
    return torch.clamp(torch.floor(win), max=float(n_nu + 1)).to(torch.int32)



def _voigt_in_window(delta_nu, doppler_width, gamma):
    """voigt_profile on the in-window pairs only: the region-I formula
    everywhere, the full w4 chain where |x| + y <= 15 — the same formula
    the branchless evaluation selects, at a fraction of its cost."""
    x = delta_nu / doppler_width
    y = gamma / (SQRT_PI * PI) / doppler_width
    w = faddeeva_real_region1(x, y)
    core = torch.abs(x) + y <= 15.0
    w[core] = faddeeva_real(x[core], y[core])
    return w / (SQRT_PI * doppler_width)


