"""Line-profile accumulation onto the spectral grid (Kernel 1).

alpha_line[b, D, N] = sum over lines l of alpha[b, l, d] * phi(nu_p - nu_l),
for each model b of a batch, each (line, depth) restricted to its window
-floor(w) <= p - center_l < floor(w) around the line's center pixel: the
reference's adaptive window, or the accuracy-controlled one.

This is the sum that ``stardis_tpu/opacities/line_kernel.py`` computes on
TPU schedules (tiers, panels, split passes, 128-lane rounding) and that
``stardis_tpu/parallel/batch.py`` vmaps over models; the port keeps its
semantics and none of its schedule.  ``accumulate_line_windows``
dispatches on the device of its tensors: on the CPU it runs the plain torch
version, on a CUDA device the hand-written kernel of csrc/line_opacity.cu,
which takes every model of a batch in one launch.
Both read one integer half-window array computed here, so an FMA-contracted
or reordered window formula cannot flip a window-edge pixel between them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _cuda
from .voigt import (
    PI,
    SQRT_PI,
    faddeeva_real,
    faddeeva_real_region1,
)

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


def accumulate_line_windows(grid, line_nu, centers, alpha, gamma, doppler, iw):
    """alpha_line_at_nu = sum over lines of alpha * phi(nu - nu_line)
    within each (line, depth) window: the plain version on the CPU, Kernel 1
    on a CUDA device.

    grid : [N] descending grid, minus a reference frequency
    line_nu : [L] line frequencies minus the same reference
    centers : [L] center pixels (line_center_indices)
    alpha, gamma, doppler : [B, L, D] for B models, or [L, D]
    iw : integer half-windows, shaped as alpha (window_half_widths)
    returns [B, D, N], or [D, N]
    """
    if grid.device.type == "cuda":
        return accumulate_line_opacity_cuda(grid, line_nu, centers, alpha, gamma,
                                            doppler, iw)
    if grid.device.type == "cpu":
        return accumulate_line_opacity_plain(grid, line_nu, centers, alpha, gamma,
                                             doppler, iw)
    raise ValueError(f"no line-opacity path for device {grid.device}")


def accumulate_line_opacity_plain(grid, line_nu, centers, alpha, gamma,
                                  doppler, iw, budget=None):
    """Plain torch version (shapes as accumulate_line_windows): models one
    after another, each a loop over chunks of lines.  Each chunk masks the
    pixel span its windows can reach ([C, D, span] <= ``budget``
    elements), evaluates the Voigt profile on the in-window pairs and sums
    them per (depth, pixel)."""
    if alpha.ndim == 3:
        return torch.stack([
            accumulate_line_opacity_plain(grid, line_nu, centers, alpha[b], gamma[b],
                                          doppler[b], iw[b], budget)
            for b in range(alpha.shape[0])
        ])
    n_nu = grid.shape[0]
    n_lines, n_depth = alpha.shape
    out = torch.zeros((n_depth, n_nu), dtype=alpha.dtype, device=alpha.device)
    if n_lines == 0:
        return out
    if budget is None:
        budget = 1 << 24 if alpha.is_cuda else 1 << 20
    centers = centers.to(device=alpha.device, dtype=torch.int64)
    reach = iw.amax(dim=1).to(torch.int64)
    lo = torch.clamp(centers - reach, 0, n_nu).cpu().numpy()
    hi = torch.clamp(centers + reach, 0, n_nu).cpu().numpy()
    pix_all = torch.arange(n_nu, device=alpha.device)

    start = 0
    while start < n_lines:
        count = min(n_lines - start, 4096)
        while True:
            p0 = int(lo[start:start + count].min())
            p1 = int(hi[start:start + count].max())
            if count == 1 or count * n_depth * (p1 - p0) <= budget:
                break
            count = max(1, count // 2)
        sl = slice(start, start + count)
        start += count
        if p1 <= p0:
            continue
        pix = pix_all[p0:p1]
        off = pix[None, :] - centers[sl, None]  # [C, S]
        dnu = grid[p0:p1][None, :] - line_nu[sl, None]  # [C, S]
        half = iw[sl].to(torch.int64)[:, :, None]  # [C, D, 1]
        within = (off[:, None, :] >= -half) & (off[:, None, :] < half)
        li, di, pi = within.nonzero(as_tuple=True)
        phi = _voigt_in_window(
            dnu[li, pi], doppler[sl][li, di], gamma[sl][li, di]
        )
        block = torch.zeros((n_depth, p1 - p0), dtype=out.dtype, device=out.device)
        block.index_put_((di, pi), phi * alpha[sl][li, di], accumulate=True)
        out[:, p0:p1] += block
    return out


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


_LINE_ARGS = (
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
)


def accumulate_line_opacity_cuda(grid, line_nu, centers, alpha, gamma,
                                 doppler, iw):
    """Kernel 1 (csrc/line_opacity.cu) on CUDA tensors, all models in one
    launch (shapes as accumulate_line_windows); raises on anything the
    kernel does not take.  Lines must be sorted so that ``centers`` is
    non-increasing (lines ascending in nu on a descending grid)."""
    single = alpha.ndim == 2
    if single:
        alpha, gamma, doppler, iw = alpha[None], gamma[None], doppler[None], iw[None]
    n_nu = grid.shape[0]
    n_models, n_lines, n_depth = alpha.shape
    dtype = alpha.dtype
    tensors = (grid, line_nu, alpha, gamma, doppler)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"line_opacity kernel takes float32/float64, not {dtype}")
    if any(t.dtype != dtype for t in tensors):
        raise TypeError("line_opacity kernel: mixed dtypes")
    if any(not t.is_cuda or t.device != grid.device for t in (*tensors, centers, iw)):
        raise ValueError("line_opacity kernel: all tensors must be on one CUDA device")
    if grid.ndim != 1 or line_nu.shape != (n_lines,) or centers.shape != (n_lines,):
        raise ValueError("line_opacity kernel: grid must be [N], line_nu/centers [L]")
    if any(t.shape != alpha.shape for t in (gamma, doppler, iw)):
        raise ValueError("line_opacity kernel: alpha/gamma/doppler/iw must be [B, L, D]")
    if n_lines == 0:
        out = torch.zeros((n_models, n_depth, n_nu), dtype=dtype, device=grid.device)
        return out[0] if single else out
    centers = centers.to(torch.int32).contiguous()
    if n_lines > 1 and not bool((centers[1:] <= centers[:-1]).all()):
        raise ValueError(
            "line_opacity kernel: lines must be sorted by frequency "
            "(non-increasing center pixels)"
        )
    grid = grid.contiguous()
    line_nu = line_nu.contiguous()
    # depth-major [B, D, L] so a block's line chunk loads are coalesced
    alpha_t = alpha.transpose(1, 2).contiguous()
    gamma_t = gamma.transpose(1, 2).contiguous()
    doppler_t = doppler.transpose(1, 2).contiguous()
    iw_t = iw.to(torch.int32).transpose(1, 2).contiguous()
    iw_max = iw_t.amax(dim=2).contiguous()  # [B, D]
    out = torch.empty((n_models, n_depth, n_nu), dtype=dtype, device=grid.device)
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = _cuda.bind("line_opacity", f"line_opacity_{suffix}", _LINE_ARGS)
    p = _cuda.ptr
    status = fn(
        p(grid), p(line_nu), p(centers), p(alpha_t), p(gamma_t), p(doppler_t),
        p(iw_t), p(iw_max), p(out), n_models, n_lines, n_depth, n_nu,
        _cuda.stream_ptr(grid.device),
    )
    accumulate_line_opacity_cuda.launches += 1
    _cuda.check("line_opacity", status)
    return out[0] if single else out


accumulate_line_opacity_cuda.launches = 0
