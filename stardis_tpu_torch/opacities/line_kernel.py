"""Line-profile accumulation onto the spectral grid (Kernel 1).

alpha_line[b, D, N] = sum over lines l of alpha[b, l, d] * phi(nu_p - nu_l),
for each model b of a batch, each (line, depth) restricted to its window
-floor(w) <= p - center_l < floor(w) around the line's center pixel: the
reference's adaptive window, or the accuracy-controlled one.

This is the sum that ``stardis_tpu/opacities/line_kernel.py`` computes on
TPU schedules (tiers, panels, split passes, 128-lane rounding) and that
``stardis_tpu/parallel/batch.py`` vmaps over models; the port keeps its
semantics and none of its schedule.  ``line_opacity_range`` dispatches on
the device of its tensors: on the CPU it runs the plain torch version, on a
CUDA device the hand-written kernel of csrc/line_opacity.cu, which takes
every model of a batch in one launch.
Both read one integer half-window array computed here, so an FMA-contracted
or reordered window formula cannot flip a window-edge pixel between them.

Every evaluation covers a pixel range [p_begin, p_begin + n_out) of the
global grid (default the whole grid): the counterpart of
``accumulate_pairs_blocked`` (line_kernel.py:1316), the per-segment program
of ``parallel.sharding.segmented_spectrum``.  The grid, the centres and the
windows stay global, so a range holds exactly the columns of the full sum.
The one entry point is ``prepare_line_opacity`` (the checks and the
kernel's layout, once per line set) followed by ``line_opacity_range``
(one launch per range), so the K ranges of a segmented run share one
layout.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _cuda
from .voigt import (
    PI,
    SQRT_PI,
    faddeeva_real,
    faddeeva_real_grad,
    faddeeva_real_region1,
    faddeeva_real_region1_grad_euler,
    faddeeva_real_region2_euler,
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


@dataclasses.dataclass
class LineOpacityInputs:
    """One line set's inputs to Kernel 1 or its plain version, checked and
    laid out once (``prepare_line_opacity``) for any number of ranges."""

    grid: torch.Tensor  # [N] global grid
    line_nu: torch.Tensor  # [L]
    centers: torch.Tensor  # [L]
    alpha: torch.Tensor  # [B, L, D]; [B, D, L] on a CUDA device
    gamma: torch.Tensor
    doppler: torch.Tensor
    iw: torch.Tensor  # int32, laid out as alpha
    iw_max: torch.Tensor | None  # [B, D] on a CUDA device, else None
    step_min: float | None  # the grid's smallest step on a CUDA device, else None
    single: bool  # the caller passed one model without the B axis


def prepare_line_opacity(grid, line_nu, centers, alpha, gamma, doppler, iw,
                         plain=False):
    """Checks and layout of one line set for ``line_opacity_range``.

    grid : [N] descending grid, minus a reference frequency
    line_nu : [L] line frequencies minus the same reference
    centers : [L] center pixels (line_center_indices)
    alpha, gamma, doppler : [B, L, D] for B models, or [L, D]
    iw : integer half-windows, shaped as alpha (window_half_widths)

    On a CUDA device: dtypes, device and shapes, the sort order the
    kernel's line search needs, the depth-major [B, D, L] copies, the
    per-depth widest window and the grid's smallest step; on the CPU, or
    with ``plain``, the inputs as they are, for the plain version."""
    single = alpha.ndim == 2
    if single:
        alpha, gamma, doppler, iw = alpha[None], gamma[None], doppler[None], iw[None]
    if plain or grid.device.type == "cpu":
        return LineOpacityInputs(grid, line_nu, centers, alpha, gamma, doppler, iw,
                                 None, None, single)
    if grid.device.type != "cuda":
        raise ValueError(f"no line-opacity path for device {grid.device}")
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
    centers = centers.to(torch.int32).contiguous()
    if n_lines > 1 and not bool((centers[1:] <= centers[:-1]).all()):
        raise ValueError(
            "line_opacity kernel: lines must be sorted by frequency "
            "(non-increasing center pixels)"
        )
    # depth-major [B, D, L] so a block's line chunk loads are coalesced
    iw_t = iw.to(torch.int32).transpose(1, 2).contiguous()
    iw_max = iw_t.amax(dim=2) if n_lines else iw_t.new_zeros((n_models, n_depth))
    # bounds, in the kernel, the pixels around a line centre that can lie in
    # the Voigt core (its core_guard)
    step_min = float((grid[:-1] - grid[1:]).amin()) if grid.shape[0] > 1 else float("inf")
    if not step_min > 0:
        raise ValueError("line_opacity kernel: the grid must descend strictly")
    return LineOpacityInputs(
        grid.contiguous(), line_nu.contiguous(), centers,
        alpha.transpose(1, 2).contiguous(), gamma.transpose(1, 2).contiguous(),
        doppler.transpose(1, 2).contiguous(), iw_t, iw_max.contiguous(), step_min, single,
    )


def line_opacity_range(prepared, p_begin=0, n_out=None):
    """The sum over pixels [p_begin, p_begin + n_out) of the global grid
    (default all of it) from ``prepare_line_opacity``'s inputs: Kernel 1 on
    a CUDA device, the plain version on the CPU.  Returns [B, D, n_out],
    or [D, n_out] for a single model.

    Differentiable in alpha, gamma and doppler: the backward is Kernel 1b
    (csrc/line_opacity_grad.cu) on a CUDA device and
    ``accumulate_line_opacity_plain_backward`` on the CPU, over the same
    pixel range.  The grid, the centres and the integer windows carry no
    gradient (the windows are piecewise constant, as in the JAX package)."""
    n_nu = prepared.grid.shape[0]
    n_out = n_nu - p_begin if n_out is None else n_out
    if not (0 <= p_begin and n_out >= 0 and p_begin + n_out <= n_nu):
        raise ValueError(f"pixel range [{p_begin}, {p_begin + n_out}) outside [0, {n_nu})")
    q = prepared
    out = _LineOpacity.apply(q.alpha, q.gamma, q.doppler, q, p_begin, n_out)
    return out[0] if q.single else out


class _LineOpacity(torch.autograd.Function):
    """Kernel 1 (or its plain version) forward, Kernel 1b (or its plain
    version) backward, on ``prepare_line_opacity``'s layout."""

    @staticmethod
    def forward(ctx, alpha, gamma, doppler, prepared, p_begin, n_out):
        q = prepared
        ctx.prepared, ctx.p_begin, ctx.n_out = q, p_begin, n_out
        if q.iw_max is None:
            return accumulate_line_opacity_plain(q.grid, q.line_nu, q.centers, alpha, gamma,
                                                 doppler, q.iw, p_begin=p_begin, n_out=n_out)
        return accumulate_line_opacity_cuda(q, p_begin, n_out)

    @staticmethod
    def backward(ctx, grad):
        q, p_begin, n_out = ctx.prepared, ctx.p_begin, ctx.n_out
        if q.iw_max is None:
            grads = accumulate_line_opacity_plain_backward(
                grad, q.grid, q.line_nu, q.centers, q.alpha, q.gamma, q.doppler, q.iw,
                p_begin=p_begin, n_out=n_out)
        else:
            grads = accumulate_line_opacity_grad_cuda(q, grad, p_begin, n_out)
        return (*grads, None, None, None)


def accumulate_line_opacity_plain(grid, line_nu, centers, alpha, gamma,
                                  doppler, iw, budget=None, p_begin=0, n_out=None):
    """Plain torch version (arguments as ``prepare_line_opacity``, range
    as ``line_opacity_range``):
    models one after another, each a loop over chunks of lines.  Each chunk
    masks the pixel span its windows can reach ([C, D, span] <= ``budget``
    elements over the whole grid), evaluates the Voigt profile on the
    in-window pairs of the range and sums them per (depth, pixel).  The
    chunks are cut on the whole grid whatever the range, so a range sums
    each pixel's lines in the same groups and order as the full sum and
    equals its columns exactly."""
    if alpha.ndim == 3:
        return torch.stack([
            accumulate_line_opacity_plain(grid, line_nu, centers, alpha[b], gamma[b],
                                          doppler[b], iw[b], budget, p_begin, n_out)
            for b in range(alpha.shape[0])
        ])
    n_nu = grid.shape[0]
    n_out = n_nu - p_begin if n_out is None else n_out
    n_depth = alpha.shape[1]
    out = torch.zeros((n_depth, n_out), dtype=alpha.dtype, device=alpha.device)
    for sl, p0, p1, li, di, pi, dnu in _window_pairs(grid, line_nu, centers, iw, budget,
                                                     p_begin, p_begin + n_out):
        phi = _voigt_in_window(dnu, doppler[sl][li, di], gamma[sl][li, di])
        block = torch.zeros((n_depth, p1 - p0), dtype=out.dtype, device=out.device)
        block.index_put_((di, pi), phi * alpha[sl][li, di], accumulate=True)
        out[:, p0 - p_begin:p1 - p_begin] += block
    return out


def _window_pairs(grid, line_nu, centers, iw, budget, p_begin, p_end):
    """The plain versions' chunks: lines cut into chunks whose windows'
    pixel span fits ``budget`` ([C, D, span] elements, span over the whole
    grid, so the cut does not depend on the range), and each chunk's
    in-window (line, depth, pixel) pairs inside [p_begin, p_end).  Yields
    (line slice, p0, p1, li, di, pi, dnu): li relative to the slice, pi to
    p0, and dnu = grid[p] - line_nu[l] per pair."""
    n_lines, n_depth = iw.shape
    if n_lines == 0:
        return
    n_nu = grid.shape[0]
    if budget is None:
        budget = 1 << 24 if grid.is_cuda else 1 << 20
    centers = centers.to(device=grid.device, dtype=torch.int64)
    reach = iw.amax(dim=1).to(torch.int64)
    lo = torch.clamp(centers - reach, 0, n_nu).cpu().numpy()
    hi = torch.clamp(centers + reach, 0, n_nu).cpu().numpy()
    pix_all = torch.arange(n_nu, device=grid.device)

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
        p0, p1 = max(p0, p_begin), min(p1, p_end)
        if p1 <= p0:
            continue
        off = pix_all[p0:p1][None, :] - centers[sl, None]  # [C, S]
        dnu = grid[p0:p1][None, :] - line_nu[sl, None]  # [C, S]
        half = iw[sl].to(torch.int64)[:, :, None]  # [C, D, 1]
        within = (off[:, None, :] >= -half) & (off[:, None, :] < half)
        li, di, pi = within.nonzero(as_tuple=True)
        yield sl, p0, p1, li, di, pi, dnu[li, pi]


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


def _faddeeva_grad_in_window(x, y):
    """(Re w, d Re w/dy, Re w + x d Re w/dx + y d Re w/dy) on in-window
    pairs, with the forward's region split: region I everywhere, the full
    chain where |x| + y <= 15.  The last value is taken in closed form in
    regions I and II (``faddeeva_real_region1_grad_euler``,
    ``faddeeva_real_region2_euler``), where its three terms cancel by
    ~|z|^2, and summed term by term in regions III and IV (|z| < 5.5)."""
    re, wy, wd = faddeeva_real_region1_grad_euler(x, y)
    s = torch.abs(x) + y
    core = s <= 15.0
    xc, yc = x[core], y[core]
    re_c, wx_c, wy_c = faddeeva_real_grad(xc, yc)
    wd_c = torch.where(s[core] > 5.5, faddeeva_real_region2_euler(xc, yc),
                       re_c + xc * wx_c + yc * wy_c)
    re[core], wy[core], wd[core] = re_c, wy_c, wd_c
    return re, wy, wd


def _line_grad_finish(s_w, s_y, s_d, alpha, doppler):
    """The three gradients of one (line, depth) pair from its window sums
    S_w = sum g Re w, S_y = sum g dRe w/dy and S_D = sum g (Re w + x dRe w/dx
    + y dRe w/dy) (g the incoming gradient per pixel), with
    phi = Re w / (sqrt(pi) D), x = dnu / D, y = gamma / (sqrt(pi) pi) / D:

        dL/dalpha = sum g phi             = S_w / (sqrt(pi) D)
        dL/dgamma = alpha sum g dphi/dgamma = alpha S_y / (sqrt(pi) pi D) / (sqrt(pi) D)
        dL/dD     = alpha sum g dphi/dD   = -alpha S_D / (sqrt(pi) D) / D

    S_D is summed as one quantity, not as S_w + S_x + y S_y, whose terms
    cancel in the far wing.  Kernel 1b finishes each pair with these
    operations in this order."""
    inv = 1.0 / (SQRT_PI * doppler)
    return (s_w * inv,
            alpha * s_y / (SQRT_PI * PI) / doppler * inv,
            -alpha * s_d * inv / doppler)


def accumulate_line_opacity_plain_backward(grad, grid, line_nu, centers, alpha, gamma,
                                           doppler, iw, budget=None, p_begin=0, n_out=None):
    """Plain torch version of Kernel 1b: the gradients of
    ``accumulate_line_opacity_plain`` (same arguments) with respect to
    alpha, gamma and doppler, given ``grad`` = dL/d(output) [B, D, n_out]
    (or [D, n_out] for [L, D] inputs).  Returns three tensors shaped as
    alpha.

    An explicit chunked sum, not autograd of the forward, which would keep
    every in-window pair of every chunk alive: each chunk of lines (cut as
    the forward cuts them) evaluates Re w and its derivatives on its
    in-window pairs of the range and adds g Re w, g dRe w/dy and
    g (Re w + x dRe w/dx + y dRe w/dy) into per-(line, depth) sums;
    ``_line_grad_finish`` turns them into the gradients."""
    if alpha.ndim == 3:
        parts = [accumulate_line_opacity_plain_backward(
            grad[b], grid, line_nu, centers, alpha[b], gamma[b], doppler[b], iw[b], budget,
            p_begin, n_out) for b in range(alpha.shape[0])]
        return tuple(torch.stack(p) for p in zip(*parts))
    n_nu = grid.shape[0]
    n_out = n_nu - p_begin if n_out is None else n_out
    n_lines, n_depth = alpha.shape
    sums = torch.zeros((3, n_lines * n_depth), dtype=alpha.dtype, device=alpha.device)
    for sl, p0, _p1, li, di, pi, dnu in _window_pairs(grid, line_nu, centers, iw, budget,
                                                      p_begin, p_begin + n_out):
        dop = doppler[sl][li, di]
        x = dnu / dop
        y = gamma[sl][li, di] / (SQRT_PI * PI) / dop
        re, wy, wd = _faddeeva_grad_in_window(x, y)
        g = grad[di, pi + (p0 - p_begin)]
        flat = (li + sl.start) * n_depth + di
        sums.index_add_(1, flat, torch.stack([g * re, g * wy, g * wd]))
    s_w, s_y, s_d = (s.reshape(n_lines, n_depth) for s in sums)
    return _line_grad_finish(s_w, s_y, s_d, alpha, doppler)


_LINE_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_double, ctypes.c_void_p] + [ctypes.c_int] * 5
              + [ctypes.c_void_p])


def accumulate_line_opacity_cuda(prepared, p_begin, n_out):
    """Kernel 1 (csrc/line_opacity.cu) on ``prepare_line_opacity``'s CUDA
    inputs: every model in one launch, pixels [p_begin, p_begin + n_out) of
    the global grid; returns [B, D, n_out].  A launch over the whole grid
    counts in ``launches``, one over a part of it in ``range_launches``."""
    q = prepared
    n_models, n_depth, n_lines = q.alpha.shape
    dtype = q.alpha.dtype
    out = torch.empty((n_models, n_depth, n_out), dtype=dtype, device=q.grid.device)
    if n_lines == 0:
        return out.zero_()
    if n_out == 0:
        return out
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = _cuda.bind("line_opacity", f"line_opacity_{suffix}", _LINE_ARGS)
    p = _cuda.ptr
    status = _cuda.launch(
        fn, q.grid.device,
        p(q.grid), p(q.line_nu), p(q.centers), p(q.alpha), p(q.gamma), p(q.doppler),
        p(q.iw), p(q.iw_max), q.step_min, p(out), n_models, n_lines, n_depth, p_begin, n_out,
    )
    if n_out == q.grid.shape[0]:
        _cuda.count(accumulate_line_opacity_cuda, "launches")
    else:
        _cuda.count(accumulate_line_opacity_cuda, "range_launches")
    _cuda.check("line_opacity", status)
    return out


#: launches of Kernel 1 over the whole grid, and over a part of it (the
#: ranges of a segmented run)
accumulate_line_opacity_cuda.launches = 0
accumulate_line_opacity_cuda.range_launches = 0


#: Kernel 1b's tile of lines per block (csrc/line_opacity_grad.cu's TILE),
#: and the most splits one launch aims at (its scratch holds 3 x TILE sums
#: per split)
LINE_GRAD_TILE = 32
LINE_GRAD_MAX_SPLITS = 1 << 16


def line_grad_chunk(dtype):
    """Pixels Kernel 1b stages in shared memory at a time: 8 KB of each
    operand (csrc/line_opacity_grad.cu's chunk_pixels)."""
    return 8192 * 8 // torch.finfo(dtype).bits


@dataclasses.dataclass
class LineGradSchedule:
    """Kernel 1b's work over pixels [p_begin, p_begin + n_out): the lines of
    each (model, depth) in tiles of LINE_GRAD_TILE, each tile's union span
    [tile_lo, tile_hi) of its windows cut to the range, and that span cut
    into splits of ``split_pixels`` (a multiple of the staged chunk).  Split
    s of tile f covers [tile_lo[f] + s split_pixels, min(tile_lo[f] + (s + 1)
    split_pixels, tile_hi[f])); the splits are numbered tile by tile
    (``tile_start[f]`` is tile f's first, ``unit_tile[u]`` the tile of split
    u), and the kernel's second pass adds a line's split sums in that
    order."""

    tile_lo: torch.Tensor  # [B * D * n_tiles] int32
    tile_hi: torch.Tensor
    tile_start: torch.Tensor  # [B * D * n_tiles + 1] int32
    unit_tile: torch.Tensor  # [n_units] int32
    split_pixels: int
    n_units: int
    n_tiles: int


def pair_windows(centers, iw, n_nu, p_begin, n_out):
    """[lo, hi) of each pair's window -iw <= p - centre < iw cut to the grid
    and to the range, as int64 [..., L] for iw [..., L] (empty: hi <= lo)."""
    c = centers.to(torch.int64)
    half = iw.to(torch.int64)
    lo = torch.clamp(c - half, min=max(p_begin, 0))
    hi = torch.clamp(c + half, max=min(p_begin + n_out, n_nu))
    return lo, hi


def line_grad_schedule(centers, iw, n_nu, p_begin, n_out, chunk):
    """Kernel 1b's schedule (``LineGradSchedule``) from the centres [L] and
    the half-windows [B, D, L] (the prepared layout), for ``chunk`` pixels
    staged at a time (``line_grad_chunk``), by torch ops on their
    device."""
    n_models, n_depth, n_lines = iw.shape
    tile = LINE_GRAD_TILE
    n_tiles = -(-n_lines // tile)
    lo, hi = pair_windows(centers, iw, n_nu, p_begin, n_out)
    empty = hi <= lo
    big = n_nu + 1  # past every window's end
    lo = lo.masked_fill(empty, big).reshape(n_models * n_depth, n_lines)
    hi = hi.masked_fill(empty, -1).reshape(n_models * n_depth, n_lines)
    pad = n_tiles * tile - n_lines
    lo = torch.nn.functional.pad(lo, (0, pad), value=big).reshape(-1, n_tiles, tile).amin(2)
    hi = torch.nn.functional.pad(hi, (0, pad), value=-1).reshape(-1, n_tiles, tile).amax(2)
    span = torch.clamp(hi - lo, min=0).reshape(-1)
    lo = torch.where(span > 0, lo.reshape(-1), 0)
    hi = lo + span
    total_chunks = int(((span + chunk - 1) // chunk).sum())
    split_pixels = chunk * max(1, -(-total_chunks // LINE_GRAD_MAX_SPLITS))
    n_splits = (span + split_pixels - 1) // split_pixels
    tile_start = torch.cat([n_splits.new_zeros(1), torch.cumsum(n_splits, 0)])
    n_units = int(tile_start[-1])
    unit_tile = torch.repeat_interleave(
        torch.arange(len(span), device=span.device, dtype=torch.int32), n_splits,
        output_size=n_units)
    i32 = torch.int32
    return LineGradSchedule(lo.to(i32), hi.to(i32), tile_start.to(i32), unit_tile,
                            split_pixels, n_units, n_tiles)


_LINE_GRAD_ARGS = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def accumulate_line_opacity_grad_cuda(prepared, grad, p_begin, n_out):
    """Kernel 1b (csrc/line_opacity_grad.cu): the gradients of Kernel 1's
    range [p_begin, p_begin + n_out) with respect to alpha, gamma and
    doppler, given grad [B, D, n_out]; three [B, D, L] tensors in the
    prepared layout, each element written once.  One launch runs both of
    the kernel's passes over ``line_grad_schedule``'s splits, with a
    [n_units, 3, LINE_GRAD_TILE] scratch of partial sums between them."""
    q = prepared
    n_models, n_depth, n_lines = q.alpha.shape
    dtype = q.alpha.dtype
    if grad.shape != (n_models, n_depth, n_out):
        raise ValueError(f"line_opacity_grad kernel: grad must be {(n_models, n_depth, n_out)}")
    if grad.dtype != dtype or grad.device != q.grid.device:
        raise TypeError("line_opacity_grad kernel: grad must match the line arrays")
    grad = grad.contiguous()
    outs = [torch.empty_like(q.alpha) for _ in range(3)]
    if n_lines == 0 or n_models * n_depth == 0:
        return outs
    n_nu = q.grid.shape[0]
    chunk = line_grad_chunk(dtype)
    sched = line_grad_schedule(q.centers, q.iw, n_nu, p_begin, n_out, chunk)
    scratch = torch.empty((max(sched.n_units, 1), 3, LINE_GRAD_TILE), dtype=dtype,
                          device=q.grid.device)
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = _cuda.bind("line_opacity_grad", f"line_opacity_grad_{suffix}", _LINE_GRAD_ARGS)
    p = _cuda.ptr
    status = _cuda.launch(
        fn, q.grid.device,
        p(q.grid), p(q.line_nu), p(q.centers), p(q.alpha), p(q.gamma), p(q.doppler),
        p(q.iw), p(grad), *(p(o) for o in outs), p(sched.tile_lo), p(sched.tile_hi),
        p(sched.tile_start), p(sched.unit_tile), p(scratch), n_models, n_lines, n_depth,
        p_begin, n_out, n_nu, sched.n_units, sched.split_pixels, LINE_GRAD_TILE, chunk,
    )
    _cuda.count(accumulate_line_opacity_grad_cuda, "launches")
    _cuda.check("line_opacity_grad", status)
    return outs


#: launches of Kernel 1b (whole grid and ranges alike; one per call, both
#: passes)
accumulate_line_opacity_grad_cuda.launches = 0
