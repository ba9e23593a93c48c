"""The benchmark's yardstick: the card's peaks, the operation counts and byte
rules of the kernels' bounds, the in-window Voigt evaluations, and the
reduction of a profiler trace to busy time and kernel time.

Frozen from ``chip_smoke.py`` at commit 9c7d618 (``PEAK_FP32_FLOPS``,
``PEAK_BYTES_PER_S``, ``KERNEL1_FLOPS``, ``GRAD_VOIGT_FLOPS``,
``GRAD_PAIR_FLOPS``, ``KERNEL2_STEP_FLOPS``, ``KERNEL2_GAP_FLOPS``,
``bound``, ``voigt_evaluations``, the byte rules of ``line_bound`` and
``line_grad_bound``, ``device_busy`` and ``kernel_device_ms``), so that a
kernel that changes does not change what it is measured against.  The
operation counts are the fewest per evaluation the program has shown; a
faster kernel reads above 100 % of its bound only if it skips work.
"""

from __future__ import annotations

import numpy as np

#: published peaks of one H100 SXM at 700 W: float32 outside the tensor
#: cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

#: operations of one in-window Voigt evaluation of Kernel 1, by Humlicek
#: region (counted from csrc/line_opacity.cu at 9c7d618)
KERNEL1_FLOPS = {"I": 12, "II": 38, "III": 86, "IV": 131}
#: the same for Kernel 1b (value and derivatives), and per (model, depth,
#: line) pair (csrc/line_opacity_grad.cu at 9c7d618)
GRAD_VOIGT_FLOPS = {"I": 29, "II": 119, "III": 187, "IV": 298}
GRAD_PAIR_FLOPS = 58
#: operations of Kernel 2 per depth step of one ray, and per (gap,
#: frequency) of a model (csrc/formal_solution.cu at 9c7d618)
KERNEL2_STEP_FLOPS = 30
KERNEL2_GAP_FLOPS = 4

REGIONS = ("I", "II", "III", "IV")


def bound(flops, nbytes):
    """(bound seconds, "operations" or "bytes"): the larger of the
    operations over the float32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def line_bytes(n_models, n_lines, n_depth, n_out, itemsize):
    """Kernel 1's bytes: the [B, D, L] line arrays (three floats and the
    int32 window), the lines and the grid's range read once, [B, D, n_out]
    written once."""
    return (n_models * n_depth * n_lines * (3 * itemsize + 4) + n_lines * (itemsize + 4)
            + n_out * itemsize + n_models * n_depth * n_out * itemsize)


def line_grad_bytes(n_models, n_lines, n_depth, n_out, itemsize):
    """Kernel 1b's bytes: as Kernel 1's reads plus the incoming gradient
    [B, D, n_out], and three [B, D, L] gradients written."""
    pairs = n_models * n_depth * n_lines
    return (pairs * (3 * itemsize + 4) + n_lines * (itemsize + 4) + n_out * itemsize
            + n_models * n_depth * n_out * itemsize + 3 * pairs * itemsize)


def kernel1_flops(evaluations):
    return sum(KERNEL1_FLOPS[k] * v for k, v in evaluations.items())


def kernel1_bound(evaluations, n_models, n_lines, n_depth, n_out, itemsize):
    """Kernel 1's bound in seconds for one launch."""
    return bound(kernel1_flops(evaluations),
                 line_bytes(n_models, n_lines, n_depth, n_out, itemsize))[0]


def kernel2_flops(n_models, n_depth, n_nu, n_theta, inward):
    """Kernel 2's operations for one launch: the depth steps of every ray
    (twice with the inward sweep), the staged mean extinction and the theta
    sum."""
    rays = n_models * n_nu * n_theta
    return (rays * (n_depth - 1) * KERNEL2_STEP_FLOPS * (2 if inward else 1)
            + n_models * (n_depth - 1) * n_nu * KERNEL2_GAP_FLOPS
            + 2 * n_models * n_depth * n_nu * n_theta)


def voigt_evaluations(nus, line_nu, centers, gamma, doppler, iw, pixels=None):
    """In-window Voigt evaluations of Kernel 1 by Humlicek region, for
    one model: nus [N] descending, line_nu / centers [L], gamma, doppler,
    iw [L, D] (host, float64), over the pixel range ``pixels`` = (a, b)
    (default the whole grid).  A pair (line, depth, pixel) is in window when
    -iw <= p - centre < iw; its region follows from |x| + y (I above 15,
    II above 5.5) and, below 5.5, from y >= 0.195 |x| - 0.176 (III, else
    IV), with x = (nu_p - nu_l) / doppler and y = gamma / (sqrt(pi) pi) /
    doppler.  Pixels within a distance of nu_l are counted by binary search
    on the grid.  (chip_smoke.py at 9c7d618, as it was.)"""
    n = len(nus)
    p0, p1 = pixels or (0, n)
    asc = nus[::-1]
    c = centers[:, None]
    lo, hi = np.clip(c - iw, p0, p1), np.clip(c + iw, p0, p1)  # window [lo, hi) in the range
    y = gamma / (np.sqrt(np.pi) * np.pi) / doppler
    nu = line_nu[:, None]

    def within(half):  # in-window pixels with |x| <= half (half < 0: none)
        r = np.where(half >= 0, half, np.nan) * doppler
        a = n - np.searchsorted(asc, (nu + r).ravel(), "right").reshape(r.shape)
        b = n - np.searchsorted(asc, (nu - r).ravel(), "left").reshape(r.shape)
        count = np.clip(np.minimum(hi, b) - np.maximum(lo, a), 0, None)
        return int(np.where(half >= 0, count, 0).sum())

    total = int(np.clip(hi - lo, 0, None).sum())
    core15, core55 = within(15.0 - y), within(5.5 - y)
    region3 = within(np.minimum(5.5 - y, (y + 0.176) / 0.195))
    return {"I": total - core15, "II": core15 - core55, "III": region3,
            "IV": core55 - region3}


def voigt_evaluations_torch(nus, line_nu, centers, gamma, doppler, iw):
    """``voigt_evaluations`` over the whole grid in torch, on the device of
    its tensors, for [B, L, D] (or [L, D]) gamma, doppler and iw; the same
    arithmetic, summed over the models: a dict of ints."""
    import torch

    n = nus.shape[0]
    asc = torch.flip(nus, (0,)).contiguous()
    c = centers.to(torch.int64)[:, None]
    iw = iw.to(torch.int64)
    lo, hi = torch.clamp(c - iw, 0, n), torch.clamp(c + iw, 0, n)
    y = gamma / (np.sqrt(np.pi) * np.pi) / doppler
    nu = line_nu[:, None]

    def within(half):
        keep = half >= 0
        r = torch.where(keep, half, torch.zeros_like(half)) * doppler
        a = n - torch.searchsorted(asc, (nu + r).reshape(-1).contiguous(),
                                   right=True).reshape(r.shape)
        b = n - torch.searchsorted(asc, (nu - r).reshape(-1).contiguous(),
                                   right=False).reshape(r.shape)
        count = torch.clamp(torch.minimum(hi, b) - torch.maximum(lo, a), min=0)
        return int(torch.where(keep, count, torch.zeros_like(count)).sum())

    total = int(torch.clamp(hi - lo, min=0).sum())
    core15, core55 = within(15.0 - y), within(5.5 - y)
    region3 = within(torch.minimum(5.5 - y, (y + 0.176) / 0.195))
    return {"I": total - core15, "II": core15 - core55, "III": region3,
            "IV": core55 - region3}


def busy_intervals(spans):
    """The union of (start, end) intervals, sorted and merged."""
    merged = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def busy_seconds(spans):
    """Seconds in which at least one of the (start_us, end_us) spans ran:
    ``device_busy``'s union of the card's kernel, copy and memset
    intervals."""
    return sum(end - start for start, end in busy_intervals(spans)) * 1e-6


def kernel_seconds(device_events, name):
    """Device seconds of the events whose name contains ``name``
    (``kernel_device_ms``'s match), with the number of such events."""
    hits = [(end - start) for ev_name, start, end in device_events if name in ev_name]
    return sum(hits) * 1e-6, len(hits)
