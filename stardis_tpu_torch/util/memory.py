"""Device-memory model for wavelength segments on one GPU.

The port of ``stardis_tpu/util/memory.py`` with its public names; its
coefficients are the port's own arrays, not the TPU's.  The spectrum of a
pixel range [a, b) of n pixels (``pipeline.spectrum_batch``) holds, at its
peak, which is Kernel 2's launch, these [D, n] arrays at once:

* one per opacity source in the opacities dict (each continuum source,
  each line set's sum; ``count_alpha_sources``),
* their total, the blackbody source and F_nu,
* Kernel 2's intensity buffer [D, n, T], allocated on every launch (it
  is I_nu when tracked).

Each segment-independent array is counted once (``fixed_overhead_bytes``):
stage 1's per-(line, depth) alpha, gamma and doppler, Kernel 1's
depth-major copies of them and its integer windows, and, when the grid
runs in K > 1 segments, the preallocated F_nu [D, N] (and I_nu
[D, N, T] when tracked) that the segments are written into; with K = 1
the range's own F_nu and intensity buffer are the output.

The model errs high: ``chip_smoke.py`` phases 9 and 10 measure the peak
of ``run_stardis`` on the card (``torch.cuda.max_memory_allocated``)
beside ``estimate_segment_bytes + fixed_overhead_bytes`` and hold the
estimate above the peak and within 1.5x of it: plane-parallel and the
spherical giant with file tables and molecules, with and without I_nu,
unsegmented and in budgeted segments.  ``choose_nu_segments`` inverts
it for the smallest K whose footprint fits.  There is no retry on an
out-of-memory error: a budget too small for one pixel returns K = 1 and
the device reports the failure.

The model covers forward-only runs.  Under autograd every range keeps its
saved tensors until the backward, and the backward adds Kernel 2b's
buffers, so segments do not bound the peak; ``chip_smoke.py`` phase 13
measures a differentiated segmented run's peak beside this estimate.
"""

from __future__ import annotations

import math
import os

#: the card's device memory where no CUDA device can be asked (NVIDIA H100
#: 80GB)
DEFAULT_BYTES_LIMIT = 80 * 10**9
#: share of the budget the model may fill: the caching allocator's
#: rounding and fragmentation reserve more than the tensors hold
HEADROOM = 0.9
#: more serial segments than this means the grid does not fit the device
MAX_SEGMENTS = 256
#: [D, n] arrays per pixel range besides the opacity sources: their total,
#: the blackbody source and F_nu
RANGE_ARRAYS = 3
#: [L, D] arrays per line set held through the spectrum: stage 1's alpha,
#: gamma and doppler, Kernel 1's three depth-major copies of them, and its
#: half-windows (int32) before and after the transpose
LINE_ARRAYS = 8


def device_bytes_limit(device=None):
    """Bytes the card can still give this process: free device memory
    (``torch.cuda.mem_get_info``) plus what the caching allocator holds
    unused.  ``DEFAULT_BYTES_LIMIT`` without a CUDA device."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return DEFAULT_BYTES_LIMIT
    free, _total = torch.cuda.mem_get_info(device)
    return int(free + torch.cuda.memory_reserved(device)
               - torch.cuda.memory_allocated(device))


def per_pixel_bytes(n_depth: int, n_thetas: int, n_alpha_sources: int,
                    itemsize: int = 4) -> int:
    """Device bytes per wavelength pixel of a pixel range at its peak."""
    return int(n_depth * (n_alpha_sources + RANGE_ARRAYS + n_thetas) * itemsize)


def estimate_segment_bytes(n_nu_seg: int, n_depth: int, n_thetas: int,
                           n_alpha_sources: int, itemsize: int = 4) -> int:
    """Peak device bytes of one ``n_nu_seg``-pixel range, without the
    segment-independent arrays (``fixed_overhead_bytes``)."""
    return per_pixel_bytes(n_depth, n_thetas, n_alpha_sources, itemsize) * int(n_nu_seg)


def count_alpha_sources(plan) -> int:
    """[D, n] opacity grids of a plan's opacities dict: file tables, bf,
    ff, Rayleigh, electron scattering (always present, zero when
    disabled) and one line sum per line set with lines."""
    n = len(plan.file_sources) + 1  # + electron scattering
    n += 1 if plan.bf is not None and len(plan.bf.level_flat) else 0
    n += 1 if len(plan.ff_slots) else 0
    n += 1 if plan.rayleigh_species else 0
    for line_data in (plan.line_data, plan.molecule_line_data):
        n += 1 if line_data is not None and line_data.n_lines > 0 else 0
    return n


def fixed_overhead_bytes(plan, n_segments: int = 1, itemsize: int = 4) -> int:
    """Segment-independent device bytes: the line sets' [L, D] arrays and,
    for K > 1 segments, the preallocated F_nu (and I_nu when tracked)."""
    n_depth = len(plan.temperatures)
    n_lines = sum(ld.n_lines for ld in (plan.line_data, plan.molecule_line_data)
                  if ld is not None)
    fixed = LINE_ARRAYS * n_lines * n_depth * itemsize
    if n_segments > 1:
        columns = 1 + (len(plan.weights) if plan.track_individual_intensities else 0)
        fixed += columns * n_depth * len(plan.tracing_nus) * itemsize
    return int(fixed)


def choose_nu_segments(plan, bytes_limit: int | None = None, itemsize: int = 4,
                       device=None) -> int:
    """Smallest serial segment count whose footprint fits the budget.

    bytes_limit : the budget in bytes; default the ``STARDIS_SEGMENT_BUDGET``
        variable, else ``device_bytes_limit(device)``.
    Returns 1 when the whole grid fits, and when not even a one-pixel
    range fits (segments cannot help); raises past ``MAX_SEGMENTS``.
    """
    env = os.environ.get("STARDIS_SEGMENT_BUDGET")
    if bytes_limit is None and env:
        bytes_limit = int(float(env))
    if bytes_limit is None:
        bytes_limit = device_bytes_limit(device)
    budget = HEADROOM * bytes_limit
    n_nu = len(plan.tracing_nus)
    per_px = per_pixel_bytes(len(plan.temperatures), len(plan.weights),
                             count_alpha_sources(plan), itemsize)
    if fixed_overhead_bytes(plan, 1, itemsize) + per_px * n_nu <= budget:
        return 1
    avail = budget - fixed_overhead_bytes(plan, 2, itemsize)
    if avail < per_px:
        return 1
    k = max(2, math.ceil(n_nu * per_px / avail))
    while -(-n_nu // k) * per_px > avail:
        k += 1
    k = min(k, n_nu)
    if k > MAX_SEGMENTS:
        raise ValueError(
            f"auto-segmentation wants {k} serial segments ({n_nu} points x "
            f"{per_px} B/px against {avail / 1e9:.2f} GB available) - more than "
            f"the {MAX_SEGMENTS}-segment sanity bound. The grid does not "
            "meaningfully fit this device; raise the budget or narrow the grid."
        )
    return k
