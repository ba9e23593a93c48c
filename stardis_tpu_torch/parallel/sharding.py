"""Wavelength segments on one device: grids larger than the card's memory.

The port of ``segmented_spectrum`` (``stardis_tpu/parallel/sharding.py:555``).
The grid runs as K contiguous pixel ranges, one after another, each through
``pipeline.spectrum_batch`` on its range: the continuum on the range's
columns, Kernel 1's range launch (the counterpart of
``accumulate_pairs_blocked``, ``stardis_tpu/opacities/line_kernel.py:1316``)
and Kernel 2 on the range.  Every range reads the global grid, centres,
windows and reference frequency, so each pixel is computed exactly as in
the unsegmented run; only the bound-free ``torch.matmul`` may round
otherwise at another width.  Peak device memory is the plan's fixed arrays
plus one range's [D, n] grids (``util.memory``).

What the JAX function does for XLA and the TPU is not carried: padding to
equal segments, one compiled program for all of them, the window tiers and
the ``chunk`` size.  The wavelength sharding over a mesh
(``shard_spectrum``, ``shard_batch_spectrum``) is not ported yet
(ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..pipeline import _stage, host_array, prepare_lines, spectrum_batch


def segment_ranges(n_nu, n_segments):
    """[(a, b)]: K contiguous pixel ranges of ceil(N / K) pixels (the last
    may be shorter) covering [0, n_nu); fewer when K > n_nu."""
    k = int(n_segments)
    if k < 1:
        raise ValueError(f"n_segments must be >= 1, got {n_segments}")
    per = -(-int(n_nu) // k)
    return [(a, min(a + per, n_nu)) for a in range(0, n_nu, per)]


class _Walls:
    """Per-range device time: CUDA events on the card (the time between a
    range's first and last queued work), the host clock on the CPU."""

    def __init__(self, device):
        self._cuda = device.type == "cuda"
        self._marks = []
        self.mark()

    def mark(self):
        if self._cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self._marks.append(event)
        else:
            self._marks.append(time.perf_counter())

    def seconds(self):
        if self._cuda:
            self._marks[-1].synchronize()
            return [a.elapsed_time(b) * 1e-3 for a, b in zip(self._marks, self._marks[1:])]
        return [b - a for a, b in zip(self._marks, self._marks[1:])]


def segmented_spectrum(plan, state, line_quants, n_segments, consts, collect_opacities=False,
                       segment_walls=None, ray_distances=None, file_sigma_override=None,
                       plain=False, timings=None):
    """One model's spectrum in ``n_segments`` serial pixel ranges.

    state, line_quants : stage 1 of this model
    consts : the plan's DeviceConstants (``pipeline.device_constants``)
    collect_opacities : copy each range's per-source opacity grids, and
        their total, to host NumPy arrays [D, N] (one device-to-host copy
        per range), under the keys of ``pipeline.stage_spectrum``; the
        per-line ``_gammas`` / ``_doppler_widths`` diagnostics are attached
        once, as host arrays [L, D]
    segment_walls : optional list that receives each range's device time
        in seconds (CUDA events; host times on the CPU)
    ray_distances : [G, T] host array replacing the plan's (a served
        request's geometry)
    file_sigma_override : per plan.file_sources entry, a [D, N] host array
        replacing the plan's sigmas (a served request's temperatures)
    plain, timings : as ``pipeline.spectrum_batch``

    In the accuracy window mode the per-depth epsilon comes from a
    continuum-only pass over the ranges (``pipeline.accuracy_epsilon``),
    not from a continuum of the whole grid.

    F_nu, and I_nus when the plan tracks them, are written into one
    preallocated device tensor each; without ``collect_opacities`` they
    carry gradients to stage 1's tensors (each range's Kernels 1b and 2b
    sum over that range only).  With it, a stage-1 tensor that requires
    grad raises: the host copies carry none.  Under autograd the ranges do
    not bound device memory: each range's saved tensors (Kernel 2's
    [1, D, n, T] intensity buffer, its opacities and source) live until the
    backward, which adds Kernel 2b's two [1, D, n, T] partial buffers per
    range (and a [1, G, n, T] scratch for the inward sweep);
    ``util.memory`` and ``nu_segments="auto"`` model forward-only runs.
    Returns F_nu [D, N]; (F_nu, I_nus)
    when the plan tracks I_nu; (F_nu, I_nus or None, opacities, total)
    with ``collect_opacities``.
    """
    t = state.t
    device = t.device
    n_nu = len(plan.tracing_nus)
    n_depth = len(plan.temperatures)
    ranges = segment_ranges(n_nu, n_segments)
    rays = None if ray_distances is None else np.asarray(ray_distances)[None]
    sigmas = (None if file_sigma_override is None
              else [np.asarray(s)[None] for s in file_sigma_override])
    track = plan.track_individual_intensities

    with _stage(timings, "line_opacity", device):
        lines = prepare_lines(plan, [state], [line_quants], consts, sigmas, plain, ranges)

    f_nu = torch.empty((n_depth, n_nu), dtype=t.dtype, device=device)
    i_nus = (torch.empty((n_depth, n_nu, len(plan.weights)), dtype=t.dtype, device=device)
             if track else None)
    opacities, total = {}, None
    walls = _Walls(device)
    for a, b in ranges:
        f_s, total_s, opac_s, i_s = spectrum_batch(
            plan, [state], lines, consts, ray_distances=rays,
            photospheric_correction=plan.photospheric_correction, file_sigmas=sigmas,
            plain=plain, timings=timings, pixels=(a, b),
        )
        f_nu[:, a:b] = f_s[0]
        if track:
            i_nus[:, a:b] = i_s[0]
        del f_s, i_s
        walls.mark()
        if collect_opacities:
            keys = [k for k in opac_s if "gammas" not in k and "doppler" not in k]
            host = host_array(torch.stack([opac_s[k][0] for k in keys] + [total_s[0]]),
                              "segmented_spectrum(collect_opacities=True)")
            if total is None:
                opacities = {k: np.empty((n_depth, n_nu), dtype=host.dtype) for k in keys}
                total = np.empty((n_depth, n_nu), dtype=host.dtype)
            for i, k in enumerate(keys):
                opacities[k][:, a:b] = host[i]
            total[:, a:b] = host[-1]
        del opac_s, total_s
    if segment_walls is not None:
        segment_walls.extend(walls.seconds())

    if collect_opacities:
        for label, _prepared, gamma, doppler in lines:
            what = "segmented_spectrum(collect_opacities=True)"
            opacities[label + "_gammas"] = host_array(gamma[0], what)
            opacities[label + "_doppler_widths"] = host_array(doppler[0], what)
        return f_nu, i_nus, opacities, total
    if track:
        return f_nu, i_nus
    return f_nu
