#!/usr/bin/env python3
"""Smoke test of stardis_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the four hand-written kernels from stardis_tpu_torch/csrc with
     nvcc, one process per source, all started together;
  3. Kernel 1 (line opacity) against its plain torch version on the card,
     5k lines x 56 depths x 10k lambda: float64 at rtol 1e-12, float32 at
     max|diff| <= 1e-5 max|plain| per depth row; then both timed at the
     slice's shape (all 47,807 in-window lines, float32; bound 1e-4 per
     row for the two summation orders of that many float32 terms); the
     per-depth widest window (torch amax) timed; Kernel 1b (the line sum's
     backward) against its plain version on the same inputs with a seeded
     normal incoming gradient: float64 at 1e-12 and float32 at 1e-4 of each
     depth's largest gradient, two launches equal bit for bit, both timed;
  4. Kernel 2 (formal solution) against its plain version at the full
     Sim100AA shape (56 depths x 10k lambda x 20 theta), float32 and float64;
     Kernel 2b (its backward) against autograd of raytrace_plain there,
     with and without a gradient on I_nu: float64 at 1e-9 of each
     frequency column's largest gradient, float32 within 1.5x the plain
     version's float32 error (2-norm) against the float64 gradient, two
     launches equal bit for bit, both timed;
  5. the slice: run_stardis(device="cuda", dtype=float32) on Sim100AA with
     100k synthetic lines; F_nu finite and positive, both kernels launched
     by that run; warm wall time and per-stage times; and at 10k lines the
     kernel path's F_nu against the all-plain path's on the card at
     rtol 1e-4; max|dF/F| of accuracy against reference windows; one
     profiled run (device-busy share of the wall, device ops);
  6. Kernel 2's inward sweep against its plain version at the spherical
     giant's shape (56 depths x 10k lambda x 20 theta; its sources, its
     shells with the atmosphere thickened 5x so that chords miss inner
     shells and have ray distance 0), on two sets of opacities: the
     giant's own, and the same with each frequency column scaled so that
     the per-gap tau spans all three weight regimes (each regime's share
     is printed and must be at least 1 %): float64 at 1e-12, float32 at
     1e-5; both timed on the giant's own; Kernel 2b's inward variant on
     both sets, held as in phase 4;
  7. the spherical cool giant (Teff 4000 K, log g 2, R 2e12 cm) through
     run_stardis(device="cuda", dtype=float32): molecules, three file
     opacity tables, 100k atomic + 20k molecular lines, 6500-6600 AA at
     0.01 AA, 20 theta; F_nu finite and positive, Kernel 1 launched twice
     and the inward sweep once; warm wall and per-stage times; at 10k + 2k
     lines the kernel path against the all-plain path at rtol 1e-4, in
     reference and in accuracy window mode, and Kernel 1's own atomic and
     molecular sums against plain at 1e-4 of each depth row's maximum;
     max|dF/F| of accuracy against reference mode; the coupled molecular
     network's residual; the TF32 switch left as it was; profiled runs,
     pairwise and coupled;
  8. the batch: 16 plane-parallel models (Teff 5000-6500 K, 20k lines,
     6560-6570 AA at 0.01 AA, 20 theta, float32) through run_batch,
     against the plain versions (rtol 1e-4), Kernel 1's own [16, D, N]
     sum against plain in both window modes (1e-4 of each row's maximum),
     and every member against run_stardis of that model (rtol 1e-5);
     atmospheres/s; a profiled run; and a 4-member
     batch of spherical giants with file opacities against the individual
     runs (per-model corrections and cross-sections);
  9. the memory model: run_stardis on the Sim100AA configuration with 10k
     lines over 4000-7000 AA at 125k, 250k, 500k and 1M points, with and
     without return_radiation_field, and on the spherical giant (three
     file tables, molecules, 10k + 2k lines) at 250k points with and
     without it and at 1M without: the measured peak
     (torch.cuda.max_memory_allocated) beside util.memory's estimate, which
     must be at least the peak and at most 1.5x it; then nu_segments="auto"
     at 1M points under a budget of 40 % of the unsegmented peak, and at
     250k points with return_radiation_field under the unsegmented tracked
     run's peak: K > 1, peak under the budget and within the estimate's
     bound, F_nu (and I_nu, the total and every opacity) equal to the
     unsegmented run (rtol 1e-6);
 10. Kernel 1's range launch at the Sim100AA shape in K = 3 ranges of the
     10,000-point grid: equal bit for bit to the full launch (float32 and
     float64), against its plain version at rtol 1e-12 (float64), timed
     (float32); then the flagship, 1M points (4000-7000 AA) x 100k lines,
     through run_stardis(nu_segments="auto") and nu_segments=4: K chosen,
     cold and warm walls, per-stage times, peak memory beside the
     estimate, the segments' device times; F_nu finite, positive and equal
     at rtol 1e-6; on the flagship's own prepared inputs, Kernel 1 against
     its plain version on 512-pixel ranges at both grid ends, across each
     K = 4 boundary and across a deep window's edge (float32 at 1e-4 of
     each row's maximum, float64 at rtol 1e-12), and Kernel 2 on the whole
     [56, 1M] x 20 theta against its plain version (rtol 1e-5);
 11. serving: SpectralService on Sim100AA answering Teff 5777, 6300 and
     9000 K, each against run_stardis (rtol 1e-5), warm per-request walls
     beside run_stardis's; the same requests through nu_segments=3 against
     the unsegmented service (rtol 1e-6); a spherical-giant service with
     file tables answering a 4200 K request (one sigma re-interpolation)
     against run_stardis (rtol 1e-5); synthesize_batch of the 16 batch
     models against run_batch (rtol 1e-6); one profiled request;
 12. a grid scan of the 16 batch models in chunks of 8, stopped after one
     chunk and resumed, equal bit for bit to an uninterrupted scan; and
     `python -m stardis_tpu_torch` on a JSON Sim100AA config with
     --segments auto --ascii, against run_stardis (rtol 1e-6);
 13. the gradient slice: Sim100AA at full width (100k lines, 56 depths,
     10k lambda, 20 theta, float32) fitted by Adam on the card.  The loss is
     the mean squared difference of the rotation- and instrument-broadened,
     mean-normalised surface spectrum from one made at (T scale 1.021,
     v sin i 11 km/s, sigma 3 px), from (1.0, 5.0, 2.0); loss.backward()
     runs through stage 1, Kernels 1, 1b, 2, 2b and post-processing (their
     launch counts printed); 5 Adam steps lower the loss; in float64 the
     gradient matches central differences (rtol 5e-3) and, at 10k lines,
     the all-plain path's gradient (1e-9); forward, backward and warm
     step walls, the backward kernels' device times, the peak memory of a
     step, and two float32 gradient runs compared (Kernels 1b and 2b must
     be bit-equal; a stage-1 difference is traced to its op); the
     spherical giant with molecules (pairwise and coupled) at 10k + 2k
     lines: float64 d sum F_nu / dT at its most sensitive depth against a
     central difference (rtol 5e-3), float32 finite; a 4-member spherical
     batch's gradient through run_batch (Kernels 1b and 2b inward at B = 4),
     each member's row against the all-plain path's in float64 (float64
     kernel path at 1e-9, the float32 main path at 1e-5 of the member's
     largest); and the peak memory of a segmented run at 250k points, K = 1
     and K = 4, forward only and with its backward, beside util.memory's
     forward-only estimate.

The kernels build in parallel (one nvcc per source).  The last line of
standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is the card's name and power limit, and the line
before that holds each kernel's launches (summed over the main paths of
phases 5, 7-12 and 13; the CLI runs in a process of its own and is not
counted), error, times and bound (the larger of the operations
over the float32 peak and the bytes over the memory rate of an H100 SXM,
from this run's inputs).
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

SIM100AA_LAMBDA = (6500.0, 6600.0, 0.01)  # AA: 10,000 points
N_LINES = 100_000
N_LINES_PLAIN_CHECK = 10_000
N_LINES_KERNEL_CHECK = 5_000
GIANT = {"teff": 4000.0, "logg": 2.0, "spherical": True, "radius_cm": 2e12}
GIANT_MOL_LINES = 20_000
GIANT_MOL_LINES_PLAIN_CHECK = 2_000
# the inward sweep's check scales the opacity columns down to where the
# largest per-gap tau is 10^-INWARD_MIN_DECADES (Taylor regime)
INWARD_MIN_DECADES = 6.0
BATCH_MODELS = 16
BATCH_LINES = 20_000
BATCH_LINE_RANGE = (6540.0, 6590.0)
BATCH_LAMBDA = (6560.0, 6570.0, 0.01)  # AA: 1,000 points
GIANT_BATCH = [(3900.0, 1.5e12), (4000.0, 2.0e12), (4200.0, 2.5e12), (4500.0, 3.5e12)]
FLAGSHIP_LAMBDA = (4000.0, 7000.0)  # AA, np.linspace over FLAGSHIP_POINTS (bench.py)
FLAGSHIP_POINTS = 1_000_000
FLAGSHIP_LINE_RANGE = (3950.0, 7050.0)
FLAGSHIP_SEGMENTS = 4
# Kernel 1 is held against its plain version at the flagship on ranges of
# this many pixels; the plain version takes line chunks of up to
# FLAGSHIP_PLAIN_BUDGET / (56 depths x the chunk's reach on the 1M grid),
# ~1024 lines where the reach spans the grid
FLAGSHIP_CHECK_PIXELS = 512
FLAGSHIP_PLAIN_BUDGET = 1 << 36
# Kernel 2's plain version runs on column blocks of this many pixels
FLAGSHIP_TRACE_BLOCK = 125_000
MEMORY_POINTS = (125_000, 250_000, 500_000, 1_000_000)
MEMORY_LINES = 10_000
MEMORY_BUDGET_SHARE = 0.4
# the giant's memory runs: (points, return_radiation_field), with
# MEMORY_LINES atomic and MEMORY_MOL_LINES molecular lines
MEMORY_GIANT_RUNS = ((250_000, False), (250_000, True), (1_000_000, False))
MEMORY_MOL_LINES = 2_000
# the budgeted segmented run with return_radiation_field
MEMORY_TRACKED_POINTS = 250_000
RANGE_SEGMENTS = 3
SERVE_TEFFS = (5777.0, 6300.0, 9000.0)
SERVE_GIANT_TEFF = 4200.0
KERNELS = ("line_opacity", "line_opacity_range", "formal_solution", "formal_solution_inward",
           "line_opacity_grad", "formal_solution_grad", "formal_solution_grad_inward")
# published peaks of an H100 SXM at 700 W (float32 outside the tensor
# cores, HBM3), the bound_ms of each kernel
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# floating-point operations of one in-window Voigt evaluation in Kernel 1,
# counted from csrc/line_opacity.cu by Humlicek region (the shared x, y,
# phi and sum: 8; |x| + y and z^2: 7; then the region's own chain)
VOIGT_FLOPS = {"I": 25, "II": 39, "III": 87, "IV": 134}
# operations of one depth step of one ray in Kernel 2, counted from
# csrc/formal_solution.cu (tau 6, weights 8, the parabolic terms 17,
# the recurrence 6); the inward sweep repeats it per gap
TRACE_STEP_FLOPS = 37
# operations of one in-window evaluation in Kernel 1b, counted from
# csrc/line_opacity_grad.cu by Humlicek region (x, |x| + y, z^2 and the three
# sums: 17; then the region's value-and-derivative chain), and of finishing
# one (model, depth, line) pair (its shuffle tree and three outputs)
GRAD_VOIGT_FLOPS = {"I": 47, "II": 83, "III": 185, "IV": 299}
GRAD_PAIR_FLOPS = 30
# operations of one reverse depth step of one ray in Kernel 2b, counted from
# csrc/formal_solution_grad.cu (step_adjoint 95, tau and the seed 11); the
# inward variant adds a recomputed forward step and a reverse step per gap
TRACE_ADJ_STEP_FLOPS = 106
# phase 13: the fit (examples/fit_stellar_parameters.py with instrumental
# broadening added): parameters (T scale, v sin i [km/s], sigma [px])
FIT_START = (1.0, 5.0, 2.0)
FIT_TRUE = (1.021, 11.0, 3.0)
FIT_STEP_SCALE = (1.0, 300.0, 30.0)  # per-parameter Adam scaling (the example's + sigma)
FIT_LR = 1e-2  # a third of the example's, for five steps
FIT_HALF = 64  # static rotation support [px]: v sin i up to 29 km/s
FIT_RADIUS = 16  # static Gaussian support [px]: sigma up to 4 px
FIT_STEPS = 5
FIT_FD_STEPS = (1e-4, 1e-2, 1e-2)  # central-difference steps per parameter


def log(msg):
    print(msg, flush=True)


def sim100aa_config(model_path):
    return {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": model_path, "final_atomic_number": 30},
        "opacity": {
            "bf": {"H_I": {}},
            "ff": {"H_I": {}},
            "rayleigh": ["H"],
            "disable_electron_scattering": False,
            "line": {
                "disable": False,
                "broadening": ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"],
                "vald_linelist": {"use_linelist": True, "use_vald_broadening": True},
            },
        },
        "no_of_thetas": 20,
        "result_options": {},
    }


def giant_config(model_path, tables, window_mode="reference", coupled=False,
                 molecules=True):
    """The spherical cool giant: Sim100AA's continuum plus Rayleigh H2,
    the three file tables, molecules and molecular lines."""
    cfg = sim100aa_config(model_path)
    cfg["opacity"]["file"] = dict(tables)
    cfg["opacity"]["rayleigh"] = ["H", "H2"]
    cfg["opacity"]["line"].update(include_molecules=molecules, molecules_coupled=coupled,
                                  window_mode=window_mode)
    return cfg


def batch_config(model_path):
    """bench.py's batch workload (VALD broadening: radiation, van der Waals)."""
    cfg = sim100aa_config(model_path)
    cfg["opacity"]["line"]["broadening"] = ["radiation", "van_der_waals"]
    return cfg


def rel_err(ours, ref):
    """max |ours - ref| / |ref| over ref != 0, and whether ours is 0 where
    ref is."""
    nz = ref != 0
    return ((ours - ref).abs()[nz] / ref.abs()[nz]).max().item(), bool((ours[~nz] == 0).all())


def row_err(ours, ref):
    """max over rows (the last axis) of max|ours - ref| / max|ref|, over the
    rows where ref is not all 0, and whether ours is 0 on the other rows."""
    diff = (ours - ref).abs().amax(dim=-1)
    scale = ref.abs().amax(dim=-1)
    nz = scale > 0
    return (diff[nz] / scale[nz]).max().item(), bool((diff[~nz] == 0).all())


def device_busy(torch, fn):
    """(wall s, device-busy s, device ops) of one call of ``fn`` under
    torch.profiler; busy is the union of the card's kernel, copy and memset
    intervals, so busy / wall is the share of the wall the card worked."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return wall, busy_us * 1e-6, len(spans)


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of the operations over the float32
    peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def voigt_evaluations(nus, line_nu, centers, gamma, doppler, iw):
    """In-window Voigt evaluations of Kernel 1 by Humlicek region, for
    one model: nus [N] descending, line_nu / centers [L], gamma, doppler,
    iw [L, D] (host, float64).  A pair (line, depth, pixel) is in window when
    -iw <= p - centre < iw; its region follows from |x| + y (I above 15,
    II above 5.5) and, below 5.5, from y >= 0.195 |x| - 0.176 (III, else
    IV), with x = (nu_p - nu_l) / doppler and y = gamma / (sqrt(pi) pi) /
    doppler.  Pixels within a distance of nu_l are counted by binary search
    on the grid."""
    import numpy as np

    n = len(nus)
    asc = nus[::-1]
    c = centers[:, None]
    lo, hi = np.clip(c - iw, 0, n), np.clip(c + iw, 0, n)  # window [lo, hi)
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


def line_bound(evaluations, n_models, n_lines, n_depth, n_out, itemsize):
    """Kernel 1's bound: the Voigt operations of these evaluations, or
    reading the [B, D, L] line arrays (three floats and the int32 window),
    the lines and the range of the grid once and writing [B, D, n_out]."""
    flops = sum(VOIGT_FLOPS[k] * v for k, v in evaluations.items())
    nbytes = (n_models * n_depth * n_lines * (3 * itemsize + 4) + n_lines * (itemsize + 4)
              + n_out * itemsize + n_models * n_depth * n_out * itemsize)
    return bound(flops, nbytes)


def trace_bound(n_models, n_depth, n_nu, n_theta, itemsize, inward):
    """Kernel 2's bound: the depth steps of every ray (twice with the
    inward sweep) and the theta sum, or reading alpha and source and
    writing F_nu once."""
    rays = n_models * n_nu * n_theta
    flops = rays * (n_depth - 1) * TRACE_STEP_FLOPS * (2 if inward else 1)
    flops += 2 * n_models * n_depth * n_nu * n_theta
    nbytes = 3 * n_models * n_depth * n_nu * itemsize
    return bound(flops, nbytes)


def line_grad_bound(evaluations, n_models, n_lines, n_depth, n_out, itemsize):
    """Kernel 1b's bound: the value-and-derivative operations of Kernel 1's
    in-window evaluations and the per-pair finish, or reading the [B, D, L]
    line arrays (three floats and the int32 window), the lines, the grid's
    range and the incoming gradient [B, D, n_out] once and writing three
    [B, D, L] gradients."""
    pairs = n_models * n_depth * n_lines
    flops = sum(GRAD_VOIGT_FLOPS[k] * v for k, v in evaluations.items()) + GRAD_PAIR_FLOPS * pairs
    nbytes = (pairs * (3 * itemsize + 4) + n_lines * (itemsize + 4) + n_out * itemsize
              + n_models * n_depth * n_out * itemsize + 3 * pairs * itemsize)
    return bound(flops, nbytes)


def trace_grad_bound(n_models, n_depth, n_nu, n_theta, itemsize, inward, with_i):
    """Kernel 2b's bound: the reverse steps of every ray (and, spherical,
    the recomputed and reversed inward sweep) and the theta sums, or
    reading alpha, source, dL/dF_nu, the saved intensity (and dL/dI_nu)
    once and writing the two gradients."""
    rays = n_models * n_nu * n_theta
    per_gap = TRACE_ADJ_STEP_FLOPS + (TRACE_STEP_FLOPS + TRACE_ADJ_STEP_FLOPS if inward else 0)
    flops = rays * (n_depth - 1) * per_gap + 3 * n_models * n_depth * n_nu * n_theta
    cells = n_models * n_depth * n_nu
    nbytes = (5 * cells + cells * n_theta * (2 if with_i else 1)) * itemsize
    return bound(flops, nbytes)


def col_err(ours, ref):
    """row_err over depth for each frequency column of [..., D, N]."""
    return row_err(ours.transpose(-1, -2), ref.transpose(-1, -2))


def norm_err(ours, ref):
    """||ours - ref|| / ||ref||, 2-norms over every element."""
    return ((ours - ref).norm() / ref.norm()).item()


def kernel_device_ms(torch, fn, names):
    """Device milliseconds of one call of ``fn`` spent in the kernels whose
    names contain each of ``names`` (torch.profiler), by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for name in names:
                if name in e.name:
                    out[name] += (e.time_range.end - e.time_range.start) * 1e-3
    return out


def peak_bytes(torch, fn):
    """(peak device bytes allocated by ``fn`` over what was allocated
    before it, fn's result)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, out


def cuda_ms(torch, fn, reps, warm=True):
    """Mean milliseconds per call over ``reps`` calls (CUDA events), after
    one warm-up call unless ``warm`` is False."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from stardis_tpu_torch import _cuda, run_stardis, units as u
    except ImportError as exc:
        print(f"chip_smoke: stardis_tpu_torch not found next to this script ({exc})",
              file=sys.stderr)
        return 1
    from stardis_tpu_torch.atom_data import build_builtin_atom_data
    from stardis_tpu_torch.base import parse_config_to_model
    from stardis_tpu_torch.io.marcs import read_marcs_model
    from stardis_tpu_torch.io.synthetic import write_marcs_file, write_opacity_tables
    from stardis_tpu_torch.opacities import line_kernel as lk
    from stardis_tpu_torch.opacities.lines import synth_linelist, synth_molecule_linelist
    from stardis_tpu_torch.pipeline import (
        build_simulation_plan,
        continuum_batch,
        device_constants,
        prepare_lines,
        run_simulation,
        spectrum_batch,
        stage_plasma_and_lines,
        stage_spectrum,
    )
    from stardis_tpu_torch.radiation_field import solver
    from stardis_tpu_torch.radiation_field.blackbody import blackbody_flux_at_nu

    dev = torch.device("cuda")
    # lets phase 13 run torch's deterministic mode (cuBLAS refuses it without)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []

    # --- 1. the card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # --- 2. build: one nvcc per source, all started together ----------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(_cuda.KERNELS)) as pool:
        builds = {name: pool.submit(_cuda.load, name) for name in _cuda.KERNELS}
        for name, fut in builds.items():
            fut.result()
    log(f"built {len(builds)} kernels in {time.perf_counter() - t0:.1f} s")
    for name in builds:
        for line in _cuda.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name} ptxas {line.strip()}")

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    model_path = os.path.join(tmp.name, "sun.mod")
    write_marcs_file(model_path)
    lams = np.arange(*SIM100AA_LAMBDA)
    lam_q = u.Quantity(lams, u.AA)
    nus = lam_q.to(u.Hz, u.spectral()).value

    def sim100aa_plan(n_lines):
        adata = synth_linelist(build_builtin_atom_data(30, include_linelists=True), n_lines)
        config, adata, model = parse_config_to_model(
            sim100aa_config(model_path), atom_data=adata
        )
        return build_simulation_plan(config, adata, model, nus)

    t0 = time.perf_counter()
    plan = sim100aa_plan(N_LINES)
    log(f"Sim100AA plan: {plan.line_data.n_lines} of {N_LINES} lines in the window, "
        f"{len(plan.tracing_nus)} lambda, {len(plan.temperatures)} depths, "
        f"{len(plan.weights)} theta; host plan {time.perf_counter() - t0:.2f} s")

    def line_inputs(dtype, line_idx=None):
        temps = torch.as_tensor(plan.temperatures, device=dev).to(dtype)
        n_elem = torch.as_tensor(plan.n_elem, device=dev).to(dtype)
        _, quants = stage_plasma_and_lines(plan, temps, n_elem,
                                           device_constants(plan, dtype, dev))
        alpha, gamma, doppler = quants["atomic"]
        nu_ref = float(plan.tracing_nus[len(plan.tracing_nus) // 2])
        line_nu = plan.line_data.nu
        centers = lk.line_center_indices(plan.tracing_nus, line_nu)
        if line_idx is not None:
            idx = torch.as_tensor(line_idx, device=dev)
            alpha, gamma, doppler = alpha[idx], gamma[idx], doppler[idx]
            line_nu, centers = line_nu[line_idx], centers[line_idx]
        grid = torch.as_tensor(plan.tracing_nus - nu_ref, device=dev).to(dtype)
        args = (grid, torch.as_tensor(line_nu - nu_ref, device=dev).to(dtype),
                torch.as_tensor(centers, device=dev), alpha, gamma, doppler)
        iw = lk.window_half_widths(alpha, gamma, doppler, plan.d_nu, len(grid))
        return args, iw

    def kernel1(args, iw):
        # Kernel 1 as the main path calls it: layout, then one launch
        return lk.line_opacity_range(lk.prepare_line_opacity(*args, iw))

    report = {}

    def check_trace_grad(label, a, s, r, w, corr, inward, timed):
        """Kernel 2b against autograd of raytrace_plain on one model's
        [D, N] inputs a, s (rays r [G, T]), with a seeded normal dL/dF_nu
        and, in a second pass, dL/dI_nu too.  float64: 1e-9 of each
        frequency column's largest gradient (the two sum the weights'
        cancelling terms in other orders, and this gradient is
        ill-conditioned where tau runs through the Taylor regime: one-ulp
        input changes move the float64 gradient of tau-spanning columns by
        ~2e-9 of it); float32: against the float64 gradient, its 2-norm
        error no more than 1.5x the plain version's own float32 error (the
        worst column's error, printed too, swings with the incoming
        gradient's cancellations in both).  Two launches equal bit for
        bit.  Returns the kernel's report entry when ``timed`` (float32)."""
        dtype = a.dtype
        n_depth, n_nu = a.shape
        gen = torch.Generator(dev).manual_seed(5)
        g_f = torch.randn((1, n_depth, n_nu), device=dev, dtype=dtype, generator=gen)
        g_i = torch.randn((1, n_depth, n_nu, len(w)), device=dev, dtype=dtype, generator=gen)
        corr_t = torch.full((1,), 1.0 if corr is None else corr, device=dev, dtype=dtype)
        intensity = solver.raytrace(a, s, r, w, inward_rays=inward, photospheric_correction=corr,
                                    track_individual_intensities=True)[1]
        args = (a[None], s[None], r[None], w, corr_t, intensity[None])
        name = "f64" if dtype == torch.float64 else "f32"
        entry = None

        def plain_of(*t, g_int):
            return solver.raytrace_plain_backward(*t, g_int, inward_rays=inward,
                                                  photospheric_correction=corr)

        for with_i in (False, True):
            gi = g_i if with_i else None
            kern = solver.raytrace_grad_cuda(*args, g_f, gi, inward)
            again = solver.raytrace_grad_cuda(*args, g_f, gi, inward)
            plain = plain_of(a, s, r, w, g_f[0], g_int=None if gi is None else gi[0])
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(kern, again))
            errs = [col_err(k[0], p)[0] for k, p in zip(kern, plain)]
            if dtype == torch.float64:
                ok = max(errs) <= 1e-9
                detail = f"max column err / column max {errs[0]:.3e}, {errs[1]:.3e} (bound 1e-9)"
            else:
                exact = plain_of(a.double(), s.double(), r.double(), w.double(), g_f[0].double(),
                                 g_int=None if gi is None else gi[0].double())
                k_err = [norm_err(k[0].double(), e) for k, e in zip(kern, exact)]
                p_err = [norm_err(p.double(), e) for p, e in zip(plain, exact)]
                k_col = [col_err(k[0].double(), e)[0] for k, e in zip(kern, exact)]
                p_col = [col_err(p.double(), e)[0] for p, e in zip(plain, exact)]
                ok = all(ke <= 1.5 * pe for ke, pe in zip(k_err, p_err))
                detail = (f"kernel vs plain {errs[0]:.3e}, {errs[1]:.3e} of the column max; "
                          f"2-norm error against float64: kernel {k_err[0]:.3e}, {k_err[1]:.3e}, "
                          f"plain {p_err[0]:.3e}, {p_err[1]:.3e} (bound 1.5x plain); worst "
                          f"column: kernel {k_col[0]:.3e}, {k_col[1]:.3e}, plain {p_col[0]:.3e}, "
                          f"{p_col[1]:.3e}")
            log(f"kernel 2b {'inward ' if inward else ''}{name} ({label}, "
                f"{'dF and dI' if with_i else 'dF'}): d/dalpha, d/dsource {detail}; two "
                f"launches equal bit for bit: {same}")
            if not (ok and same):
                failures.append(f"kernel 2b {label} {name} with_i={with_i}: {detail}, same {same}")
            if timed and not with_i and dtype == torch.float32:
                err = max((k[0] - p).abs().max().item() for k, p in zip(kern, plain))
                ms = cuda_ms(torch, lambda: solver.raytrace_grad_cuda(*args, g_f, None, inward), 20)
                plain_ms = cuda_ms(torch, lambda: plain_of(a, s, r, w, g_f[0], g_int=None), 3)
                bound_ms, bound_by = trace_grad_bound(1, n_depth, n_nu, len(w), 4, inward, False)
                log(f"kernel 2b {'inward ' if inward else ''}f32 ({label}): kernel {ms:.3f} ms, "
                    f"plain {plain_ms:.3f} ms, max abs err {err:.3e}; bound {bound_ms:.4f} ms "
                    f"({bound_by})")
                entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        return entry

    # --- 3. Kernel 1 against its plain version -----------------------------
    try:
        n_all = plan.line_data.n_lines
        subset = torch.linspace(0, n_all - 1, N_LINES_KERNEL_CHECK).round().long().unique()
        for dtype in (torch.float64, torch.float32):
            args, iw = line_inputs(dtype, subset.numpy())
            kern = kernel1(args, iw)
            plain = lk.accumulate_line_opacity_plain(*args, iw)
            torch.cuda.synchronize()
            if dtype == torch.float64:
                rel = ((kern - plain).abs() / plain.abs().clamp_min(1e-300)).max().item()
                log(f"kernel 1 f64 vs plain ({len(subset)} lines x 56 x 10k): "
                    f"max rel err {rel:.3e} (bound 1e-12)")
                if not rel <= 1e-12:
                    failures.append(f"kernel 1 f64 rel err {rel:.3e}")
            else:
                row, rows_ok = row_err(kern, plain)
                log(f"kernel 1 f32 vs plain ({len(subset)} lines x 56 x 10k): "
                    f"max row err / row max {row:.3e} (bound 1e-5)")
                if not (row <= 1e-5 and rows_ok):
                    failures.append(f"kernel 1 f32 row err {row:.3e}")
        # times at the main path's shape (all lines in the window, float32)
        args, iw = line_inputs(torch.float32)
        kern = kernel1(args, iw)
        t_plain0 = time.perf_counter()
        plain = lk.accumulate_line_opacity_plain(*args, iw)
        torch.cuda.synchronize()
        plain_first_s = time.perf_counter() - t_plain0
        err = (kern - plain).abs().max().item()
        row, rows_ok = row_err(kern, plain)
        ms = cuda_ms(torch, lambda: kernel1(args, iw), 5)
        plain_ms = cuda_ms(torch, lambda: lk.accumulate_line_opacity_plain(*args, iw), 1)
        # float32 sums of ~48k lines in two orders (the kernel serially per
        # pixel, the plain version chunk by chunk) differ by ~sqrt(L) ulp of
        # the row maximum; the bound allows 1e-4 of it
        log(f"kernel 1 f32 full slice ({n_all} lines x 56 x 10k): kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms (first plain call {plain_first_s:.2f} s), "
            f"max abs err {err:.3e}, max row err / row max {row:.3e} (bound 1e-4)")
        if not (row <= 1e-4 and rows_ok):
            failures.append(f"kernel 1 f32 full-slice row err {row:.3e}")
        evals = voigt_evaluations(
            plan.tracing_nus, plan.line_data.nu, lk.line_center_indices(
                plan.tracing_nus, plan.line_data.nu),
            args[4].double().cpu().numpy(), args[5].double().cpu().numpy(),
            iw.cpu().numpy())
        bound_ms, bound_by = line_bound(evals, 1, n_all, iw.shape[1], len(plan.tracing_nus), 4)
        log(f"kernel 1 in-window evaluations by Voigt region: {evals}; bound {bound_ms:.3f} ms "
            f"({bound_by})")
        report["line_opacity"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": bound_ms, "bound_by": bound_by,
                                  "library_ms": None}
        del args, iw, kern, plain
    except Exception as exc:  # noqa: BLE001 - report every phase
        failures.append(f"kernel 1 phase: {exc!r}")

    # --- 3b. Kernel 1b (the line sum's backward) against its plain version ---
    try:
        n_all = plan.line_data.n_lines
        subset = torch.linspace(0, n_all - 1, N_LINES_KERNEL_CHECK).round().long().unique()
        for dtype in (torch.float64, torch.float32):
            args, iw = line_inputs(dtype, subset.numpy() if dtype == torch.float64 else None)
            prep = lk.prepare_line_opacity(*args, iw)
            n_lines, n_depth = iw.shape
            n_nu = len(plan.tracing_nus)
            g = torch.randn((1, n_depth, n_nu), device=dev, dtype=dtype,
                            generator=torch.Generator(dev).manual_seed(4))
            kern = lk.accumulate_line_opacity_grad_cuda(prep, g, 0, n_nu)
            again = lk.accumulate_line_opacity_grad_cuda(prep, g, 0, n_nu)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(kern, again))
            start_ev = torch.cuda.Event(enable_timing=True)
            end_ev = torch.cuda.Event(enable_timing=True)
            start_ev.record()
            plain = lk.accumulate_line_opacity_plain_backward(g[0], *args, iw)
            end_ev.record()
            torch.cuda.synchronize()
            plain_ms = start_ev.elapsed_time(end_ev)  # one call, CUDA events
            errs = [row_err(k[0], p.T) for k, p in zip(kern, plain)]
            worst = max(e for e, _ in errs)
            rows_ok = all(ok for _, ok in errs)
            name = "f64" if dtype == torch.float64 else "f32"
            # float64 rounds each of the two sums on its own order; in float32
            # a deep (line, depth) pair sums up to 10k mixed-sign terms in 32
            # lane-strided partial sums and a shuffle tree, the plain version
            # chunk by chunk: ~sqrt(10k) ulp of the summands, bound 1e-4 of
            # the depth's largest gradient
            row_bound = 1e-12 if dtype == torch.float64 else 1e-4
            log(f"kernel 1b {name} vs plain ({n_lines} lines x {n_depth} x {n_nu // 1000}k): max "
                f"row err / row max d/dalpha {errs[0][0]:.3e}, d/dgamma {errs[1][0]:.3e}, "
                f"d/ddoppler {errs[2][0]:.3e} (bound {row_bound:g}); two launches equal bit for "
                f"bit: {same}; plain {plain_ms:.0f} ms")
            if not (worst <= row_bound and rows_ok and same):
                failures.append(f"kernel 1b {name} row err {worst:.3e}, same {same}")
            if dtype == torch.float32:
                err = max((k[0] - p.T).abs().max().item() for k, p in zip(kern, plain))
                ms = cuda_ms(torch, lambda: lk.accumulate_line_opacity_grad_cuda(prep, g, 0, n_nu), 5)
                evals = voigt_evaluations(
                    plan.tracing_nus, plan.line_data.nu,
                    lk.line_center_indices(plan.tracing_nus, plan.line_data.nu),
                    args[4].double().cpu().numpy(), args[5].double().cpu().numpy(),
                    iw.cpu().numpy())
                bound_ms, bound_by = line_grad_bound(evals, 1, n_lines, n_depth, n_nu, 4)
                log(f"kernel 1b f32 full slice: kernel {ms:.3f} ms, plain {plain_ms:.0f} ms (one "
                    f"call), max abs err {err:.3e}; bound {bound_ms:.3f} ms ({bound_by})")
                report["line_opacity_grad"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                               "bound_ms": bound_ms, "bound_by": bound_by,
                                               "library_ms": None}
                # the per-depth widest window of prepare_line_opacity (the JAX
                # package's block-max windows, line_kernel.py:221, :265): one
                # torch amax over [B, D, L] int32, bound by its bytes
                amax_ms = cuda_ms(torch, lambda: prep.iw.amax(dim=2), 20)
                amax_bytes = (prep.iw.numel() + prep.iw_max.numel()) * 4
                log(f"block-max windows (torch amax over {list(prep.iw.shape)} int32): "
                    f"{amax_ms:.4f} ms; bound {amax_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms (bytes)")
            del args, iw, prep, kern, again, plain
    except Exception as exc:  # noqa: BLE001
        failures.append(f"kernel 1b phase: {exc!r}")

    # --- 4. Kernel 2 against its plain version -----------------------------
    try:
        for dtype in (torch.float64, torch.float32):
            f_nu, total, _, _, state = run_simulation(plan, device=dev, dtype=dtype)
            source = blackbody_flux_at_nu(
                torch.as_tensor(plan.tracing_nus, device=dev).to(dtype), state.t
            )
            ray = torch.as_tensor(plan.ray_distances, device=dev).to(dtype)
            w = torch.as_tensor(plan.weights, device=dev).to(dtype)
            fk, ik = solver.raytrace(total, source, ray, w, track_individual_intensities=True)
            fp, ip = solver.raytrace_plain(total, source, ray, w,
                                           track_individual_intensities=True)
            torch.cuda.synchronize()
            nz = fp != 0
            rel = ((fk - fp).abs()[nz] / fp.abs()[nz]).max().item()
            rel_i = ((ik - ip).abs()[ip != 0] / ip.abs()[ip != 0]).max().item()
            bound = 1e-12 if dtype == torch.float64 else 1e-5
            name = "f64" if dtype == torch.float64 else "f32"
            log(f"kernel 2 {name} vs plain (56 x 10k x 20): max rel err F_nu {rel:.3e}, "
                f"I_nu {rel_i:.3e} (bound {bound:g})")
            if not (rel <= bound and rel_i <= bound and bool((fk[~nz] == 0).all())):
                failures.append(f"kernel 2 {name} rel err {rel:.3e} / {rel_i:.3e}")
            if dtype == torch.float32:
                err = (fk - fp).abs().max().item()
                ms = cuda_ms(torch, lambda: solver.raytrace(total, source, ray, w), 20)
                plain_ms = cuda_ms(torch, lambda: solver.raytrace_plain(total, source, ray, w), 5)
                bound_ms, bound_by = trace_bound(1, *total.shape, len(plan.weights), 4, False)
                log(f"kernel 2 f32 full slice: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                    f"max abs err {err:.3e}; bound {bound_ms:.4f} ms ({bound_by})")
                report["formal_solution"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                             "bound_ms": bound_ms, "bound_by": bound_by,
                                             "library_ms": None}
    except Exception as exc:  # noqa: BLE001
        failures.append(f"kernel 2 phase: {exc!r}")

    # --- 4b. Kernel 2b (the formal solution's backward) against its plain version
    try:
        for dtype in (torch.float64, torch.float32):
            _, total, _, _, state = run_simulation(plan, device=dev, dtype=dtype)
            source = blackbody_flux_at_nu(
                torch.as_tensor(plan.tracing_nus, device=dev).to(dtype), state.t)
            ray = torch.as_tensor(plan.ray_distances, device=dev).to(dtype)
            w = torch.as_tensor(plan.weights, device=dev).to(dtype)
            entry = check_trace_grad("Sim100AA 56 x 10k x 20", total, source, ray, w, None,
                                     False, True)
            if entry:
                report["formal_solution_grad"] = entry
            del total, source, state
    except Exception as exc:  # noqa: BLE001
        failures.append(f"kernel 2b phase: {exc!r}")

    # launch counts of each main path: set to 0 just before it, read just after
    counters = {
        "line_opacity": (lk.accumulate_line_opacity_cuda, "launches"),
        "line_opacity_range": (lk.accumulate_line_opacity_cuda, "range_launches"),
        "formal_solution": (solver.raytrace_cuda, "launches"),
        "formal_solution_inward": (solver.raytrace_cuda, "inward_launches"),
        "line_opacity_grad": (lk.accumulate_line_opacity_grad_cuda, "launches"),
        "formal_solution_grad": (solver.raytrace_grad_cuda, "launches"),
        "formal_solution_grad_inward": (solver.raytrace_grad_cuda, "inward_launches"),
    }

    def reset_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read_counts():
        return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}

    path_launches = {}

    # --- 5. the slice through run_stardis ----------------------------------
    try:
        cfg = sim100aa_config(model_path)

        def slice_run():
            adata = synth_linelist(build_builtin_atom_data(30, include_linelists=True), N_LINES)
            out = run_stardis(cfg, lam_q, device="cuda", dtype=torch.float32, atom_data=adata)
            torch.cuda.synchronize()
            return out

        slice_run()  # first call: allocator and library warm-up
        reset_counts()
        t0 = time.perf_counter()
        out = slice_run()
        wall = time.perf_counter() - t0
        launches = path_launches["Sim100AA"] = read_counts()
        spec = out.spectrum_nu.value
        log(f"slice: run_stardis(device='cuda', float32), {N_LINES} lines: warm wall "
            f"{wall:.3f} s; launches {launches}; F_nu[surface] shape {spec.shape}, "
            f"min {spec.min():.4e}, max {spec.max():.4e}")
        if not (spec.shape == (len(lams),) and (spec > 0).all() and
                torch.isfinite(torch.as_tensor(spec)).all()):
            failures.append("slice F_nu not finite and positive")
        if launches["line_opacity"] < 1 or launches["formal_solution"] < 1:
            failures.append(f"a kernel was not launched by the slice: {launches}")
        p_wall, busy, ops = device_busy(torch, slice_run)
        log(f"slice profiled run: wall {p_wall:.4f} s, device busy {busy * 1e3:.2f} ms "
            f"({busy / p_wall:.1%} of the wall), {ops} device ops")

        timings = {}
        run_simulation(plan, device=dev, dtype=torch.float32, timings=timings)
        log("slice device stages (s, synchronised): "
            + ", ".join(f"{k} {v:.4f}" for k, v in timings.items()))

        acc_cfg = copy.deepcopy(cfg)
        acc_cfg["opacity"]["line"]["window_mode"] = "accuracy"
        adata = synth_linelist(build_builtin_atom_data(30, include_linelists=True), N_LINES)
        t0 = time.perf_counter()
        spec_acc = run_stardis(acc_cfg, lam_q, device="cuda", dtype=torch.float32,
                               atom_data=adata).spectrum_nu.value
        log(f"slice accuracy windows (eps 1e-4): wall {time.perf_counter() - t0:.3f} s; "
            f"max|dF/F| against reference windows at the surface "
            f"{float(np.abs(spec_acc / spec - 1.0).max()):.3e}")

        plan10k = sim100aa_plan(N_LINES_PLAIN_CHECK)
        fk = run_simulation(plan10k, device=dev, dtype=torch.float32)[0]
        fp = run_simulation(plan10k, device=dev, dtype=torch.float32, plain=True)[0]
        torch.cuda.synchronize()
        rel, zeros_ok = rel_err(fk, fp)
        log(f"slice at {N_LINES_PLAIN_CHECK} lines: kernel path vs all-plain path F_nu "
            f"max rel err {rel:.3e} (bound 1e-4)")
        if not (rel <= 1e-4 and zeros_ok and torch.isfinite(fk).all()):
            failures.append(f"slice kernel vs plain rel err {rel:.3e}")
    except Exception as exc:  # noqa: BLE001
        failures.append(f"slice phase: {exc!r}")


    # --- the spherical cool giant ------------------------------------------
    giant_path = os.path.join(tmp.name, "giant.mod")
    write_marcs_file(giant_path, **GIANT)
    tables = write_opacity_tables(tmp.name)

    def giant_atom_data(n_lines, n_mol_lines):
        adata = build_builtin_atom_data(30, include_linelists=True, include_molecules=True)
        synth_linelist(adata, n_lines)
        return synth_molecule_linelist(adata, n_mol_lines)

    def giant_plan(n_lines, n_mol_lines, **kw):
        adata = giant_atom_data(n_lines, n_mol_lines)
        config, adata, model = parse_config_to_model(
            giant_config(giant_path, tables, **kw), atom_data=adata
        )
        return build_simulation_plan(config, adata, model, nus)

    # --- 6. Kernel 2's inward sweep against its plain version --------------
    try:
        t0 = time.perf_counter()
        gplan = giant_plan(N_LINES, GIANT_MOL_LINES)
        log(f"giant plan: {gplan.line_data.n_lines} atomic + "
            f"{gplan.molecule_line_data.n_lines} molecular lines in the window, "
            f"{len(gplan.temperatures)} depths, {len(gplan.weights)} theta, correction "
            f"{gplan.photospheric_correction:.6f}; host plan {time.perf_counter() - t0:.2f} s")
        # the giant's atmosphere is 1.25 % of its radius, so no chord misses
        # a shell; thickened 5x, the outer chords miss the inner shells
        radii = np.asarray(read_marcs_model(giant_path).to_stellar_model(
            build_builtin_atom_data(30), final_atomic_number=30).geometry.r)
        radii = radii[-1] - 5.0 * (radii[-1] - radii)
        thetas, _ = solver.gauss_legendre_thetas(len(gplan.weights))
        chords = solver.calculate_spherical_ray(thetas, radii)
        n_zero = int((chords == 0).sum())
        log(f"inward-sweep rays: the giant's shells thickened 5x, {n_zero} of "
            f"{chords.size} chord lengths 0")
        if not (gplan.inward_rays and n_zero > 0):
            failures.append("giant: expected spherical rays and zero chords")
        corr = gplan.photospheric_correction
        total = run_simulation(gplan, device=dev, dtype=torch.float64)[1]
        temps = torch.as_tensor(gplan.temperatures, device=dev)
        grid = torch.as_tensor(gplan.tracing_nus, device=dev)
        ray = torch.as_tensor(chords, device=dev)
        # the giant's surface is optically thick at every pixel, where every
        # gap is saturated, and isothermal, so source[G] = source[G-1] and the
        # gap-0 wrap reads the same value either way.  The 'spanning' inputs
        # scale each frequency column by 10^0 .. 10^-K (K from the largest
        # tau), so that the per-gap tau spans all three weight regimes, and
        # take the source of the temperatures plus a 2 % ramp to the centre,
        # so that no two depths share a source value
        taus = solver.compute_taus(total[None], ray.T)  # [T, G, N]
        decades = float(torch.log10(taus.max())) + INWARD_MIN_DECADES
        scale = torch.logspace(0.0, -decades, total.shape[1], device=dev, dtype=total.dtype)
        ramp = 1.0 + 0.02 * torch.linspace(1.0, 0.0, len(temps), device=dev, dtype=temps.dtype)
        inputs = {
            "giant": (total, blackbody_flux_at_nu(grid, temps)),
            "spanning": (total * scale, blackbody_flux_at_nu(grid, temps * ramp)),
        }
        taus = taus * scale
        nonzero = taus > 0
        shares = {
            "taylor": ((taus < solver.TAU_TAYLOR) & nonzero).sum().item(),
            "middle": ((taus >= solver.TAU_TAYLOR) & (taus < solver.TAU_SATURATED)).sum().item(),
            "saturated": (taus >= solver.TAU_SATURATED).sum().item(),
        }
        # gaps whose step the zero test skips because tau[g-1] = 0 alone
        skip_lower = ((taus[:, 1:] > 0) & (taus[:, :-1] == 0)).sum().item()
        # rays whose gap-0 step runs, reading the wrapped tau[G-1], source[G]
        wrap = (nonzero[:, 0] & nonzero[:, -1]).sum().item()
        n_gaps = nonzero.sum().item()
        top_differs = bool((inputs["spanning"][1][-1] != inputs["spanning"][1][-2]).all())
        log(f"inward-sweep inputs 'spanning': columns scaled by 10^0 .. 10^-{decades:.1f}; "
            "nonzero gaps by weight regime: "
            + ", ".join(f"{k} {v} ({v / n_gaps:.1%})" for k, v in shares.items())
            + f"; {skip_lower} gaps after a zero chord; {wrap} rays through the gap-0 wrap; "
            f"source[G] != source[G-1] at every frequency: {top_differs}")
        if not (min(shares.values()) >= 0.01 * n_gaps and skip_lower > 0 and wrap > 0
                and top_differs):
            failures.append(f"inward-sweep inputs miss a regime or branch: {shares}")
        del taus, nonzero
        kw = {"inward_rays": True, "photospheric_correction": corr}
        f32_errs = []
        for dtype in (torch.float64, torch.float32):
            w = torch.as_tensor(gplan.weights, device=dev).to(dtype)
            bound = 1e-12 if dtype == torch.float64 else 1e-5
            name = "f64" if dtype == torch.float64 else "f32"
            for label, (alphas, source) in inputs.items():
                a, s, r = alphas.to(dtype), source.to(dtype), ray.to(dtype)
                fk, ik = solver.raytrace(a, s, r, w, track_individual_intensities=True, **kw)
                fp, ip = solver.raytrace_plain(a, s, r, w, track_individual_intensities=True,
                                               **kw)
                torch.cuda.synchronize()
                rel, f_zeros = rel_err(fk, fp)
                rel_i, i_zeros = rel_err(ik, ip)
                log(f"kernel 2 inward {name} vs plain (56 x 10k x 20, spherical, {label}): "
                    f"max rel err F_nu {rel:.3e}, I_nu {rel_i:.3e} (bound {bound:g}); "
                    f"max abs err I_nu {(ik - ip).abs().max().item():.3e}")
                if not (rel <= bound and rel_i <= bound and f_zeros and i_zeros):
                    failures.append(f"kernel 2 inward {name} {label} rel err "
                                    f"{rel:.3e} / {rel_i:.3e}")
                if dtype == torch.float32:
                    f32_errs.append((fk - fp).abs().max().item())
                if dtype == torch.float32 and label == "giant":
                    ms = cuda_ms(torch, lambda: solver.raytrace(a, s, r, w, **kw), 20)
                    plain_ms = cuda_ms(
                        torch, lambda: solver.raytrace_plain(a, s, r, w, **kw), 5
                    )
                    bound_ms, bound_by = trace_bound(1, *a.shape, len(gplan.weights), 4, True)
                    log(f"kernel 2 inward f32 giant: kernel {ms:.3f} ms, "
                        f"plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by})")
                entry = check_trace_grad(f"giant {label}", a, s, r, w, corr, True,
                                         label == "giant")
                if entry:
                    report["formal_solution_grad_inward"] = entry
                del fk, ik, fp, ip
        del inputs, total, source
        report["formal_solution_inward"] = {
            "max_abs_err": max(f32_errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        }
    except Exception as exc:  # noqa: BLE001
        failures.append(f"inward sweep phase: {exc!r}")

    # --- 7. the giant through run_stardis ----------------------------------
    try:
        def giant_run(**kw):
            adata = giant_atom_data(N_LINES, GIANT_MOL_LINES)
            out = run_stardis(giant_config(giant_path, tables, **kw), lam_q, device="cuda",
                              dtype=torch.float32, atom_data=adata)
            torch.cuda.synchronize()
            return out

        giant_run()  # warm-up
        reset_counts()
        t0 = time.perf_counter()
        out = giant_run()
        wall = time.perf_counter() - t0
        launches = path_launches["giant"] = read_counts()
        spec_ref = out.spectrum_nu.value
        log(f"giant: run_stardis(device='cuda', float32), {N_LINES} atomic + "
            f"{GIANT_MOL_LINES} molecular lines, 3 file tables: warm wall {wall:.3f} s; "
            f"launches {launches}; F_nu[surface] min {spec_ref.min():.4e}, "
            f"max {spec_ref.max():.4e}")
        if not (spec_ref.shape == (len(lams),) and (spec_ref > 0).all() and
                np.isfinite(spec_ref).all()):
            failures.append("giant F_nu not finite and positive")
        if launches["line_opacity"] != 2 or launches["formal_solution_inward"] != 1:
            failures.append(f"giant: expected 2 line-opacity and 1 inward launches: {launches}")
        p_wall, busy, ops = device_busy(torch, giant_run)
        log(f"giant profiled run: wall {p_wall:.4f} s, device busy {busy * 1e3:.2f} ms "
            f"({busy / p_wall:.1%} of the wall), {ops} device ops")

        timings = {}
        run_simulation(gplan, device=dev, dtype=torch.float32, timings=timings)
        log("giant device stages (s, synchronised): "
            + ", ".join(f"{k} {v:.4f}" for k, v in timings.items()))

        torch.backends.cuda.matmul.allow_tf32 = True
        for mode in ("reference", "accuracy"):
            plan_small = giant_plan(N_LINES_PLAIN_CHECK, GIANT_MOL_LINES_PLAIN_CHECK,
                                    window_mode=mode)
            fk, _, ok, _, _ = run_simulation(plan_small, device=dev, dtype=torch.float32)
            fp, _, op, _, _ = run_simulation(plan_small, device=dev, dtype=torch.float32,
                                             plain=True)
            torch.cuda.synchronize()
            rel, zeros_ok = rel_err(fk, fp)
            log(f"giant at {N_LINES_PLAIN_CHECK} + {GIANT_MOL_LINES_PLAIN_CHECK} lines, "
                f"{mode} windows: kernel path vs all-plain path F_nu max rel err "
                f"{rel:.3e} (bound 1e-4)")
            if not (rel <= 1e-4 and zeros_ok and torch.isfinite(fk).all()):
                failures.append(f"giant {mode} kernel vs plain rel err {rel:.3e}")
            # Kernel 1's own output for each line set, held to phase 3's
            # bound for a whole line set in float32
            for key in ("alpha_line_at_nu", "molecule_alpha_line_at_nu"):
                row, rows_ok = row_err(ok[key], op[key])
                log(f"giant {mode} windows: Kernel 1 {key} vs plain [56 x 10k], max row "
                    f"err / row max {row:.3e} (bound 1e-4)")
                if not (row <= 1e-4 and rows_ok):
                    failures.append(f"giant {mode} {key} row err {row:.3e}")
        tf32_kept = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        log(f"TF32 matmul switch after the runs: {tf32_kept} (set True before them)")
        if tf32_kept is not True:
            failures.append("run_simulation changed the process-wide TF32 switch")

        t0 = time.perf_counter()
        spec_acc = giant_run(window_mode="accuracy").spectrum_nu.value
        wall_acc = time.perf_counter() - t0
        d_acc = float(np.abs(spec_acc / spec_ref - 1.0).max())
        log(f"giant accuracy windows (eps 1e-4): wall {wall_acc:.3f} s; max|dF/F| against "
            "reference windows at the surface "
            f"{d_acc:.3e}")

        from stardis_tpu_torch.plasma.molecules import (
            coupled_network_residual,
            molecule_number_density_coupled,
        )

        t0 = time.perf_counter()
        spec_c = giant_run(coupled=True).spectrum_nu.value
        wall_c = time.perf_counter() - t0
        p_wall, busy, ops = device_busy(torch, lambda: giant_run(coupled=True))
        log(f"giant coupled profiled run: wall {p_wall:.4f} s, device busy {busy * 1e3:.2f} ms "
            f"({busy / p_wall:.1%} of the wall), {ops} device ops")
        cplan = giant_plan(N_LINES_PLAIN_CHECK, GIANT_MOL_LINES_PLAIN_CHECK, coupled=True)
        _, _, _, _, state = run_simulation(cplan, device=dev, dtype=torch.float32)
        n_m, x = molecule_number_density_coupled(cplan.molecule_tables, state, return_aux=True)
        resid = coupled_network_residual(cplan.molecule_tables, state, x, n_m).item()
        log(f"giant coupled molecules: wall {wall_c:.3f} s; max|dF/F| against pairwise "
            f"{float(np.abs(spec_c / spec_ref - 1.0).max()):.3e}; float32 conservation "
            f"residual {resid:.3e}")
        if not ((spec_c > 0).all() and np.isfinite(spec_c).all() and np.isfinite(resid)):
            failures.append("giant coupled run not finite and positive")
    except Exception as exc:  # noqa: BLE001
        torch.backends.cuda.matmul.allow_tf32 = False
        failures.append(f"giant phase: {exc!r}")
    gplan = None

    # --- 8. the batch --------------------------------------------------------
    try:
        from stardis_tpu_torch.base import read_stellar_model
        from stardis_tpu_torch.parallel.batch import make_batch, run_batch

        b_lams = np.arange(*BATCH_LAMBDA)
        b_nus = u.Quantity(b_lams, u.AA).to(u.Hz, u.spectral()).value
        paths = []
        for i, teff in enumerate(np.linspace(5000.0, 6500.0, BATCH_MODELS)):
            paths.append(os.path.join(tmp.name, f"batch{i}.mod"))
            write_marcs_file(paths[-1], teff=float(teff))
        b_adata = synth_linelist(build_builtin_atom_data(30, include_linelists=True),
                                 BATCH_LINES, *BATCH_LINE_RANGE)
        b_cfg = batch_config(paths[0])
        config, b_adata, model0 = parse_config_to_model(b_cfg, atom_data=b_adata)
        models = [model0] + [read_stellar_model(config, b_adata, p) for p in paths[1:]]
        bplan, batch = make_batch(config, b_adata, models, b_nus)

        def batch_run(**kw):
            f = run_batch(bplan, batch, device=dev, dtype=torch.float32, **kw)
            torch.cuda.synchronize()
            return f

        batch_run()  # warm-up
        reset_counts()
        f_batch = batch_run()
        launches = path_launches["batch"] = read_counts()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            batch_run()
            walls.append(time.perf_counter() - t0)
        timings = {}
        batch_run(timings=timings)
        wall = sorted(walls)[1]
        log(f"batch: {BATCH_MODELS} models x {bplan.line_data.n_lines} lines x "
            f"{len(b_lams)} lambda x {len(bplan.weights)} theta, float32: run_batch walls "
            + ", ".join(f"{w:.4f}" for w in walls)
            + f" s; {BATCH_MODELS / wall:.1f} atmospheres/s (median); launches {launches}; "
            "stages (s, synchronised): "
            + ", ".join(f"{k} {v:.4f}" for k, v in timings.items()))
        if launches["line_opacity"] != 1 or launches["formal_solution"] != 1:
            failures.append(f"batch: expected one launch of each kernel: {launches}")
        p_wall, busy, ops = device_busy(torch, batch_run)
        log(f"batch profiled run: wall {p_wall:.4f} s, device busy {busy * 1e3:.2f} ms "
            f"({busy / p_wall:.1%} of the wall), {ops} device ops")
        fp = batch_run(plain=True)
        rel, zeros_ok = rel_err(f_batch, fp)
        log(f"batch kernels vs plain versions: F_nu max rel err {rel:.3e} (bound 1e-4)")
        if not (rel <= 1e-4 and zeros_ok and torch.isfinite(f_batch).all()):
            failures.append(f"batch kernel vs plain rel err {rel:.3e}")
        # Kernel 1's own [16, D, N] output on the model axis, in both
        # window modes, against its plain version (phase 3's bound)
        temps = torch.as_tensor(batch.temperatures, device=dev).to(torch.float32)
        n_elem = torch.as_tensor(batch.n_elem, device=dev).to(torch.float32)
        bconsts = device_constants(bplan, torch.float32, dev)
        states, quants = zip(*(stage_plasma_and_lines(bplan, temps[b], n_elem[b], bconsts)
                               for b in range(BATCH_MODELS)))
        for mode in ("reference", "accuracy"):
            mplan = dataclasses.replace(bplan, window_mode=mode)
            ok, op = (spectrum_batch(
                mplan, states, prepare_lines(mplan, states, quants, bconsts, plain=plain),
                bconsts, batch.ray_distances, plain=plain)[2]["alpha_line_at_nu"]
                for plain in (False, True))
            row, rows_ok = row_err(ok, op)
            log(f"batch {mode} windows: Kernel 1 alpha_line_at_nu vs plain "
                f"{list(ok.shape)}, max row err / row max {row:.3e} (bound 1e-4)")
            if not (ok.shape[0] == BATCH_MODELS and row <= 1e-4 and rows_ok):
                failures.append(f"batch {mode} alpha_line_at_nu row err {row:.3e}")
        del states, quants, ok, op, bconsts
        worst = 0.0
        for i, path in enumerate(paths):
            cfg_i = copy.deepcopy(b_cfg)
            cfg_i["input_model"]["fname"] = path
            spec = run_stardis(cfg_i, u.Quantity(b_lams, u.AA), device="cuda",
                               dtype=torch.float32, atom_data=b_adata).spectrum_nu.value
            member = f_batch[i, -1].double().cpu().numpy()
            worst = max(worst, float(np.abs(member / spec - 1.0).max()))
        log(f"batch members vs run_stardis of each model: max rel err {worst:.3e} "
            "(bound 1e-5)")
        if not worst <= 1e-5:
            failures.append(f"batch member vs run_stardis rel err {worst:.3e}")

        g_paths, g_models = [], []
        g_adata = synth_linelist(
            build_builtin_atom_data(30, include_linelists=True, include_molecules=True),
            BATCH_LINES, *BATCH_LINE_RANGE,
        )
        for i, (teff, radius) in enumerate(GIANT_BATCH):
            g_paths.append(os.path.join(tmp.name, f"giant{i}.mod"))
            write_marcs_file(g_paths[-1], **{**GIANT, "teff": teff, "radius_cm": radius})
        g_cfg = giant_config(g_paths[0], tables, molecules=False)
        config, g_adata, g0 = parse_config_to_model(g_cfg, atom_data=g_adata)
        g_models = [g0] + [read_stellar_model(config, g_adata, p) for p in g_paths[1:]]
        gb_plan, g_batch = make_batch(config, g_adata, g_models, b_nus)
        fg = run_batch(gb_plan, g_batch, device=dev, dtype=torch.float32)
        worst = 0.0
        for i, path in enumerate(g_paths):
            cfg_i = copy.deepcopy(g_cfg)
            cfg_i["input_model"]["fname"] = path
            spec = run_stardis(cfg_i, u.Quantity(b_lams, u.AA), device="cuda",
                               dtype=torch.float32, atom_data=g_adata).spectrum_nu.value
            worst = max(worst, float(np.abs(fg[i, -1].double().cpu().numpy() / spec - 1).max()))
        corrs = g_batch.photospheric_correction
        log(f"giant batch ({len(g_paths)} spherical members, 3 file tables): corrections "
            + ", ".join(f"{c:.6f}" for c in corrs)
            + f"; members vs run_stardis max rel err {worst:.3e} (bound 1e-5)")
        if not (worst <= 1e-5 and len(np.unique(corrs)) == len(g_paths)):
            failures.append(f"giant batch member vs run_stardis rel err {worst:.3e}")
    except Exception as exc:  # noqa: BLE001
        failures.append(f"batch phase: {exc!r}")

    from stardis_tpu_torch.parallel.sharding import segment_ranges, segmented_spectrum
    from stardis_tpu_torch.util import memory as mem

    def wide_grid(n_points):
        return u.Quantity(np.linspace(*FLAGSHIP_LAMBDA, n_points), u.AA)

    def model_estimate(mplan, k=1):
        """util.memory's peak bytes of a run of this plan in k ranges."""
        n_seg = -(-len(mplan.tracing_nus) // k)
        return (mem.estimate_segment_bytes(n_seg, len(mplan.temperatures), len(mplan.weights),
                                           mem.count_alpha_sources(mplan), 4)
                + mem.fixed_overhead_bytes(mplan, k, 4))

    def check_estimate(label, estimate, peak):
        ratio = estimate / peak
        log(f"memory model, {label}: measured peak {peak / 1e9:.4f} GB, estimate "
            f"{estimate / 1e9:.4f} GB, estimate / peak {ratio:.4f} (bound [1, 1.5])")
        if not 1.0 <= ratio <= 1.5:
            failures.append(f"memory model, {label}: estimate / peak {ratio:.4f}")

    # --- 9. the memory model --------------------------------------------------
    def mem_plan(cfg, adata, lam):
        config, _, model = parse_config_to_model(cfg, atom_data=adata)
        return build_simulation_plan(config, adata, model, lam.to(u.Hz, u.spectral()).value)

    def host(v):
        return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    def max_rel(ours, ref):
        """max |ours - ref| / |ref| over ref != 0 (host arrays); inf where
        ours is not 0 where ref is."""
        nz = ref != 0
        if (ours[~nz] != 0).any():
            return float("inf")
        return float((np.abs(ours - ref)[nz] / np.abs(ref[nz])).max())

    try:
        mem_adata = synth_linelist(build_builtin_atom_data(30, include_linelists=True),
                                   MEMORY_LINES, *FLAGSHIP_LINE_RANGE)
        peaks, spectra = {}, {}
        for n_points in MEMORY_POINTS:
            m_lam = wide_grid(n_points)
            for track in (False, True):
                cfg = sim100aa_config(model_path)
                cfg["result_options"] = {"return_radiation_field": track}
                mplan = mem_plan(cfg, mem_adata, m_lam)
                estimate, n_lines = model_estimate(mplan), mplan.line_data.n_lines
                del mplan
                peak, out = peak_bytes(torch, lambda: run_stardis(
                    cfg, m_lam, device="cuda", dtype=torch.float32, atom_data=mem_adata))
                peaks[n_points, track] = peak
                spectra[n_points, track] = out.spectrum_nu.value
                del out
                check_estimate(f"{n_points} points x {n_lines} lines, "
                               f"return_radiation_field={track}", estimate, peak)
        again = run_stardis(cfg, m_lam, device="cuda", dtype=torch.float32,
                            atom_data=mem_adata).spectrum_nu.value
        log(f"run_stardis at {MEMORY_POINTS[-1]} points twice: F_nu equal bit for bit "
            f"{bool(np.array_equal(again, spectra[MEMORY_POINTS[-1], True]))}")

        # the spherical giant: three file tables (uploaded per source),
        # molecules and a molecular line set, the inward sweep
        g_mem_adata = build_builtin_atom_data(30, include_linelists=True, include_molecules=True)
        synth_linelist(g_mem_adata, MEMORY_LINES, *FLAGSHIP_LINE_RANGE)
        synth_molecule_linelist(g_mem_adata, MEMORY_MOL_LINES, *FLAGSHIP_LINE_RANGE)
        for n_points, track in MEMORY_GIANT_RUNS:
            m_lam = wide_grid(n_points)
            cfg = giant_config(giant_path, tables)
            cfg["result_options"] = {"return_radiation_field": track}
            mplan = mem_plan(cfg, g_mem_adata, m_lam)
            estimate = model_estimate(mplan)
            label = (f"giant, {n_points} points x {mplan.line_data.n_lines} + "
                     f"{mplan.molecule_line_data.n_lines} lines, "
                     f"{len(mplan.file_sources)} file tables, return_radiation_field={track}")
            del mplan
            peak, out = peak_bytes(torch, lambda: run_stardis(
                cfg, m_lam, device="cuda", dtype=torch.float32, atom_data=g_mem_adata))
            spec = out.spectrum_nu.value
            del out
            if not (np.isfinite(spec).all() and (spec > 0).all()):
                failures.append(f"memory model, {label}: F_nu not finite and positive")
            check_estimate(label, estimate, peak)

        budget = int(MEMORY_BUDGET_SHARE * peaks[MEMORY_POINTS[-1], False])
        m_lam = wide_grid(MEMORY_POINTS[-1])
        cfg = sim100aa_config(model_path)
        mplan = mem_plan(cfg, mem_adata, m_lam)
        os.environ["STARDIS_SEGMENT_BUDGET"] = str(budget)
        try:
            k = mem.choose_nu_segments(mplan, itemsize=4)
            reset_counts()
            peak, out = peak_bytes(torch, lambda: run_stardis(
                cfg, m_lam, device="cuda", dtype=torch.float32, atom_data=mem_adata,
                nu_segments="auto"))
            launches = path_launches["budgeted auto segments"] = read_counts()
        finally:
            del os.environ["STARDIS_SEGMENT_BUDGET"]
        ref = spectra[MEMORY_POINTS[-1], False]
        rel = float(np.abs(out.spectrum_nu.value / ref - 1.0).max())
        log(f"memory budget {budget / 1e9:.4f} GB ({MEMORY_BUDGET_SHARE:.0%} of the unsegmented "
            f"peak): nu_segments='auto' chose K = {k}; measured peak {peak / 1e9:.4f} GB; "
            f"launches {launches}; F_nu against the unsegmented run max rel err {rel:.3e} "
            "(bound 1e-6)")
        if not (k > 1 and peak < budget and launches["line_opacity_range"] == k
                and rel <= 1e-6):
            failures.append(f"budgeted auto segments: K {k}, peak {peak}, budget {budget}, "
                            f"rel err {rel:.3e}")
        check_estimate(f"budgeted, K = {k}", model_estimate(mplan, k), peak)
        del out, spectra, mplan

        # K > 1 with return_radiation_field: I_nu preallocated on the card,
        # the opacities streamed to the host range by range; the budget is
        # the unsegmented tracked run's measured peak
        n_t = MEMORY_TRACKED_POINTS
        m_lam = wide_grid(n_t)
        cfg = sim100aa_config(model_path)
        cfg["result_options"] = {"return_radiation_field": True}
        whole = run_stardis(cfg, m_lam, device="cuda", dtype=torch.float32,
                            atom_data=mem_adata).stellar_radiation_field
        ref = {"F_nu": host(whole.F_nu), "I_nu": host(whole.I_nus),
               "total": host(whole.opacities.total_alphas),
               **{key: host(v) for key, v in whole.opacities.opacities_dict.items()}}
        del whole
        budget = peaks[n_t, True]
        mplan = mem_plan(cfg, mem_adata, m_lam)
        k = mem.choose_nu_segments(mplan, budget, itemsize=4)
        os.environ["STARDIS_SEGMENT_BUDGET"] = str(budget)
        try:
            reset_counts()
            peak, out = peak_bytes(torch, lambda: run_stardis(
                cfg, m_lam, device="cuda", dtype=torch.float32, atom_data=mem_adata,
                nu_segments="auto"))
            launches = path_launches["budgeted auto segments, I_nu"] = read_counts()
        finally:
            del os.environ["STARDIS_SEGMENT_BUDGET"]
        parts = out.stellar_radiation_field
        ours = {"F_nu": host(parts.F_nu), "I_nu": host(parts.I_nus),
                "total": host(parts.opacities.total_alphas),
                **{key: host(v) for key, v in parts.opacities.opacities_dict.items()}}
        del out, parts
        errs = {key: max_rel(ours[key], v) for key, v in ref.items() if key in ours}
        worst = max(errs.values())
        log(f"memory budget {budget / 1e9:.4f} GB (the unsegmented peak), {n_t} points, "
            f"return_radiation_field=True: nu_segments='auto' chose K = {k}; measured peak "
            f"{peak / 1e9:.4f} GB; launches {launches}; {len(errs)} arrays (F_nu, I_nu, total, "
            f"each opacity) against the unsegmented run: max rel err {worst:.3e}, equal bit "
            f"for bit {all(np.array_equal(ours[key], ref[key]) for key in errs)} (bound 1e-6)")
        if not (k > 1 and peak < budget and launches["line_opacity_range"] == k
                and set(ours) == set(ref) and worst <= 1e-6):
            failures.append(f"budgeted tracked segments: K {k}, peak {peak}, budget {budget}, "
                            f"keys {sorted(ours)}, rel err {worst:.3e}")
        check_estimate(f"budgeted, return_radiation_field=True, K = {k}",
                       model_estimate(mplan, k), peak)
        del ref, ours, mplan
    except Exception as exc:  # noqa: BLE001
        failures.append(f"memory model phase: {exc!r}")

    # --- 10. Kernel 1's range launch, then the flagship -------------------------
    try:
        ranges = segment_ranges(len(plan.tracing_nus), RANGE_SEGMENTS)
        for dtype in (torch.float64, torch.float32):
            args, iw = line_inputs(dtype)
            prepared = lk.prepare_line_opacity(*args, iw)
            full = lk.line_opacity_range(prepared)

            def range_launches():
                return [lk.line_opacity_range(prepared, a, b - a) for a, b in ranges]

            def plain_ranges():
                return [lk.accumulate_line_opacity_plain(*args, iw, p_begin=a, n_out=b - a)
                        for a, b in ranges]

            parts = torch.cat(range_launches(), dim=1)
            torch.cuda.synchronize()
            same = torch.equal(parts, full)
            name = "f64" if dtype == torch.float64 else "f32"
            log(f"kernel 1 range launch {name}: {len(ranges)} ranges "
                f"{[b - a for a, b in ranges]} of {len(plan.tracing_nus)} pixels x "
                f"{plan.line_data.n_lines} lines == the full launch bit for bit: {same}")
            if not same:
                failures.append(f"kernel 1 range launch {name} differs from the full launch")
            if dtype == torch.float64:
                plain = torch.cat(plain_ranges(), dim=1)
                rel = ((parts - plain).abs() / plain.abs().clamp_min(1e-300)).max().item()
                log(f"kernel 1 range launch f64 vs plain ranges: max rel err {rel:.3e} "
                    "(bound 1e-12)")
                if not rel <= 1e-12:
                    failures.append(f"kernel 1 range launch f64 rel err {rel:.3e}")
            else:
                ms = cuda_ms(torch, range_launches, 5)
                t_plain = time.perf_counter()
                plain = torch.cat(plain_ranges(), dim=1)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t_plain) * 1e3
                err = (parts - plain).abs().max().item()
                row, rows_ok = row_err(parts, plain)
                log(f"kernel 1 range launch f32: {len(ranges)} ranges {ms:.3f} ms together, "
                    f"plain {plain_ms:.1f} ms; max abs err {err:.3e}, max row err / row max "
                    f"{row:.3e} (bound 1e-4); bound as the full launch "
                    f"{report['line_opacity']['bound_ms']:.3f} ms")
                if not (row <= 1e-4 and rows_ok):
                    failures.append(f"kernel 1 range launch f32 row err {row:.3e}")
                report["line_opacity_range"] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": report["line_opacity"]["bound_ms"],
                    "bound_by": report["line_opacity"]["bound_by"], "library_ms": None,
                }
            del args, iw, prepared, full, parts, plain
    except Exception as exc:  # noqa: BLE001
        failures.append(f"range launch phase: {exc!r}")

    try:
        f_lam = wide_grid(FLAGSHIP_POINTS)
        f_adata = synth_linelist(build_builtin_atom_data(30, include_linelists=True), N_LINES,
                                 *FLAGSHIP_LINE_RANGE)
        f_cfg = sim100aa_config(model_path)
        config, _, model = parse_config_to_model(f_cfg, atom_data=f_adata)
        fplan = build_simulation_plan(config, f_adata, model, f_lam.to(u.Hz, u.spectral()).value)
        k_auto = mem.choose_nu_segments(fplan, itemsize=4)
        log(f"flagship plan: {FLAGSHIP_POINTS} points x {fplan.line_data.n_lines} of {N_LINES} "
            f"lines; memory model: fixed {mem.fixed_overhead_bytes(fplan, 1, 4) / 1e9:.3f} GB + "
            f"{mem.per_pixel_bytes(len(fplan.temperatures), len(fplan.weights), mem.count_alpha_sources(fplan), 4)} "
            f"B/pixel; free for this process {mem.device_bytes_limit() / 1e9:.2f} GB; "
            f"'auto' chooses K = {k_auto}")

        def flagship_run(k):
            out = run_stardis(f_cfg, f_lam, device="cuda", dtype=torch.float32,
                              atom_data=f_adata, nu_segments=k)
            torch.cuda.synchronize()
            return out

        reset_counts()
        t0 = time.perf_counter()
        flagship_run("auto")
        cold = time.perf_counter() - t0
        path_launches["flagship auto"] = read_counts()
        t0 = time.perf_counter()
        peak_auto, out_auto = peak_bytes(torch, lambda: flagship_run("auto"))
        warm = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        peak_k, out_k = peak_bytes(torch, lambda: flagship_run(FLAGSHIP_SEGMENTS))
        wall_k = time.perf_counter() - t0
        launches = path_launches[f"flagship K={FLAGSHIP_SEGMENTS}"] = read_counts()
        spec_auto, spec_k = out_auto.spectrum_nu.value, out_k.spectrum_nu.value
        rel = float(np.abs(spec_k / spec_auto - 1.0).max())
        log(f"flagship run_stardis(nu_segments='auto'): K = {k_auto}, launches "
            f"{path_launches['flagship auto']}, cold wall {cold:.3f} s, warm wall {warm:.3f} s, "
            f"peak {peak_auto / 1e9:.4f} GB")
        log(f"flagship run_stardis(nu_segments={FLAGSHIP_SEGMENTS}): wall {wall_k:.3f} s, peak "
            f"{peak_k / 1e9:.4f} GB, launches {launches}; F_nu against K = {k_auto} max rel "
            f"err {rel:.3e} (bound 1e-6); F_nu[surface] min {spec_auto.min():.4e}, max "
            f"{spec_auto.max():.4e}")
        if not (np.isfinite(spec_auto).all() and (spec_auto > 0).all()
                and np.isfinite(spec_k).all() and (spec_k > 0).all() and rel <= 1e-6
                and spec_auto.shape == (FLAGSHIP_POINTS,)):
            failures.append(f"flagship F_nu not finite, positive and equal: rel {rel:.3e}")
        auto_launches = path_launches["flagship auto"]
        expected = ({"line_opacity": 1, "line_opacity_range": 0} if k_auto == 1
                    else {"line_opacity": 0, "line_opacity_range": k_auto})
        if not (all(auto_launches[k] == v for k, v in expected.items())
                and auto_launches["formal_solution"] == k_auto):
            failures.append(f"flagship auto: launches {auto_launches} for K = {k_auto}")
        if not (launches["line_opacity_range"] == FLAGSHIP_SEGMENTS
                and launches["formal_solution"] == FLAGSHIP_SEGMENTS):
            failures.append(f"flagship K={FLAGSHIP_SEGMENTS}: launches {launches}")
        check_estimate(f"flagship, K = {k_auto}", model_estimate(fplan, k_auto), peak_auto)
        check_estimate(f"flagship, K = {FLAGSHIP_SEGMENTS}",
                       model_estimate(fplan, FLAGSHIP_SEGMENTS), peak_k)
        del out_auto, out_k
        timings = {}
        run_simulation(fplan, device=dev, dtype=torch.float32, timings=timings,
                       nu_segments=k_auto)
        log(f"flagship device stages, K = {k_auto} (s, synchronised): "
            + ", ".join(f"{k} {v:.4f}" for k, v in timings.items()))
        temps = torch.as_tensor(fplan.temperatures, device=dev).to(torch.float32)
        n_elem = torch.as_tensor(fplan.n_elem, device=dev).to(torch.float32)
        fconsts = device_constants(fplan, torch.float32, dev)
        state, quants = stage_plasma_and_lines(fplan, temps, n_elem, fconsts)
        walls = []
        segmented_spectrum(fplan, state, quants, FLAGSHIP_SEGMENTS, fconsts,
                           segment_walls=walls)
        log(f"flagship segment_walls, K = {FLAGSHIP_SEGMENTS} (s, CUDA events): "
            + ", ".join(f"{w:.4f}" for w in walls))
        # the continuum of each range against the whole grid's columns
        f_ranges = segment_ranges(FLAGSHIP_POINTS, FLAGSHIP_SEGMENTS)
        nus_t = torch.as_tensor(fplan.tracing_nus, device=dev).to(torch.float32)
        whole = continuum_batch(fplan, [state], nus_t)
        parts = [continuum_batch(fplan, [state], nus_t[a:b], pixels=slice(a, b))
                 for a, b in f_ranges]
        log("flagship continuum in the ranges == the whole grid's columns bit for bit: "
            + str({k: torch.equal(torch.cat([q[k] for q in parts], dim=-1), v)
                   for k, v in whole.items()}))
        del whole, parts
        alpha, gamma, doppler = quants["atomic"]
        f_iw = lk.window_half_widths(alpha, gamma, doppler, fplan.d_nu, FLAGSHIP_POINTS)
        evals = voigt_evaluations(
            fplan.tracing_nus, fplan.line_data.nu,
            lk.line_center_indices(fplan.tracing_nus, fplan.line_data.nu),
            gamma.double().cpu().numpy(), doppler.double().cpu().numpy(), f_iw.cpu().numpy())
        f_bound, f_by = line_bound(evals, 1, fplan.line_data.n_lines, len(fplan.temperatures),
                                   FLAGSHIP_POINTS, 4)
        log(f"flagship Kernel 1 in-window evaluations by Voigt region: {evals}; bound "
            f"{f_bound:.3f} ms ({f_by}); line_opacity stage {timings['line_opacity'] * 1e3:.1f} ms")

        # Kernel 1 at the flagship's shape against its plain version, on
        # the main path's prepared inputs: ranges of FLAGSHIP_CHECK_PIXELS
        # at both ends of the grid (where the deep layers' grid-wide
        # windows are clamped), across each boundary of the K = 4 ranges,
        # and across the upper window edge of the deepest layer's widest
        # line whose edge lies inside the grid; float32 at phase 3's row
        # bound for a whole line set, float64 at 1e-12
        n_chk = FLAGSHIP_CHECK_PIXELS
        centres = lk.line_center_indices(fplan.tracing_nus, fplan.line_data.nu)
        deep_iw = f_iw[:, -1].cpu().numpy().astype(np.int64)
        edge = centres + deep_iw
        inner = np.flatnonzero((edge >= n_chk) & (edge <= FLAGSHIP_POINTS - n_chk))
        starts = [0, FLAGSHIP_POINTS - n_chk] + [a - n_chk // 2 for a, _ in f_ranges[1:]]
        if len(inner):
            starts.append(int(edge[inner[np.argmax(deep_iw[inner])]]) - n_chk // 2)
        log(f"flagship Kernel 1 check ranges: {n_chk} pixels from {starts}; deepest layer's "
            f"widest half-window {int(deep_iw.max())} pixels")
        del f_iw, alpha, gamma, doppler
        for dtype in (torch.float32, torch.float64):
            if dtype == torch.float32:
                c_d, st, qd = fconsts, state, quants
            else:
                c_d = device_constants(fplan, dtype, dev)
                st, qd = stage_plasma_and_lines(
                    fplan, torch.as_tensor(fplan.temperatures, device=dev),
                    torch.as_tensor(fplan.n_elem, device=dev), c_d)
            (_, kin, _, _), = prepare_lines(fplan, [st], [qd], c_d)
            (_, pin, _, _), = prepare_lines(fplan, [st], [qd], c_d, plain=True)
            worst, t_plain = 0.0, 0.0
            for a in starts:
                kern = lk.line_opacity_range(kin, a, n_chk)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plain = lk.accumulate_line_opacity_plain(
                    pin.grid, pin.line_nu, pin.centers, pin.alpha, pin.gamma, pin.doppler,
                    pin.iw, budget=FLAGSHIP_PLAIN_BUDGET, p_begin=a, n_out=n_chk)
                torch.cuda.synchronize()
                t_plain += time.perf_counter() - t0
                if dtype == torch.float64:
                    err = ((kern - plain).abs() / plain.abs().clamp_min(1e-300)).max().item()
                    ok = err <= 1e-12
                else:
                    err, rows_ok = row_err(kern, plain)
                    ok = err <= 1e-4 and rows_ok
                worst = max(worst, err)
                if not (ok and kern.shape == (1, len(fplan.temperatures), n_chk)):
                    failures.append(f"flagship Kernel 1 {dtype} range at {a}: err {err:.3e}")
            log(f"flagship Kernel 1 {str(dtype)[6:]} vs plain on {len(starts)} ranges: max "
                + ("rel err" if dtype == torch.float64 else "row err / row max")
                + f" {worst:.3e} (bound {1e-12 if dtype == torch.float64 else 1e-4:g}); "
                f"plain {t_plain:.1f} s")
            del kin, pin, kern, plain
        del c_d, st, qd

        # Kernel 2 at the flagship's full shape against its plain version;
        # the plain version runs on column blocks (each column is its own
        # computation) to bound its [T, G, n] temporaries
        _, total, _, _ = stage_spectrum(fplan, state, quants, fconsts)
        source = blackbody_flux_at_nu(fconsts.tracing_nus, state.t)
        ray = torch.as_tensor(fplan.ray_distances, device=dev).to(torch.float32)
        w = torch.as_tensor(fplan.weights, device=dev).to(torch.float32)
        f_k, i_k = solver.raytrace(total, source, ray, w, track_individual_intensities=True)
        worst_f = worst_i = 0.0
        zeros_ok = True
        for a in range(0, FLAGSHIP_POINTS, FLAGSHIP_TRACE_BLOCK):
            b = min(a + FLAGSHIP_TRACE_BLOCK, FLAGSHIP_POINTS)
            fp, ip = solver.raytrace_plain(total[:, a:b], source[:, a:b], ray, w,
                                           track_individual_intensities=True)
            rel_f, zf = rel_err(f_k[:, a:b], fp)
            rel_i, zi = rel_err(i_k[:, a:b], ip)
            worst_f, worst_i = max(worst_f, rel_f), max(worst_i, rel_i)
            zeros_ok = zeros_ok and zf and zi
            del fp, ip
        log(f"flagship Kernel 2 f32 vs plain (56 x {FLAGSHIP_POINTS} x {len(fplan.weights)}): "
            f"max rel err F_nu {worst_f:.3e}, I_nu {worst_i:.3e} (bound 1e-5)")
        if not (worst_f <= 1e-5 and worst_i <= 1e-5 and zeros_ok):
            failures.append(f"flagship Kernel 2 rel err {worst_f:.3e} / {worst_i:.3e}")
        del state, quants, fplan, fconsts, total, source, f_k, i_k
    except Exception as exc:  # noqa: BLE001
        failures.append(f"flagship phase: {exc!r}")

    # --- 11. serving ----------------------------------------------------------
    try:
        from stardis_tpu_torch.base import read_stellar_model
        from stardis_tpu_torch.serving import SpectralService

        serve_paths = []
        for teff in SERVE_TEFFS:
            serve_paths.append(os.path.join(tmp.name, f"serve{int(teff)}.mod"))
            write_marcs_file(serve_paths[-1], teff=teff)
        s_adata = synth_linelist(build_builtin_atom_data(30, include_linelists=True), N_LINES)
        s_cfg = sim100aa_config(serve_paths[0])
        svc = SpectralService(s_cfg, lam_q, atom_data=s_adata)
        s_models = [read_stellar_model(svc.config, svc.atom_data, p) for p in serve_paths]
        reset_counts()
        served = [svc.synthesize(m) for m in s_models]
        launches = path_launches["serving"] = read_counts()
        if not (launches["line_opacity"] == len(s_models)
                and launches["formal_solution"] == len(s_models)):
            failures.append(f"serving: launches {launches}")
        svc_walls = []
        for m in s_models:
            t0 = time.perf_counter()
            svc.synthesize(m)
            svc_walls.append(time.perf_counter() - t0)
        worst, run_walls = 0.0, []
        for path, out in zip(serve_paths, served):
            cfg_i = copy.deepcopy(s_cfg)
            cfg_i["input_model"]["fname"] = path
            run_stardis(cfg_i, lam_q, atom_data=s_adata)
            t0 = time.perf_counter()
            ref = run_stardis(cfg_i, lam_q, atom_data=s_adata).spectrum_nu.value
            run_walls.append(time.perf_counter() - t0)
            worst = max(worst, float(np.abs(out["spectrum_nu"] / ref - 1.0).max()))
        log(f"serving Sim100AA ({N_LINES} lines), Teff {SERVE_TEFFS}: requests against "
            f"run_stardis max rel err {worst:.3e} (bound 1e-5); warm request walls "
            + ", ".join(f"{w:.4f}" for w in svc_walls) + " s; warm run_stardis walls "
            + ", ".join(f"{w:.4f}" for w in run_walls) + f" s; stats {svc.stats}")
        if not worst <= 1e-5:
            failures.append(f"serving against run_stardis rel err {worst:.3e}")
        svc3 = SpectralService(s_cfg, lam_q, atom_data=s_adata, nu_segments=RANGE_SEGMENTS)
        reset_counts()
        served3 = [svc3.synthesize(m) for m in s_models]
        launches = path_launches[f"serving, {RANGE_SEGMENTS} segments"] = read_counts()
        rel3 = max(rel_err(torch.as_tensor(a["F_nu"]), torch.as_tensor(b["F_nu"]))[0]
                   for a, b in zip(served3, served))
        log(f"serving through nu_segments={RANGE_SEGMENTS}: F_nu against the unsegmented "
            f"service max rel err {rel3:.3e} (bound 1e-6); launches {launches}")
        n_ranges = RANGE_SEGMENTS * len(s_models)
        if not (rel3 <= 1e-6 and launches["line_opacity_range"] == n_ranges
                and launches["formal_solution"] == n_ranges):
            failures.append(f"segmented serving rel err {rel3:.3e}, launches {launches}")

        g2_path = os.path.join(tmp.name, "giant_serve.mod")
        write_marcs_file(g2_path, **{**GIANT, "teff": SERVE_GIANT_TEFF})
        g_adata = synth_linelist(build_builtin_atom_data(30, include_linelists=True), N_LINES)
        g_cfg = giant_config(giant_path, tables, molecules=False)
        gsvc = SpectralService(g_cfg, lam_q, atom_data=g_adata)
        gsvc.synthesize(read_stellar_model(gsvc.config, gsvc.atom_data, giant_path))
        g_out = gsvc.synthesize(read_stellar_model(gsvc.config, gsvc.atom_data, g2_path))
        cfg_g2 = copy.deepcopy(g_cfg)
        cfg_g2["input_model"]["fname"] = g2_path
        ref = run_stardis(cfg_g2, lam_q, atom_data=g_adata).spectrum_nu.value
        rel_g = float(np.abs(g_out["spectrum_nu"] / ref - 1.0).max())
        log(f"giant service (3 file tables, spherical), {SERVE_GIANT_TEFF:.0f} K request: "
            f"sigma re-interpolations {gsvc.stats.sigma_reinterp_events}; against run_stardis "
            f"max rel err {rel_g:.3e} (bound 1e-5)")
        if not (gsvc.stats.sigma_reinterp_events == 1 and rel_g <= 1e-5):
            failures.append(f"giant service: {gsvc.stats}, rel err {rel_g:.3e}")

        bsvc = SpectralService(b_cfg, u.Quantity(b_lams, u.AA), atom_data=b_adata)
        fb = bsvc.synthesize_batch(models)
        rel_b, _ = rel_err(torch.as_tensor(fb), f_batch.cpu())
        log(f"synthesize_batch of {len(models)} models against run_batch: F_nu max rel err "
            f"{rel_b:.3e} (bound 1e-6)")
        if not rel_b <= 1e-6:
            failures.append(f"synthesize_batch rel err {rel_b:.3e}")
        p_wall, busy, ops = device_busy(torch, lambda: svc.synthesize(s_models[0]))
        log(f"serving profiled request: wall {p_wall:.4f} s, device busy {busy * 1e3:.2f} ms "
            f"({busy / p_wall:.1%} of the wall), {ops} device ops")
        del svc, svc3, gsvc, bsvc
    except Exception as exc:  # noqa: BLE001
        failures.append(f"serving phase: {exc!r}")

    # --- 12. grid scan and the command line -------------------------------------
    try:
        from stardis_tpu_torch.grid import load_grid, synthesize_grid

        scan, fresh = os.path.join(tmp.name, "scan"), os.path.join(tmp.name, "scan_fresh")
        labels = [{"teff": float(t)} for t in np.linspace(5000.0, 6500.0, BATCH_MODELS)]
        kw = {"batch_size": 8, "labels": labels}
        config_b = parse_config_to_model(b_cfg, atom_data=b_adata)[0]
        r1 = synthesize_grid(config_b, b_adata, models, b_nus, scan, max_chunks=1, **kw)
        r2 = synthesize_grid(config_b, b_adata, models, b_nus, scan, **kw)
        reset_counts()
        r3 = synthesize_grid(config_b, b_adata, models, b_nus, fresh, **kw)
        launches = path_launches["grid scan"] = read_counts()
        if not (launches["line_opacity"] == 2 and launches["formal_solution"] == 2):
            failures.append(f"grid scan: launches {launches} for 2 chunks")
        resumed, fresh_spec = load_grid(scan)[0], load_grid(fresh)[0]
        same = bool(np.array_equal(resumed, fresh_spec))
        rel_g, _ = rel_err(torch.as_tensor(resumed), f_batch[:, -1].cpu())
        log(f"grid scan of {BATCH_MODELS} models in chunks of 8: stopped {r1}, resumed {r2}; "
            f"resumed == uninterrupted bit for bit: {same}; against run_batch of all "
            f"{BATCH_MODELS} max rel err {rel_g:.3e}")
        if not (same and r1["computed"] == 1 and not r1["done"] and r2["skipped"] == 1
                and r2["computed"] == 1 and r2["done"] and r3["computed"] == 2
                and np.isfinite(resumed).all()):
            failures.append(f"grid scan: {r1} {r2} {r3} equal {same}")

        cli_cfg = os.path.join(tmp.name, "sim100aa.json")
        with open(cli_cfg, "w") as fh:
            json.dump(sim100aa_config(model_path), fh)
        table = os.path.join(tmp.name, "spectrum.txt")
        lam_spec = ":".join(f"{v:g}" for v in SIM100AA_LAMBDA)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "stardis_tpu_torch", cli_cfg, "--lambda", lam_spec,
             "--segments", "auto", "--ascii", table],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=600,
        )
        cli_wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"CLI exit {res.returncode}: {res.stderr[-2000:]}")
        f_lam_cli = np.loadtxt(table)[:, 1]
        ref = run_stardis(sim100aa_config(model_path), lam_q).spectrum_lambda.value
        rel_c = float(np.abs(f_lam_cli / ref - 1.0).max())
        log(f"CLI: {res.stdout.strip()} (process wall {cli_wall:.2f} s); F_lambda against "
            f"run_stardis max rel err {rel_c:.3e} (bound 1e-6)")
        if not (rel_c <= 1e-6 and f_lam_cli.shape == ref.shape):
            failures.append(f"CLI against run_stardis rel err {rel_c:.3e}")
    except Exception as exc:  # noqa: BLE001
        failures.append(f"grid and CLI phase: {exc!r}")
    # --- 13. the gradient slice: Sim100AA fitted by Adam on the card -----------
    try:
        from stardis_tpu_torch.postprocessing import (
            instrumental_broadening_torch,
            rotation_broadening_torch,
        )

        vel_pix = float(SIM100AA_LAMBDA[2] / lams.mean() * 299792.458)  # km/s per pixel

        def fit_model(fplan, dtype, plain=False):
            """spectrum(params) -> (mean-normalised broadened surface spectrum,
            the stage tensors whose gradients Kernels 1b and 2b write)."""
            consts = device_constants(fplan, dtype, dev)
            temps0 = torch.as_tensor(fplan.temperatures, device=dev).to(dtype)
            n_elem0 = torch.as_tensor(fplan.n_elem, device=dev).to(dtype)

            def spectrum(params):
                scale, v_rot, sigma = params[0], params[1], params[2]
                state, lq = stage_plasma_and_lines(fplan, temps0 * scale, n_elem0 / scale,
                                                   consts)
                # stage_spectrum's own two calls, keeping the batch's total
                # opacity (Kernel 2b's input) for the determinism check
                lines = prepare_lines(fplan, [state], [lq], consts, plain=plain)
                f_nu, total, _, _ = spectrum_batch(
                    fplan, [state], lines, consts,
                    photospheric_correction=fplan.photospheric_correction, plain=plain)
                surface = f_nu[0, -1]
                out = rotation_broadening_torch(vel_pix, surface, v_rot, half_width_pix=FIT_HALF)
                out = instrumental_broadening_torch(out, sigma, radius_pix=FIT_RADIUS)
                return out / out.mean(), (*lq["atomic"], total, surface,
                                          state.electron_densities, state.partition_function,
                                          state.ion_number_density,
                                          state.level_number_density, state.t)

            return spectrum

        def fit_loss(spectrum, observed, params):
            model, inner = spectrum(params)
            return torch.mean((model - observed) ** 2), inner

        spectrum = fit_model(plan, torch.float32)
        with torch.no_grad():
            observed = spectrum(torch.tensor(FIT_TRUE, device=dev))[0]

        def value_and_grad(params, inner=False):
            p = params.detach().clone().requires_grad_()
            loss, stage = fit_loss(spectrum, observed, p)
            grads = torch.autograd.grad(loss, [p, *stage] if inner else [p], allow_unused=True)
            return loss.detach(), grads

        start = torch.tensor(FIT_START, device=dev)
        value_and_grad(start)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        p = start.clone()
        pscale = torch.tensor(FIT_STEP_SCALE, device=dev)
        m = v = torch.zeros(3, device=dev)
        losses, t0 = [], time.perf_counter()
        for i in range(FIT_STEPS):
            loss, (g,) = value_and_grad(p)
            losses.append(loss.item())
            g = g * pscale
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mhat, vhat = m / (1 - 0.9 ** (i + 1)), v / (1 - 0.999 ** (i + 1))
            p = p - FIT_LR / (1.0 + 0.05 * i) * pscale * mhat / (torch.sqrt(vhat) + 1e-12)
        with torch.no_grad():
            losses.append(torch.mean((spectrum(p)[0] - observed) ** 2).item())
        fit_wall = time.perf_counter() - t0
        launches = path_launches["Sim100AA fit"] = read_counts()
        log(f"fit: Sim100AA ({plan.line_data.n_lines} lines x 56 x {len(lams)} lambda x 20 theta, "
            f"float32), {FIT_STEPS} Adam steps from {FIT_START} toward {FIT_TRUE}: losses "
            + ", ".join(f"{x:.4e}" for x in losses) + f"; parameters "
            + ", ".join(f"{x:.5f}" for x in p.tolist()) + f"; wall {fit_wall:.3f} s; "
            f"launches {launches}")
        if not (losses[-1] < losses[0] and all(np.isfinite(losses))):
            failures.append(f"fit: the loss did not fall: {losses}")
        # one forward per step and one for the final loss, one backward per step
        expected = {"line_opacity": FIT_STEPS + 1, "formal_solution": FIT_STEPS + 1,
                    "line_opacity_grad": FIT_STEPS, "formal_solution_grad": FIT_STEPS}
        if any(launches[k] != v for k, v in expected.items()):
            failures.append(f"fit: launches {launches}, expected {expected}")

        # walls, backward kernels' device time and peak memory of one step
        def step_walls():
            q = start.clone().requires_grad_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = fit_loss(spectrum, observed, q)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            return t1 - t0, time.perf_counter() - t1

        walls = [step_walls() for _ in range(3)]
        fwd, bwd = sorted(w[0] for w in walls)[1], sorted(w[1] for w in walls)[1]
        peak, _ = peak_bytes(torch, step_walls)
        dev_ms = kernel_device_ms(torch, step_walls, ("line_opacity_grad_kernel",
                                                      "trace_grad_kernel", "grad_sum_kernel",
                                                      "line_opacity_kernel", "trace_kernel"))
        log(f"fit step (float32, median of 3): forward {fwd:.4f} s, backward {bwd:.4f} s, "
            f"value and gradient {fwd + bwd:.4f} s; peak memory of a step {peak / 1e9:.3f} GB; "
            "device ms in one step: " + ", ".join(f"{k} {v:.3f}" for k, v in dev_ms.items()))

        # two float32 gradient runs: Kernels 1b and 2b must be bit-equal.  The
        # gradients of the stage tensors locate a difference: the surface
        # F_nu's is post-processing's backward, the line quantities' and the
        # total opacity's are Kernels 1b and 2b's outputs, the plasma state's
        # fields what stage 1's line and continuum backward hand to
        # solve_lte, T's what solve_lte's backward adds
        names = ("params", "alpha (Kernel 1b)", "gamma (Kernel 1b)", "doppler (Kernel 1b)",
                 "total opacity (Kernel 2b)", "surface F_nu (post-processing)", "n_e",
                 "partition functions", "ion densities", "level densities", "T")

        def run_diffs():
            runs = [value_and_grad(start, inner=True)[1] for _ in range(2)]
            return {n: (a - b).abs().max().item()
                    for n, a, b in zip(names, *runs) if a is not None}

        diffs = run_diffs()
        log("two float32 gradient runs, max |difference|: "
            + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()))
        if any(v != 0 for k, v in diffs.items() if "Kernel" in k):
            failures.append(f"fit: Kernel 1b / 2b gradients differ run to run: {diffs}")
        if diffs["params"] != 0:
            # torch's deterministic mode swaps in the deterministic versions
            # of the ops that have one (and raises on one that has none)
            torch.use_deterministic_algorithms(True)
            try:
                det = run_diffs()
                log("the same under torch.use_deterministic_algorithms(True): "
                    + ", ".join(f"{k} {v:.3e}" for k, v in det.items()))
            except RuntimeError as exc:
                log(f"torch.use_deterministic_algorithms(True) stops the gradient: {exc}")
            finally:
                torch.use_deterministic_algorithms(False)

        # float64 on the card: central differences at full width, and the
        # all-plain path's gradient at N_LINES_PLAIN_CHECK lines
        spec64 = fit_model(plan, torch.float64)
        start64 = start.double()
        obs64 = spec64(torch.tensor(FIT_TRUE, device=dev, dtype=torch.float64))[0].detach()
        p64 = start64.clone().requires_grad_()
        (g64,) = torch.autograd.grad(fit_loss(spec64, obs64, p64)[0], p64)
        fd = []
        with torch.no_grad():
            for i, h in enumerate(FIT_FD_STEPS):
                e = torch.zeros(3, device=dev, dtype=torch.float64)
                e[i] = h
                fd.append((fit_loss(spec64, obs64, start64 + e)[0]
                           - fit_loss(spec64, obs64, start64 - e)[0]).item() / (2 * h))
        fd_rel = [abs(a - b) / abs(b) for a, b in zip(g64.tolist(), fd)]
        g32 = value_and_grad(start)[1][0].double()
        log(f"fit gradient float64 (full width): " + ", ".join(f"{x:.6e}" for x in g64.tolist())
            + "; central differences " + ", ".join(f"{x:.6e}" for x in fd)
            + f"; rel err {', '.join(f'{x:.2e}' for x in fd_rel)} (bound 5e-3); the float32 "
            f"gradient against it: rel diff "
            + ", ".join(f"{x:.2e}" for x in ((g32 - g64).abs() / g64.abs()).tolist()))
        if not max(fd_rel) <= 5e-3:
            failures.append(f"fit gradient vs finite differences rel err {fd_rel}")
        plan_small = sim100aa_plan(N_LINES_PLAIN_CHECK)
        grads = []
        for plain in (False, True):
            spec_s = fit_model(plan_small, torch.float64, plain=plain)
            obs_s = spec_s(torch.tensor(FIT_TRUE, device=dev, dtype=torch.float64))[0].detach()
            q = start64.clone().requires_grad_()
            grads.append(torch.autograd.grad(fit_loss(spec_s, obs_s, q)[0], q)[0])
        plain_rel = ((grads[0] - grads[1]).abs() / grads[1].abs()).max().item()
        log(f"fit gradient float64 at {N_LINES_PLAIN_CHECK} lines: kernel path "
            + ", ".join(f"{x:.10e}" for x in grads[0].tolist()) + ", all-plain path "
            + ", ".join(f"{x:.10e}" for x in grads[1].tolist())
            + f"; max rel err {plain_rel:.3e} (bound 1e-9)")
        if not plain_rel <= 1e-9:
            failures.append(f"fit gradient kernel vs all-plain rel err {plain_rel:.3e}")
        del spectrum, spec64, spec_s, observed, obs64, obs_s
    except Exception as exc:  # noqa: BLE001
        failures.append(f"fit phase: {exc!r}")

    # --- 13b. molecules under autograd on the card: the spherical giant --------
    try:
        for coupled in (False, True):
            mplan = giant_plan(N_LINES_PLAIN_CHECK, GIANT_MOL_LINES_PLAIN_CHECK, coupled=coupled)
            grads = {}
            for dtype in (torch.float32, torch.float64):
                consts = device_constants(mplan, dtype, dev)
                n_elem = torch.as_tensor(mplan.n_elem, device=dev).to(dtype)

                def flux_sum(temps):
                    state, lq = stage_plasma_and_lines(mplan, temps, n_elem, consts)
                    return stage_spectrum(mplan, state, lq, consts)[0][-1].sum()

                t = torch.as_tensor(mplan.temperatures, device=dev).to(dtype).requires_grad_()
                (grads[dtype],) = torch.autograd.grad(flux_sum(t), t)
            g64, g32 = grads[torch.float64], grads[torch.float32].double()
            # the most sensitive depth, as tests/test_differentiability.py does
            i = int(g64.abs().argmax())
            with torch.no_grad():
                tp = torch.as_tensor(mplan.temperatures, device=dev).clone()
                tm = tp.clone()
                tp[i] += 0.5
                tm[i] -= 0.5
                fd = ((flux_sum(tp) - flux_sum(tm)) / 1.0).item()
            rel = abs(g64[i].item() - fd) / abs(fd)
            f32_rel = ((g32 - g64).abs().max() / g64.abs().max()).item()
            label = "coupled" if coupled else "pairwise"
            log(f"giant {label} molecules ({mplan.line_data.n_lines} + "
                f"{mplan.molecule_line_data.n_lines} lines, 3 file tables): float64 d sum "
                f"F_nu(surface) / dT[{i}] {g64[i].item():.6e}, central difference {fd:.6e}, rel "
                f"err {rel:.2e} (bound 5e-3); float32 gradient finite "
                f"{bool(torch.isfinite(g32).all())}, against float64 {f32_rel:.2e} of the largest")
            if not (rel <= 5e-3 and torch.isfinite(g32).all() and torch.isfinite(g64).all()):
                failures.append(f"giant {label} molecules gradient: rel err {rel:.2e}")
    except Exception as exc:  # noqa: BLE001
        failures.append(f"molecule gradient phase: {exc!r}")

    # --- 13c. a batched run's gradient: the spherical giants of phase 8 -------
    try:
        temps_b = torch.as_tensor(g_batch.temperatures, device=dev).float().requires_grad_()
        reset_counts()
        f_b = run_batch(gb_plan, dataclasses.replace(g_batch, temperatures=temps_b), device=dev,
                        dtype=torch.float32)
        f_b[:, -1].sum().backward()
        torch.cuda.synchronize()
        launches = path_launches["giant batch gradient"] = read_counts()
        g_b = temps_b.grad
        log(f"giant batch gradient ({g_b.shape[0]} spherical members, 3 file tables): "
            f"d sum F_nu(surface) / dT finite {bool(torch.isfinite(g_b).all())}, max |.| per "
            "member " + ", ".join(f"{x:.4e}" for x in g_b.abs().amax(dim=1).tolist())
            + f"; launches {launches}")
        if not (torch.isfinite(g_b).all() and (g_b.abs().amax(dim=1) > 0).all()
                and launches["line_opacity_grad"] == 1
                and launches["formal_solution_grad_inward"] == 1):
            failures.append(f"giant batch gradient: launches {launches}")

        # each member's row against the all-plain path at the same [4, D, N]:
        # the kernels' per-model offsets are exercised only by a batch
        def batch_grad(dtype, plain):
            t = torch.as_tensor(g_batch.temperatures, device=dev).to(dtype).requires_grad_()
            f = run_batch(gb_plan, dataclasses.replace(g_batch, temperatures=t), device=dev,
                          dtype=dtype, plain=plain)
            return torch.autograd.grad(f[:, -1].sum(), t)[0]

        g_plain = batch_grad(torch.float64, plain=True)
        scale = g_plain.abs().amax(dim=1)
        err64 = ((batch_grad(torch.float64, plain=False) - g_plain).abs().amax(dim=1) / scale)
        err32 = (g_b.double() - g_plain).abs().amax(dim=1) / scale
        log("giant batch gradient per member against the all-plain path (float64), max "
            "|diff| / member max: float64 kernel path "
            + ", ".join(f"{x:.3e}" for x in err64.tolist()) + " (bound 1e-9); float32 main path "
            + ", ".join(f"{x:.3e}" for x in err32.tolist())
            + " (bound 1e-5; 13b's giant read 4e-7 to 6e-7 in float32)")
        if not ((err64 <= 1e-9).all() and (err32 <= 1e-5).all()):
            failures.append("giant batch gradient member vs all-plain: float64 "
                            f"{err64.tolist()}, float32 {err32.tolist()}")
    except Exception as exc:  # noqa: BLE001
        failures.append(f"batch gradient phase: {exc!r}")

    # --- 13d. peak memory of a differentiated segmented run --------------------
    # util/memory.py models forward-only runs; under autograd every range's
    # saved tensors live until the backward
    try:
        n_points = MEMORY_POINTS[1]
        cfg = sim100aa_config(model_path)
        cfg["result_options"] = {"return_radiation_field": False}
        dplan = mem_plan(cfg, mem_adata, wide_grid(n_points))
        d_consts = device_constants(dplan, torch.float32, dev)
        d_n_elem = torch.as_tensor(dplan.n_elem, device=dev).float()

        def segmented_run(k, grad):
            t = torch.as_tensor(dplan.temperatures, device=dev).float().requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                state, lq = stage_plasma_and_lines(dplan, t, d_n_elem, d_consts)
                f = segmented_spectrum(dplan, state, lq, k, d_consts)
                if grad:
                    f[-1].sum().backward()
            finite = bool(torch.isfinite(f).all())
            return finite and (not grad or bool(torch.isfinite(t.grad).all()))

        readings = {}
        for k in (1, 4):
            for grad in (False, True):
                readings[k, grad] = peak_bytes(torch, lambda: segmented_run(k, grad))
        log(f"segmented run peak memory ({n_points} points x {dplan.line_data.n_lines} lines, "
            "float32), forward only / forward and backward: "
            + "; ".join(f"K = {k}: {readings[k, False][0] / 1e9:.4f} / "
                        f"{readings[k, True][0] / 1e9:.4f} GB (memory model "
                        f"{model_estimate(dplan, k) / 1e9:.4f} GB)" for k in (1, 4)))
        if not all(ok for _, ok in readings.values()):
            failures.append("differentiated segmented run: not finite")
        del dplan, d_consts
    except Exception as exc:  # noqa: BLE001
        failures.append(f"differentiated segmented memory phase: {exc!r}")
    tmp.cleanup()

    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1

    log(f"launches by main path: {path_launches}")
    for name in KERNELS:
        if not any(counts[name] for counts in path_launches.values()):
            print(f"FAIL: kernel {name} was launched by no main path", file=sys.stderr)
            return 1
    sources = {
        "line_opacity": ("stardis_tpu_torch/csrc/line_opacity.cu",
                         "stardis_tpu/opacities/line_kernel.py:1049"),
        "line_opacity_range": ("stardis_tpu_torch/csrc/line_opacity.cu",
                               "stardis_tpu/opacities/line_kernel.py:1316"),
        "formal_solution": ("stardis_tpu_torch/csrc/formal_solution.cu",
                            "stardis_tpu/radiation_field/solver.py:186"),
        "formal_solution_inward": ("stardis_tpu_torch/csrc/formal_solution.cu",
                                   "stardis_tpu/radiation_field/solver.py:98"),
        "line_opacity_grad": ("stardis_tpu_torch/csrc/line_opacity_grad.cu",
                              "stardis_tpu/opacities/line_kernel.py:1049"),
        "formal_solution_grad": ("stardis_tpu_torch/csrc/formal_solution_grad.cu",
                                 "stardis_tpu/radiation_field/solver.py:186"),
        "formal_solution_grad_inward": ("stardis_tpu_torch/csrc/formal_solution_grad.cu",
                                        "stardis_tpu/radiation_field/solver.py:98"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": sum(counts[name] for counts in path_launches.values()),
         **report[name]}
        for name, (src, replaces) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
