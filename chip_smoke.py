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
     row for the two summation orders of that many float32 terms; two
     launches equal bit for bit); the (pixel, depth, line) triples the
     kernel's blocks walk beside the in-window evaluations; Kernel 1 on the
     5k lines' far wing (Doppler widths / 1000 and grid-wide windows: |x|
     to ~3e6) and with half-windows of 1-3 pixels beside grid-wide ones,
     against the plain sum in float64: float64 at 1e-12 per element,
     float32 at 1e-4 of each row's maximum, two launches equal bit for
     bit; the per-depth widest window (torch amax) timed; Kernel 1b (the
     line sum's backward) against its plain version on the same inputs
     with a seeded normal incoming gradient: float64 at 1e-12 and float32
     at 1e-4 of each depth's largest gradient, two launches equal bit for
     bit, both timed;
     then on the far wing and the 1-3-pixel windows as Kernel 1, float64
     at 1e-12 and float32 at 1e-4 against the plain gradient in float64;
  4. Kernel 2 (formal solution) against its plain version at the full
     Sim100AA shape (56 depths x 10k lambda x 20 theta), float32 and float64,
     F_nu and I_nu; F_nu of a launch that stores no intensity buffer equal
     bit for bit to the tracked launch's, and two launches of each equal;
     timed without and with I_nu stored;
     Kernel 2b (its backward) against autograd of raytrace_plain there,
     with and without a gradient on I_nu: float64 at 1e-9 of each
     frequency column's largest gradient, float32 within 1.5x the plain
     version's float32 error (2-norm) against the float64 gradient, two
     launches equal bit for bit, both timed; an untracked differentiated
     round trip (Kernel 2, then Kernel 2b through autograd) allocates less
     than one [1, 56, 10k, 20] buffer beyond F_nu and the two gradients;
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
     1e-5; the bit-for-bit checks of phase 4 on both sets; both timed on the
     giant's own, without and with I_nu stored; Kernel 2b's inward variant on
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
     atmospheres/s; a profiled run; stage 1 timed and profiled three ways
     (16 model-by-model calls, one eager call over the model axis, a
     replay of the CUDA graph run_batch captured), the replay equal to the
     eager call bit for bit, the graph pool's bytes beside util.memory's
     line planes; run_batch's F_nu equal bit for bit to the eager stage
     through the same spectrum, which is timed and profiled too
     (atmospheres/s with and without the graph); and a 4-member
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
     each row's maximum, float64 at rtol 1e-12; two launches equal bit for
     bit on each) and the walked triples; Kernel 1b on the same
     prepared inputs over the whole grid (timed, bound from the flagship's
     in-window evaluations, two launches equal bit for bit) and on the same
     ranges against its plain version (float64 at 1e-12, float32 at 1e-4 of
     each depth's largest gradient); and Kernel 2 on the whole [56, 1M] x 20
     theta against its plain version (rtol 1e-5), with phase 4's bit-for-bit
     checks, timed without and with I_nu stored, beside the unsegmented
     run's peak memory;
 11. serving: SpectralService on Sim100AA answering Teff 5777, 6300 and
     9000 K, each against run_stardis (rtol 1e-5), warm per-request walls
     beside run_stardis's; the same requests through nu_segments=3 against
     the unsegmented service (rtol 1e-6); a spherical-giant service with
     file tables answering a 4200 K request (one sigma re-interpolation)
     against run_stardis (rtol 1e-5); synthesize_batch of the 16 batch
     models against run_batch (rtol 1e-6); one profiled request; each
     request (stage 1 replayed from the service's graph) equal bit for
     bit to the eager stage 1 through the same spectrum;
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
     be bit-equal; a stage-1 difference is traced to its op); the float32
     gradient at 10k lines with the process-wide TF32 switch off and on
     against the all-plain float64 path; the
     spherical giant with molecules (pairwise and coupled) at 10k + 2k
     lines: float64 d sum F_nu / dT at its most sensitive depth against a
     central difference (rtol 5e-3), float32 finite; a 4-member spherical
     batch's gradient through run_batch (Kernels 1b and 2b inward at B = 4),
     each member's row against the all-plain path's in float64 (float64
     kernel path at 1e-9, the float32 main path at 1e-5 of the member's
     largest); and the peak memory of a segmented run at 250k points, K = 1
     and K = 4, forward only and with its backward, beside util.memory's
     forward-only estimate;
 14. the JAX package's golden stores (tests/golden/solar_halpha.npz and
     solar_nad_plasma.npz, read with util.regression.RegressionData): the
     configurations of tests/test_golden_regression.py and
     tests/test_golden_plasma.py run on the card, every pinned array held
     in float64 at the stores' rtol 1e-6 and in float32 at
     util.regression's float32 bars (the mixed bound of
     tests/test_f32_consistency.py for [D, N] grids and spectra, 1e-4 for
     partition functions, 5e-5 relative above 1e-30 of each depth's
     largest value for per-depth densities and factors); each array's
     worst error beside its bar;
 15. a MESA model (80 shells, io.synthetic.write_mesa_file) and Sim100AA's
     100k lines written as VALD long and short text (17 significant
     digits): both files parsed by the native (g++) parser and by the
     Python one, each column equal to the in-memory list bit for bit, the
     host parse times; run_stardis(device="cuda", float32) with
     input_model.type mesa and opacity.line.vald_linelist.fname on
     Sim100AA's grid: F_nu finite and positive and equal bit for bit to the
     same run with the lines handed over in memory, both kernels launched,
     warm wall and device-busy share; the shortlist sets its flag and runs;
     at 10k lines the kernel path against the all-plain path (rtol 1e-4);
 16. the sharded paths (parallel.sharding) on a mesh of one card repeated
     four times, float32, each held bit for bit: Sim100AA through
     run_stardis(mesh=) against the unsharded run (warm walls of both), and
     its F_nu [D, N] against the unsharded run and nu_segments=4, with each
     shard's device time; the flagship through run_stardis(mesh=) against
     phase 10's K = 4 spectrum, shard_spectrum's F_nu [D, N] against
     segmented_spectrum's (warm wall, shard device times), shard_eval_stats
     at 4 and 8 shards, each shard's Kernel 1 and 2 bounds, and a forecast
     (labelled so) of a four-card wall; the 16-model batch through
     run_batch on a 1-D batch mesh of 4 and a 2 x 2 mesh against phase 8's
     unsharded batch; SpectralService(mesh=) against phase 11's requests;
     a 2-chunk grid scan on a 2 x 2 mesh against phase 12's chunk files.
     With two cards or more, a mesh over every card against one card, and
     Kernels 1, 1b, 2 and 2b on cuda:1 while cuda:0 is current against
     cuda:0; with one card a line says those checks were skipped;
 17. the rest of the host surface, float32 unless said: (a)
     radiation_field.create_stellar_radiation_field on Sim100AA (100k
     lines, 20 theta, I_nu tracked) for the caller's frequencies ascending
     and in a seeded shuffle, F_nu, the total opacity and I_nu equal bit for
     bit to run_stardis' (same configuration) under the same permutation,
     warm walls; (b) one warm Sim100AA run_stardis inside
     util.profiling.device_trace: the trace file holds Kernel 1's
     (line_opacity) and Kernel 2's (trace_kernel, the formal solution)
     kernels, their device ms from the trace beside the profiler's
     (kernel_device_ms, as phases 3-4 read it), and the "plan" and "solve"
     stages run_stardis logged, their sum within the warm wall; (c) the
     kurucz-scale carsus store built in memory (build_carsus_frames at its
     defaults: 150,000 lines, 120,000 VALD lines, Z <= 30, molecules;
     convert_frames; host times of both) and run as util.regression's
     carsus_scale configuration, float64 against tests/golden/carsus_scale.npz
     at rtol 1e-6 and float32 within the float32 bars, then on Sim100AA's
     grid and theta: F_nu finite and positive, warm wall, Kernel 1's
     in-window evaluations and bound; (d) the compile cache: a child
     process with STARDIS_COMPILE_CACHE loads formal_solution from there
     (built by nvcc into that directory, not _build/), a second child
     loads it without nvcc, and their launches on one fixed input are
     equal bit for bit (cold build and cached load times);
 18. the rest of the JAX package's public surface: (a) the eight examples
     of examples/torch through main() at their script sizes (full_visible
     200,000 points, teff_grid 16 models, serving_scan 7 Teffs, the fits 60
     and 120 steps), run twice, the second run's warm walls logged beside
     the card's name and power limit and its launches counted as the
     "examples" path; quickstart's and rotation_broadening's F_nu equal bit
     for bit to run_stardis on the same configuration, each fit's loss
     falls, teff_grid's mesh equals its batch bit for bit, and
     flexible_plasma's distances from Korg are logged, not checked; (b)
     plasma.create_stellar_plasma on the MARCS sun: every PlasmaState field
     equal bit for bit to the eager stage 1's; (c) run_stardis with
     n_threads -2 raises ValueError with no kernel launched; (d) the memory
     model with a captured graph resident: a Sim100AA SpectralService
     (MEMORY_LINES lines over phase 9's 1M-point grid) unsegmented, then
     with nu_segments="auto" under STARDIS_SEGMENT_BUDGET at
     MEMORY_BUDGET_SHARE of the unsegmented service's peak (allocated bytes
     plus the pool's free blocks, over the first request and a warm one):
     K > 1, peak under the budget, the estimate with the pool within [1,
     1.5] of the peak, F_nu against the unsegmented service at rtol 1e-6,
     device_bytes_limit fallen by at least the pool's free blocks over the
     first request (and the unrepaired formula's reading logged beside
     it); five batch graphs captured into run_batch's cache of four, the
     evicted one out of the registry;
 19. molecules on the batched, served, scanned and sharded paths, at the
     spherical cool giant's full width (giant_config: Sim100AA's 10,000
     lambda and 20 theta, 100k atomic + 20k molecular lines, three file
     tables), float32: a batch of MOL_BATCH giants (Teff 3600-4400 K,
     log g 2, R 1.5-3.5e12 cm), pairwise and coupled, each member's own
     K(T) and U(T) rows (their host ms logged): each member against
     run_stardis of that model at rtol 1e-5, the stage-1 graph's replay
     equal bit for bit to the eager stage on the same rows (both timed),
     atmospheres/s beside the same batch without molecules; a molecule
     SpectralService serving 3800, 4200 and 4500 K (the plan at 3800 K)
     against run_stardis at 1e-5, its synthesize_batch against run_batch
     at 1e-6; a two-chunk molecule grid scan stopped and resumed, equal
     bit for bit to a fresh one; the batch on a 'batch' mesh of 4 and a
     2 x 2 mesh of cuda:0 x 4, bit for bit the unsharded batch; a
     4-giant molecule batch differentiated (10k + 2k lines), pairwise
     and coupled: each member's float64 gradient row against the
     all-plain path at 1e-9, the float32 main path logged.

The kernels build in parallel (one nvcc per source).  The last line of
standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is the card's name and power limit, and the line
before that holds each kernel's launches (summed over the main paths of
phases 5, 7-12, 13, 14, 15, 16, 17, 18 and 19; the CLI and phase 17's compile-cache
children run in processes of their own and are not counted), error, times and bound (the larger of the operations
over the float32 peak and the bytes over the memory rate of an H100 SXM,
from this run's inputs); every entry also holds yardstick_bound_ms, the
bound by its kernel's first design's operation count; Kernel 2's two and
Kernel 2b's two entries device_ms (profiler), Kernel 2's tracked_ms (CUDA
events, I_nu stored).
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
# phase 14: the JAX package's committed golden stores (tests/golden/)
GOLDEN_STORES = ("solar_halpha", "solar_nad_plasma")
# phase 15: the MESA sun's shells (write_mesa_file's default, tests/test_mesa.py's)
MESA_SHELLS = 80
# phase 17: the kurucz-scale carsus store's sizes (build_carsus_frames' defaults)
CARSUS_LINES = 150_000
CARSUS_VALD_LINES = 120_000
# phase 17's compile-cache child: Kernel 2 on a seeded plane-parallel input of
# this shape (depths, frequencies, angles), its F_nu written to argv[1]
CACHE_CHILD = """
import json, os, sys, time
sys.path.insert(0, os.environ["STARDIS_REPO"])
import numpy as np
import torch
from stardis_tpu_torch import _cuda
from stardis_tpu_torch.radiation_field import solver
from stardis_tpu_torch.util.compile_cache import enable_compilation_cache

enable_compilation_cache()
t0 = time.perf_counter()
_cuda.load("formal_solution")
load_s = time.perf_counter() - t0
gen = torch.Generator("cuda").manual_seed(17)
d, n, t = 56, 4096, 20
alphas = torch.rand((d, n), device="cuda", generator=gen) * 1e-6 + 1e-9
source = torch.rand((d, n), device="cuda", generator=gen) + 0.5
rays = torch.rand((d - 1, t), device="cuda", generator=gen) * 1e6 + 1e5
weights = torch.full((t,), 1.0 / t, device="cuda")
f_nu = solver.raytrace(alphas, source, rays, weights)[0]
np.save(sys.argv[1], f_nu.cpu().numpy())
print(json.dumps({"build_dir": str(_cuda.BUILD_DIR), "loaded": _cuda._LIBS["formal_solution"]._name,
                  "nvcc_ran": sorted(_cuda.BUILD_LOGS), "load_s": load_s}))
"""
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
# phase 16: the shards of the mesh of repeated cards
MESH_SHARDS = 4
SERVE_TEFFS = (5777.0, 6300.0, 9000.0)
SERVE_GIANT_TEFF = 4200.0
# phase 19: the cool giants with molecules at the giant's full width, as a
# batch (Teff and radius evenly spaced), served, scanned, on meshes and
# differentiated (MOL_GRAD_MODELS of them, at the plain check's line counts)
MOL_BATCH = 8
MOL_BATCH_TEFF = (3600.0, 4400.0)
MOL_BATCH_RADIUS = (1.5e12, 3.5e12)
MOL_SERVE_TEFFS = (3800.0, 4200.0, 4500.0)
MOL_GRAD_MODELS = 4
# phase 18: the examples of examples/torch, run through main() at their
# script sizes
EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "torch")
EXAMPLES = ("quickstart", "teff_grid", "serving_scan", "rotation_broadening", "full_visible",
            "flexible_plasma", "fit_stellar_parameters", "fit_with_emulator")
KERNELS = ("line_opacity", "line_opacity_range", "formal_solution", "formal_solution_inward",
           "line_opacity_grad", "formal_solution_grad", "formal_solution_grad_inward")
# published peaks of an H100 SXM at 700 W (float32 outside the tensor
# cores, HBM3), the bound_ms of each kernel
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# floating-point operations of one in-window Voigt evaluation of Kernel 1's
# first CUDA design (x by a division, y, phi and the sum: 8; |x| + y and z^2:
# 7; then the region's own chain, a division per complex quotient), by
# Humlicek region: the yardstick every later design is compared against
# (yardstick_bound_ms), kept as it was
VOIGT_FLOPS = {"I": 25, "II": 39, "III": 87, "IV": 134}
# the same, counted from csrc/line_opacity.cu as it is (Kernel 1's
# bound_ms): region I x (2), x^2, x^2 - c0, 4 y^2 x^2, the fma of
# |z^2 - 1/2|^2 (2), the reciprocal, the numerator's fma (2) and the sum's
# (2); regions II-IV x (2), |x| + y, the sum's fma (2) and the w4 chain with
# one reciprocal per quotient (|x| + y, z^2 and the factor sqrt(pi): 8; then
# 25, 73 or 118, the last two with their region test, exp and cos)
KERNEL1_FLOPS = {"I": 12, "II": 38, "III": 86, "IV": 131}
# operations of one depth step of one ray with tau formed per ray (tau 6:
# two logs, a sum, a product, an exp and the chord's product; weights 8; the
# parabolic terms 17; the recurrence 6): Kernel 2b's recomputed step and
# Kernel 2's first design, its yardstick (yardstick_bound_ms); the inward
# sweep repeats it per gap
TRACE_STEP_FLOPS = 37
# the same, counted from csrc/formal_solution.cu as it is (Kernel 2's
# bound_ms): tau 1 (m ray), weights 8, the parabolic terms 15 (one quotient
# carried over negated), the recurrence 6; and per (gap, frequency) of a
# model, the staged mean extinction (a log, a sum, a product, an exp)
KERNEL2_STEP_FLOPS = 30
KERNEL2_GAP_FLOPS = 4
# operations of one in-window evaluation in Kernel 1b's first design by
# Humlicek region, and of finishing one (model, depth, line) pair: the
# yardstick of Kernel 1b's later designs (yardstick_bound_ms)
GRAD_VOIGT_FLOPS_YARDSTICK = {"I": 47, "II": 83, "III": 185, "IV": 299}
GRAD_PAIR_FLOPS_YARDSTICK = 30
# the same, counted from csrc/line_opacity_grad.cu as it is (Kernel 1b's
# bound_ms): region I x (2), a = z^2 - c0 (3), |a|^2 (3), the reciprocal,
# q (2), q^2 (5), the three values (7) and the three sums (6); regions
# II-IV the two region tests and |x| + y (5), x and the sums (8), and the
# value-and-derivative chain with one reciprocal per complex quotient
# (region II with S_D in closed form 106, III 174, IV 285); per pair 1/D
# and y (3), one shuffle tree (15), one chunk's warp-by-warp sum (24) and
# the finish (16)
GRAD_VOIGT_FLOPS = {"I": 29, "II": 119, "III": 187, "IV": 298}
GRAD_PAIR_FLOPS = 58
# operations of one reverse depth step of one ray in Kernel 2b's first
# design (its first source: step_adjoint 95, tau and the seed 11; the inward
# variant added a recomputed forward step and a reverse step per gap): the
# yardstick of its later designs (yardstick_bound_ms)
TRACE_ADJ_STEP_FLOPS = 106
# the same, counted from csrc/formal_solution_grad.cu as it is (Kernel 2b's
# bound_ms): per gap of a ray the recomputed forward step
# (KERNEL2_STEP_FLOPS) and the reverse step (step_adjoint 85: the weights
# 8, three reciprocals and a + b 4, the parabolic terms and their adjoints
# 62, the weights' adjoint 11; then tau 1, the seed's product and sum 2,
# q 2, the depth's q_d + q_{d-1} 1); the inward variant adds the recomputed
# inward step and a reverse inward step (step_adjoint 85, tau 1, q of both
# gaps 4, the partials' updates 3, q_d + q_{d-1} 1); per (gap, frequency)
# the staged mean extinction (KERNEL2_GAP_FLOPS); the theta sums 2 per
# (depth, frequency, angle) and sweep, and per (depth, frequency) a
# division (inward two more sums).  The gradient needs one recomputed step
# of each sweep per gap: the inward kernel runs each sweep a second time,
# from its checkpoints, and that repeat is its design's cost, not the
# function's, so the bound leaves it out
KERNEL2B_STEP_FLOPS = 91
KERNEL2B_INWARD_STEP_FLOPS = 94
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


def voigt_evaluations(nus, line_nu, centers, gamma, doppler, iw, pixels=None):
    """In-window Voigt evaluations of Kernel 1 by Humlicek region, for
    one model: nus [N] descending, line_nu / centers [L], gamma, doppler,
    iw [L, D] (host, float64), over the pixel range ``pixels`` = (a, b)
    (default the whole grid).  A pair (line, depth, pixel) is in window when
    -iw <= p - centre < iw; its region follows from |x| + y (I above 15,
    II above 5.5) and, below 5.5, from y >= 0.195 |x| - 0.176 (III, else
    IV), with x = (nu_p - nu_l) / doppler and y = gamma / (sqrt(pi) pi) /
    doppler.  Pixels within a distance of nu_l are counted by binary search
    on the grid."""
    import numpy as np

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


def walked_triples(centers, iw_max, n_nu, span):
    """(pixel, depth, line) triples Kernel 1's blocks walk over the whole
    grid of one model: for each depth's widest window w ([D] iw_max) and
    each block's span [ws, we) of ``span`` pixels, the lines whose centre
    lies in (ws - w, we - 1 + w] (the kernel's binary search over the
    non-increasing centres), times the span's pixels."""
    import numpy as np

    neg = -np.asarray(centers, dtype=np.int64)  # non-decreasing
    ws = np.arange(0, n_nu, span)
    we = np.minimum(ws + span, n_nu)
    w = np.asarray(iw_max, dtype=np.int64).reshape(-1, 1)
    first = np.searchsorted(neg, -(we - 1 + w), side="left")
    last = np.searchsorted(neg, -(ws - w), side="left")
    return int(((last - first) * (we - ws)).sum())


def line_bound(evaluations, n_models, n_lines, n_depth, n_out, itemsize):
    """Kernel 1's bound: the Voigt operations of these evaluations, or
    reading the [B, D, L] line arrays (three floats and the int32 window),
    the lines and the range of the grid once and writing [B, D, n_out]."""
    flops = sum(VOIGT_FLOPS[k] * v for k, v in evaluations.items())
    nbytes = (n_models * n_depth * n_lines * (3 * itemsize + 4) + n_lines * (itemsize + 4)
              + n_out * itemsize + n_models * n_depth * n_out * itemsize)
    return bound(flops, nbytes)


def kernel1_bound(evaluations, n_models, n_lines, n_depth, n_out, itemsize):
    """Kernel 1's bound from the operations its source does (KERNEL1_FLOPS)
    or line_bound's bytes, whichever takes longer."""
    bytes_ms, _ = line_bound({}, n_models, n_lines, n_depth, n_out, itemsize)
    return bound(sum(KERNEL1_FLOPS[k] * v for k, v in evaluations.items()),
                 bytes_ms * 1e-3 * PEAK_BYTES_PER_S)


def trace_bound(n_models, n_depth, n_nu, n_theta, itemsize, inward, tracked=False,
                yardstick=False):
    """Kernel 2's bound: the depth steps of every ray (twice with the
    inward sweep), the staged mean extinction and the theta sum, or reading
    alpha and source and writing F_nu (and I_nu when ``tracked``) once.
    ``yardstick``: with the first design's step (TRACE_STEP_FLOPS, tau
    per ray)."""
    rays = n_models * n_nu * n_theta
    step = TRACE_STEP_FLOPS if yardstick else KERNEL2_STEP_FLOPS
    flops = rays * (n_depth - 1) * step * (2 if inward else 1)
    if not yardstick:
        flops += n_models * (n_depth - 1) * n_nu * KERNEL2_GAP_FLOPS
    flops += 2 * n_models * n_depth * n_nu * n_theta
    nbytes = (3 + (n_theta if tracked else 0)) * n_models * n_depth * n_nu * itemsize
    return bound(flops, nbytes)


def line_grad_bound(evaluations, n_models, n_lines, n_depth, n_out, itemsize,
                    yardstick=False):
    """Kernel 1b's bound: the value-and-derivative operations of Kernel 1's
    in-window evaluations and the per-pair work as its source does them
    (``yardstick``: as its first design did), or reading the [B, D, L]
    line arrays (three floats and the int32 window), the lines, the grid's
    range and the incoming gradient [B, D, n_out] once and writing three
    [B, D, L] gradients."""
    voigt, pair = ((GRAD_VOIGT_FLOPS_YARDSTICK, GRAD_PAIR_FLOPS_YARDSTICK) if yardstick
                   else (GRAD_VOIGT_FLOPS, GRAD_PAIR_FLOPS))
    pairs = n_models * n_depth * n_lines
    flops = sum(voigt[k] * v for k, v in evaluations.items()) + pair * pairs
    nbytes = (pairs * (3 * itemsize + 4) + n_lines * (itemsize + 4) + n_out * itemsize
              + n_models * n_depth * n_out * itemsize + 3 * pairs * itemsize)
    return bound(flops, nbytes)


def trace_grad_bound(n_models, n_depth, n_nu, n_theta, itemsize, inward, with_i,
                     yardstick=False):
    """Kernel 2b's bound: per gap of every ray the recomputed forward step
    and the reverse step (spherical: also the recomputed inward step and
    the reverse inward step), the staged mean extinction and the theta sums,
    or reading alpha, source and dL/dF_nu (and dL/dI_nu) once and writing
    the two gradients.  ``yardstick``: the first design's count, which read
    the saved intensity buffer too."""
    rays = n_models * n_nu * n_theta
    cells = n_models * n_depth * n_nu
    if yardstick:
        per_gap = TRACE_ADJ_STEP_FLOPS + (TRACE_STEP_FLOPS + TRACE_ADJ_STEP_FLOPS
                                          if inward else 0)
        flops = rays * (n_depth - 1) * per_gap + 3 * cells * n_theta
        nbytes = (5 * cells + cells * n_theta * (2 if with_i else 1)) * itemsize
        return bound(flops, nbytes)
    per_gap = KERNEL2_STEP_FLOPS + KERNEL2B_STEP_FLOPS
    if inward:
        per_gap += KERNEL2_STEP_FLOPS + KERNEL2B_INWARD_STEP_FLOPS
    flops = (rays * (n_depth - 1) * per_gap + n_models * (n_depth - 1) * n_nu * KERNEL2_GAP_FLOPS
             + (4 if inward else 2) * cells * n_theta + (3 if inward else 1) * cells
             + (cells * n_theta if with_i else 0))
    nbytes = (5 * cells + (cells * n_theta if with_i else 0)) * itemsize
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


def sync_ms(torch, fn, reps):
    """Median milliseconds of ``reps`` calls of ``fn``, each ended by
    ``torch.cuda.synchronize()`` (host clock), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[reps // 2] * 1e3


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
            if any(k in line for k in ("entry function", "registers", "spill")):
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

    def window_extremes(args32, iw):
        """The far wing and the window extremes, on a line set's float32
        inputs: (a) Doppler widths / 1000 and every window spanning the
        grid, so |x| runs to ~3e6; (b) half-windows of 1-3 pixels on half
        the pairs, the whole grid on the others.  {label: (args, iw)}"""
        n_nu = args32[0].shape[0]
        gen = torch.Generator(dev).manual_seed(6)
        short = torch.randint(1, 4, iw.shape, device=dev, dtype=iw.dtype, generator=gen)
        return {
            "far wing (Doppler / 1000, grid-wide windows)": (
                args32[:5] + (args32[5] * 1e-3,), torch.full_like(iw, n_nu + 1)),
            "half-windows of 1-3 pixels and grid-wide": (
                args32, torch.where(torch.rand(iw.shape, device=dev, generator=gen) < 0.5,
                                    short, torch.full_like(iw, n_nu + 1))),
        }, gen

    report = {}

    def log_walk(label, centers, iw_max, n_nu, evals):
        span = _cuda.load("line_opacity").line_opacity_span_pixels()
        walked = walked_triples(centers, iw_max, n_nu, span)
        inside = sum(evals.values())
        log(f"kernel 1 walk at {label}: {walked:.4e} (pixel, depth, line) triples walked by "
            f"blocks of {span} pixels, {inside:.4e} in a window ({inside / walked:.1%})")

    def trace_device_ms(*args, reps=20, **kw):
        """Kernel 2's device time per untracked launch (torch.profiler over
        ``reps`` launches): what the card spends, where CUDA events around a
        loop of calls also count the host's launch overhead."""
        solver.raytrace(*args, **kw)
        total_ms = kernel_device_ms(
            torch, lambda: [solver.raytrace(*args, **kw) for _ in range(reps)],
            ("trace_kernel",))["trace_kernel"]
        return total_ms / reps

    def check_trace_bits(label, args, kw, f_tracked, i_tracked):
        """Kernel 2's F_nu untracked (no intensity buffer written) equal bit
        for bit to the tracked launch's, and two launches of each equal."""
        f_u = solver.raytrace(*args, **kw)[0]
        f_u2 = solver.raytrace(*args, **kw)[0]
        f_t2, i_t2 = solver.raytrace(*args, track_individual_intensities=True, **kw)
        torch.cuda.synchronize()
        same = {"tracked == untracked F_nu": torch.equal(f_u, f_tracked),
                "two untracked launches": torch.equal(f_u, f_u2),
                "two tracked launches": torch.equal(f_t2, f_tracked)
                and torch.equal(i_t2, i_tracked)}
        log(f"{label}: equal bit for bit: {same}")
        if not all(same.values()):
            failures.append(f"{label}: not equal bit for bit: {same}")

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
        bit.  Returns the kernel's report entry when ``timed`` (float32):
        CUDA events around the wrapper, the profiler's device time, and the
        bound beside the first design's (yardstick)."""
        dtype = a.dtype
        n_depth, n_nu = a.shape
        gen = torch.Generator(dev).manual_seed(5)
        g_f = torch.randn((1, n_depth, n_nu), device=dev, dtype=dtype, generator=gen)
        g_i = torch.randn((1, n_depth, n_nu, len(w)), device=dev, dtype=dtype, generator=gen)
        corr_t = torch.full((1,), 1.0 if corr is None else corr, device=dev, dtype=dtype)
        args = (a[None], s[None], r[None], w, corr_t)
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
                dev_ms = kernel_device_ms(
                    torch, lambda: [solver.raytrace_grad_cuda(*args, g_f, None, inward)
                                    for _ in range(20)], ("trace_grad_kernel",))
                dev_ms = dev_ms["trace_grad_kernel"] / 20
                plain_ms = cuda_ms(torch, lambda: plain_of(a, s, r, w, g_f[0], g_int=None), 3)
                shape = (1, n_depth, n_nu, len(w), 4, inward, False)
                bound_ms, bound_by = trace_grad_bound(*shape)
                yard_ms, _ = trace_grad_bound(*shape, yardstick=True)
                tile, _, shared = solver.trace_grad_tile(n_depth, len(w), 4, inward)
                log(f"kernel 2b {'inward ' if inward else ''}f32 ({label}): kernel {ms:.4f} ms "
                    f"(device time {dev_ms:.4f} ms; {tile} frequencies x {len(w)} theta a "
                    f"block, {shared} B shared), plain {plain_ms:.3f} ms, max abs err "
                    f"{err:.3e}; bound {bound_ms:.4f} ms ({bound_by}; counted from the "
                    f"source), yardstick {yard_ms:.4f} ms (the first design's count)")
                entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                         "device_ms": dev_ms, "yardstick_bound_ms": yard_ms}
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
        again = kernel1(args, iw)
        torch.cuda.synchronize()
        same = torch.equal(kern, again)
        log(f"kernel 1 f32 full slice: two launches equal bit for bit: {same}")
        if not same:
            failures.append("kernel 1 f32 full slice: two launches differ")
        del again
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
        shape = (1, n_all, iw.shape[1], len(plan.tracing_nus), 4)
        yard_ms, _ = line_bound(evals, *shape)
        bound_ms, bound_by = kernel1_bound(evals, *shape)
        log(f"kernel 1 in-window evaluations by Voigt region: {evals}; bound {bound_ms:.3f} ms "
            f"({bound_by}; counted from the source), yardstick {yard_ms:.3f} ms (the first "
            "design's operations)")
        log_walk("Sim100AA", lk.line_center_indices(plan.tracing_nus, plan.line_data.nu),
                 iw.amax(dim=0).cpu().numpy(), len(plan.tracing_nus), evals)
        report["line_opacity"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": bound_ms, "bound_by": bound_by,
                                  "library_ms": None, "yardstick_bound_ms": yard_ms}
        del args, iw, kern, plain

        # the window extremes (phase 3b's input sets) on the subset's lines:
        # the float64 kernel and the plain version run on exact float64
        # copies of the float32 inputs; float64 at 1e-12 per element, the
        # float32 kernel at 1e-4 of each row's maximum of the float64 plain
        # sum (the plain float32 version's own error printed beside it);
        # two launches equal bit for bit
        args32, iw = line_inputs(torch.float32, subset.numpy())
        for label, (a32, iw_c) in window_extremes(args32, iw)[0].items():
            a64 = tuple(t.double() if t.is_floating_point() else t for t in a32)
            ref = lk.accumulate_line_opacity_plain(*a64, iw_c)
            errs = {}
            for name, a_c in (("f64", a64), ("f32", a32)):
                kern = kernel1(a_c, iw_c)
                again = kernel1(a_c, iw_c)
                torch.cuda.synchronize()
                same = torch.equal(kern, again)
                if name == "f64":
                    err = ((kern - ref).abs() / ref.abs().clamp_min(1e-300)).max().item()
                    ok = err <= 1e-12
                else:
                    err, rows_ok = row_err(kern.double(), ref)
                    ok = err <= 1e-4 and rows_ok
                errs[name] = err
                if not (ok and same):
                    failures.append(f"kernel 1 {name} {label}: err {err:.3e}, same {same}")
                del kern, again
            p32 = row_err(lk.accumulate_line_opacity_plain(*a32, iw_c).double(), ref)[0]
            log(f"kernel 1 {label} ({iw.shape[0]} lines x {iw.shape[1]} x "
                f"{args32[0].shape[0] // 1000}k) against the float64 plain sum: kernel f64 max "
                f"rel err {errs['f64']:.3e} (bound 1e-12), kernel f32 max row err / row max "
                f"{errs['f32']:.3e} (bound 1e-4), plain f32 {p32:.3e}; two launches equal bit "
                "for bit")
            del ref
        del args32, iw
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
                yard_ms, _ = line_grad_bound(evals, 1, n_lines, n_depth, n_nu, 4, yardstick=True)
                log(f"kernel 1b f32 full slice: kernel {ms:.3f} ms, plain {plain_ms:.0f} ms (one "
                    f"call), max abs err {err:.3e}; bound {bound_ms:.3f} ms ({bound_by}; counted "
                    f"from the source), yardstick {yard_ms:.3f} ms (the first design's count)")
                report["line_opacity_grad"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                               "bound_ms": bound_ms, "bound_by": bound_by,
                                               "library_ms": None, "yardstick_bound_ms": yard_ms}
                # the per-depth widest window of prepare_line_opacity (the JAX
                # package's block-max windows, line_kernel.py:221, :265): one
                # torch amax over [B, D, L] int32, bound by its bytes
                amax_ms = cuda_ms(torch, lambda: prep.iw.amax(dim=2), 20)
                amax_bytes = (prep.iw.numel() + prep.iw_max.numel()) * 4
                log(f"block-max windows (torch amax over {list(prep.iw.shape)} int32): "
                    f"{amax_ms:.4f} ms; bound {amax_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms (bytes)")
            del args, iw, prep, kern, again, plain

        # the far wing and the window extremes (window_extremes), on the
        # subset's lines (the plain float32 region-I derivative overflows
        # beyond |x| ~ 6e4 and rounds to 0 there).  The inputs are made in
        # float32; the float64 kernel and the plain version run
        # on their exact float64 copies, and the float32 kernel is held to
        # that float64 plain gradient (1e-4 of each depth's largest; the
        # plain float32 version's own error is printed beside it)
        args32, iw = line_inputs(torch.float32, subset.numpy())
        n_lines, n_depth = iw.shape
        n_nu = len(plan.tracing_nus)
        cases, gen = window_extremes(args32, iw)
        g32 = torch.randn((1, n_depth, n_nu), device=dev, generator=gen)
        for label, (a32, iw_c) in cases.items():
            a64 = tuple(t.double() if t.is_floating_point() else t for t in a32)
            ref = lk.accumulate_line_opacity_plain_backward(g32[0].double(), *a64, iw_c)
            errs = {}
            for name, a_c in (("f64", a64), ("f32", a32)):
                gin = g32.double() if name == "f64" else g32
                prep = lk.prepare_line_opacity(*a_c, iw_c)
                kern = lk.accumulate_line_opacity_grad_cuda(prep, gin, 0, n_nu)
                again = lk.accumulate_line_opacity_grad_cuda(prep, gin, 0, n_nu)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(kern, again))
                worst = max(row_err(k[0].double(), r.T)[0] for k, r in zip(kern, ref))
                row_bound = 1e-12 if name == "f64" else 1e-4
                errs[name] = worst
                if not (worst <= row_bound and same):
                    failures.append(f"kernel 1b {name} {label}: row err {worst:.3e}, same {same}")
                del prep, kern, again
            plain32 = lk.accumulate_line_opacity_plain_backward(g32[0], *a32, iw_c)
            p32 = [row_err(p.double().T, r.T)[0] for p, r in zip(plain32, ref)]
            log(f"kernel 1b {label} ({n_lines} lines x {n_depth} x {n_nu // 1000}k): max row "
                f"err / row max against the float64 plain gradient: kernel f64 {errs['f64']:.3e} "
                f"(bound 1e-12), kernel f32 {errs['f32']:.3e} (bound 1e-4), plain f32 d/dalpha, "
                f"d/dgamma, d/ddoppler {p32[0]:.3e}, {p32[1]:.3e}, {p32[2]:.3e}; two launches "
                "equal bit for bit")
            del ref, plain32
        del args32, iw, cases
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
            check_trace_bits(f"kernel 2 {name} (Sim100AA)", (total, source, ray, w), {}, fk, ik)
            if dtype == torch.float32:
                err = (fk - fp).abs().max().item()
                ms = cuda_ms(torch, lambda: solver.raytrace(total, source, ray, w), 20)
                tracked_ms = cuda_ms(torch, lambda: solver.raytrace(
                    total, source, ray, w, track_individual_intensities=True), 20)
                plain_ms = cuda_ms(torch, lambda: solver.raytrace_plain(total, source, ray, w), 5)
                dev_ms = trace_device_ms(total, source, ray, w)
                shape = (1, *total.shape, len(plan.weights), 4, False)
                bound_ms, bound_by = trace_bound(*shape)
                yard_ms, _ = trace_bound(*shape, yardstick=True)
                log(f"kernel 2 f32 full slice: kernel {ms:.4f} ms (device time {dev_ms:.4f} ms; "
                    f"I_nu stored: {tracked_ms:.4f} ms, bound "
                    f"{trace_bound(*shape, tracked=True)[0]:.4f} ms), plain {plain_ms:.3f} ms, max "
                    f"abs err {err:.3e}; bound {bound_ms:.4f} ms ({bound_by}), yardstick "
                    f"{yard_ms:.4f} ms")
                report["formal_solution"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                             "bound_ms": bound_ms, "bound_by": bound_by,
                                             "library_ms": None, "device_ms": dev_ms,
                                             "tracked_ms": tracked_ms,
                                             "yardstick_bound_ms": yard_ms}
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
            if dtype == torch.float32:
                # an untracked differentiated round trip (Kernel 2, then Kernel
                # 2b through autograd) allocates F_nu and the two gradients:
                # no [1, D, N, T] intensity saved, no partial buffer
                a_in = total[None].detach().clone().requires_grad_()
                s_in = source[None].detach().clone().requires_grad_()
                g_in = torch.randn(a_in.shape, device=dev, generator=torch.Generator(dev)
                                   .manual_seed(8))

                def round_trip():
                    f_nu, _ = solver.raytrace(a_in, s_in, ray[None], w)
                    return torch.autograd.grad(f_nu, (a_in, s_in), g_in)

                peak, grads = peak_bytes(torch, round_trip)
                io = 3 * a_in.numel() * a_in.element_size()
                buffer = a_in.numel() * len(w) * a_in.element_size()
                log(f"kernel 2b untracked round trip (Sim100AA, float32, Kernels 2 and 2b "
                    f"through autograd): peak {peak / 1e6:.3f} MB over its inputs, of which "
                    f"F_nu and the two gradients {io / 1e6:.3f} MB; beyond them "
                    f"{(peak - io) / 1e6:.3f} MB (bound: less than one [1, 56, 10k, 20] "
                    f"buffer, {buffer / 1e6:.1f} MB); gradients finite "
                    f"{all(bool(torch.isfinite(x).all()) for x in grads)}")
                if not (peak - io < buffer and all(torch.isfinite(x).all() for x in grads)):
                    failures.append(f"kernel 2b round trip allocates {peak - io} B beyond its "
                                    f"inputs and outputs (a buffer is {buffer} B)")
                del a_in, s_in, g_in, grads
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
                check_trace_bits(f"kernel 2 inward {name} ({label})", (a, s, r, w), kw, fk, ik)
                if dtype == torch.float32:
                    f32_errs.append((fk - fp).abs().max().item())
                if dtype == torch.float32 and label == "giant":
                    ms = cuda_ms(torch, lambda: solver.raytrace(a, s, r, w, **kw), 20)
                    tracked_ms = cuda_ms(torch, lambda: solver.raytrace(
                        a, s, r, w, track_individual_intensities=True, **kw), 20)
                    plain_ms = cuda_ms(
                        torch, lambda: solver.raytrace_plain(a, s, r, w, **kw), 5
                    )
                    dev_ms = trace_device_ms(a, s, r, w, **kw)
                    shape = (1, *a.shape, len(gplan.weights), 4, True)
                    bound_ms, bound_by = trace_bound(*shape)
                    yard_ms, _ = trace_bound(*shape, yardstick=True)
                    log(f"kernel 2 inward f32 giant: kernel {ms:.4f} ms (device time "
                        f"{dev_ms:.4f} ms; I_nu stored: {tracked_ms:.4f} ms), plain "
                        f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}), yardstick "
                        f"{yard_ms:.4f} ms")
                entry = check_trace_grad(f"giant {label}", a, s, r, w, corr, True,
                                         label == "giant")
                if entry:
                    report["formal_solution_grad_inward"] = entry
                del fk, ik, fp, ip
        del inputs, total, source
        report["formal_solution_inward"] = {
            "max_abs_err": max(f32_errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms": dev_ms, "tracked_ms": tracked_ms, "yardstick_bound_ms": yard_ms,
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
        from stardis_tpu_torch.parallel.batch import captured_stage1, make_batch, run_batch
        from stardis_tpu_torch.pipeline import validate_line_quants
        from stardis_tpu_torch.util import memory as mem

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
        log(f"batch profiled run (stage 1 replayed from its captured graph): wall "
            f"{p_wall:.4f} s, device busy {busy * 1e3:.2f} ms ({busy / p_wall:.1%} of the "
            f"wall), {ops} device ops")

        # stage 1 three ways: model by model (16 calls on 1-D inputs, the
        # way run_batch ran it before the model axis), one eager call over
        # the model axis, and a replay of the graph run_batch captured
        temps = torch.as_tensor(batch.temperatures, device=dev).to(torch.float32)
        n_elem = torch.as_tensor(batch.n_elem, device=dev).to(torch.float32)
        bconsts = device_constants(bplan, torch.float32, dev)
        graph = captured_stage1(bplan, BATCH_MODELS, torch.float32, dev)

        def stage1_replay():
            with graph.replay(batch.temperatures, batch.n_elem):
                pass

        stage1_ways = {
            "model by model": lambda: [stage_plasma_and_lines(bplan, temps[b], n_elem[b], bconsts)
                                       for b in range(BATCH_MODELS)],
            "one eager call": lambda: stage_plasma_and_lines(bplan, temps, n_elem, bconsts),
            "graph replay": stage1_replay,
        }
        for label, fn in stage1_ways.items():
            stage_ms = sync_ms(torch, fn, 5)
            p_wall, busy, ops = device_busy(torch, lambda: (fn(), torch.cuda.synchronize()))
            log(f"batch stage 1, {label}: {stage_ms:.3f} ms (median of 5, synchronised); "
                f"profiled: device busy {busy * 1e3:.3f} ms of {p_wall * 1e3:.3f} ms, "
                f"{ops} device ops")
        flat = lambda out: list(out[0]) + [x for t in out[1].values() for x in t]  # noqa: E731
        eager_out = flat(stage_plasma_and_lines(bplan, temps, n_elem, bconsts))
        with graph.replay(batch.temperatures, batch.n_elem) as out:
            same = all(torch.equal(a, b) for a, b in zip(flat(out), eager_out))
        log(f"batch stage 1: graph replay == eager call bit for bit ({len(eager_out)} "
            f"tensors): {same}")
        if not same:
            failures.append("batch stage 1: the graph replay differs from the eager call")
        n_cols = BATCH_MODELS * len(bplan.temperatures)
        planes = 3 * bplan.line_data.n_lines * n_cols * 4
        log(f"batch stage-1 graph pool: {graph.pool_bytes / 1e6:.3f} MB; util.memory's "
            f"stage-1 line planes (3 of LINE_ARRAYS, [{bplan.line_data.n_lines}, {n_cols}] "
            f"float32) {planes / 1e6:.3f} MB, all its {mem.LINE_ARRAYS} line planes "
            f"{mem.fixed_overhead_bytes(bplan) * BATCH_MODELS / 1e6:.3f} MB")

        def eager_batch():
            """run_batch's steps with the eager stage 1 in place of the graph."""
            consts = device_constants(bplan, torch.float32, dev)
            state, quants = stage_plasma_and_lines(bplan, temps, n_elem, consts)
            validate_line_quants(quants)
            lines = prepare_lines(bplan, state, quants, consts, batch.file_sigmas)
            f = spectrum_batch(bplan, state, lines, consts, batch.ray_distances,
                               batch.photospheric_correction, batch.file_sigmas)[0]
            torch.cuda.synchronize()
            return f

        eager_batch()
        eager_walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            f_eager = eager_batch()
            eager_walls.append(time.perf_counter() - t0)
        p_wall, busy, ops = device_busy(torch, eager_batch)
        log(f"batch without the graph (eager stage 1): walls "
            + ", ".join(f"{w:.4f}" for w in eager_walls)
            + f" s; {BATCH_MODELS / sorted(eager_walls)[1]:.1f} atmospheres/s (median) against "
            f"{BATCH_MODELS / wall:.1f} with the graph; profiled: device busy "
            f"{busy * 1e3:.2f} ms ({busy / p_wall:.1%} of {p_wall:.4f} s), {ops} device ops")
        same = torch.equal(f_batch, f_eager)
        log(f"batch F_nu: run_batch (graph) == the eager stage through the same spectrum "
            f"bit for bit: {same}")
        if not same:
            failures.append("batch F_nu: the graph run differs from the eager run")
        fp = batch_run(plain=True)
        rel, zeros_ok = rel_err(f_batch, fp)
        log(f"batch kernels vs plain versions: F_nu max rel err {rel:.3e} (bound 1e-4)")
        if not (rel <= 1e-4 and zeros_ok and torch.isfinite(f_batch).all()):
            failures.append(f"batch kernel vs plain rel err {rel:.3e}")
        # Kernel 1's own [16, D, N] output on the model axis, in both
        # window modes, against its plain version (phase 3's bound)
        states, quants = stage_plasma_and_lines(bplan, temps, n_elem, bconsts)
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
        del states, quants, ok, op, bconsts, graph, eager_out, f_eager
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
                                           mem.count_alpha_sources(mplan), 4,
                                           tracked=bool(mplan.track_individual_intensities))
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
                    f"{report['line_opacity']['bound_ms']:.3f} ms (yardstick "
                    f"{report['line_opacity']['yardstick_bound_ms']:.3f} ms)")
                if not (row <= 1e-4 and rows_ok):
                    failures.append(f"kernel 1 range launch f32 row err {row:.3e}")
                report["line_opacity_range"] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": report["line_opacity"]["bound_ms"],
                    "bound_by": report["line_opacity"]["bound_by"], "library_ms": None,
                    "yardstick_bound_ms": report["line_opacity"]["yardstick_bound_ms"],
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
            f"{mem.per_pixel_bytes(len(fplan.temperatures), len(fplan.weights), mem.count_alpha_sources(fplan), 4, tracked=False)} "
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
        whole = continuum_batch(fplan, state, nus_t, fconsts)
        parts = [continuum_batch(fplan, state, nus_t[a:b], fconsts, pixels=slice(a, b))
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
        f_shape = (1, fplan.line_data.n_lines, len(fplan.temperatures), FLAGSHIP_POINTS, 4)
        f_bound, f_by = kernel1_bound(evals, *f_shape)
        log(f"flagship Kernel 1 in-window evaluations by Voigt region: {evals}; bound "
            f"{f_bound:.3f} ms ({f_by}; counted from the source), yardstick "
            f"{line_bound(evals, *f_shape)[0]:.3f} ms; line_opacity stage "
            f"{timings['line_opacity'] * 1e3:.1f} ms")
        log_walk("flagship", lk.line_center_indices(fplan.tracing_nus, fplan.line_data.nu),
                 f_iw.amax(dim=0).cpu().numpy(), FLAGSHIP_POINTS, evals)
        g_shape = (evals, 1, fplan.line_data.n_lines, len(fplan.temperatures), FLAGSHIP_POINTS, 4)
        g_bound, g_by = line_grad_bound(*g_shape)
        g_yard, _ = line_grad_bound(*g_shape, yardstick=True)
        g_flag = torch.randn((1, len(fplan.temperatures), FLAGSHIP_POINTS), device=dev,
                             generator=torch.Generator(dev).manual_seed(7))

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
                same = torch.equal(kern, lk.line_opacity_range(kin, a, n_chk))
                if not same:
                    failures.append(f"flagship Kernel 1 {dtype} range at {a}: two launches differ")
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
                f"two launches equal bit for bit on each; plain {t_plain:.1f} s")
            del kern, plain

            # Kernel 1b at the flagship's shape: over the whole grid (timed,
            # float32), and on the same ranges against its plain version,
            # float64 at 1e-12 and float32 at 1e-4 of each depth's largest
            # gradient.  The float32 kernel is held to the plain version run
            # in float64 on its float32 inputs: a float32 sum of a deep
            # window's terms is itself off by up to ~5e-5 of the depth's
            # largest d/dD (the plain float32 version's own error, printed),
            # so two float32 sums in other orders differ by up to twice that
            g_d = g_flag.to(dtype)
            if dtype == torch.float32:
                grads = lk.accumulate_line_opacity_grad_cuda(kin, g_d, 0, FLAGSHIP_POINTS)
                again = lk.accumulate_line_opacity_grad_cuda(kin, g_d, 0, FLAGSHIP_POINTS)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(grads, again))
                finite = all(bool(torch.isfinite(x).all()) for x in grads)
                del grads, again
                g_ms = cuda_ms(torch, lambda: lk.accumulate_line_opacity_grad_cuda(
                    kin, g_d, 0, FLAGSHIP_POINTS), 2, warm=False)
                sched = lk.line_grad_schedule(kin.centers, kin.iw, FLAGSHIP_POINTS, 0,
                                              FLAGSHIP_POINTS, lk.line_grad_chunk(dtype))
                log(f"flagship Kernel 1b f32 over the whole grid ({fplan.line_data.n_lines} lines "
                    f"x 56 x {FLAGSHIP_POINTS}): {g_ms:.1f} ms; bound {g_bound:.3f} ms ({g_by}), "
                    f"yardstick {g_yard:.3f} ms; "
                    f"{sched.n_units} blocks of up to {sched.split_pixels} pixels; finite "
                    f"{finite}; two launches equal bit for bit: {same}")
                if not (same and finite):
                    failures.append(f"flagship Kernel 1b: same {same}, finite {finite}")
                del sched
            worst, worst_p32, t_plain = 0.0, 0.0, 0.0
            p64 = [t.double() if t.is_floating_point() else t
                   for t in (pin.grid, pin.line_nu, pin.centers, pin.alpha, pin.gamma,
                             pin.doppler, pin.iw)]
            for a in starts:
                g_r = g_d[:, :, a:a + n_chk].contiguous()
                kern = lk.accumulate_line_opacity_grad_cuda(kin, g_r, a, n_chk)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plain = lk.accumulate_line_opacity_plain_backward(
                    g_r.double(), *p64, budget=FLAGSHIP_PLAIN_BUDGET, p_begin=a, n_out=n_chk)
                torch.cuda.synchronize()
                t_plain += time.perf_counter() - t0
                errs = [row_err(k.double(), q.transpose(1, 2)) for k, q in zip(kern, plain)]
                err = max(e for e, _ in errs)
                worst = max(worst, err)
                if not (err <= (1e-12 if dtype == torch.float64 else 1e-4)
                        and all(ok for _, ok in errs)):
                    failures.append(f"flagship Kernel 1b {dtype} range at {a}: err {err:.3e}")
                if dtype == torch.float32:
                    plain32 = lk.accumulate_line_opacity_plain_backward(
                        g_r, pin.grid, pin.line_nu, pin.centers, pin.alpha, pin.gamma,
                        pin.doppler, pin.iw, budget=FLAGSHIP_PLAIN_BUDGET, p_begin=a,
                        n_out=n_chk)
                    worst_p32 = max(worst_p32, max(
                        row_err(q32.double().transpose(1, 2), q.transpose(1, 2))[0]
                        for q32, q in zip(plain32, plain)))
                    del plain32
            p32_note = (f"; the plain float32 version against it {worst_p32:.3e}"
                        if dtype == torch.float32 else "")
            log(f"flagship Kernel 1b {str(dtype)[6:]} vs the plain version in float64 on "
                f"{len(starts)} ranges: max row err / row max {worst:.3e} (bound "
                f"{1e-12 if dtype == torch.float64 else 1e-4:g}){p32_note}; plain {t_plain:.1f} s")
            del kin, pin, p64, kern, plain, g_d, g_r
        del c_d, st, qd, g_flag

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
        check_trace_bits("flagship Kernel 2 f32", (total, source, ray, w), {}, f_k, i_k)
        del i_k
        f_ms = cuda_ms(torch, lambda: solver.raytrace(total, source, ray, w), 5)
        f_tracked_ms = cuda_ms(torch, lambda: solver.raytrace(
            total, source, ray, w, track_individual_intensities=True), 5)
        shape = (1, *total.shape, len(fplan.weights), 4, False)
        log(f"flagship Kernel 2 f32 (56 x {FLAGSHIP_POINTS} x {len(fplan.weights)}): kernel "
            f"{f_ms:.3f} ms, I_nu stored {f_tracked_ms:.3f} ms; bound "
            f"{trace_bound(*shape)[0]:.4f} ms ({trace_bound(*shape)[1]}), I_nu stored "
            f"{trace_bound(*shape, tracked=True)[0]:.4f} ms, yardstick "
            f"{trace_bound(*shape, yardstick=True)[0]:.4f} ms; the unsegmented run_stardis "
            f"peaks at {peak_auto / 1e9:.4f} GB (K = {k_auto})")
        # phase 16 reuses fplan and spec_k
        del state, quants, fconsts, total, source, f_k
    except Exception as exc:  # noqa: BLE001
        failures.append(f"flagship phase: {exc!r}")

    # --- 11. serving ----------------------------------------------------------
    try:
        from stardis_tpu_torch.base import read_stellar_model
        from stardis_tpu_torch.pipeline import elemental_densities, model_geometry
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
            + ", ".join(f"{w:.4f}" for w in svc_walls) + " s (stage 1 replayed from the "
            "service's captured graph, pool "
            f"{svc._stage1.pool_bytes / 1e6:.3f} MB); warm run_stardis walls "
            + ", ".join(f"{w:.4f}" for w in run_walls) + f" s; stats {svc.stats}")
        if not worst <= 1e-5:
            failures.append(f"serving against run_stardis rel err {worst:.3e}")
        # each request against the service's plan run with the eager stage 1
        for teff, m, out in zip(SERVE_TEFFS, s_models, served):
            state, lq = stage_plasma_and_lines(
                svc._plan, torch.as_tensor(np.asarray(m.temperatures), device=dev).float(),
                torch.as_tensor(elemental_densities(m, svc._plan.tables), device=dev).float(),
                svc._consts)
            rays = model_geometry(m, svc._thetas)[0]
            f_eager = stage_spectrum(svc._plan, state, lq, svc._consts,
                                     ray_distances=rays)[0].cpu().numpy()
            same = bool(np.array_equal(out["F_nu"], f_eager))
            log(f"served {teff:.0f} K request == the eager stage 1 through the same "
                f"spectrum bit for bit: {same}")
            if not same:
                failures.append(f"served {teff:.0f} K request differs from the eager stage")
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
        # "line_opacity_grad" sums Kernel 1b's two passes
        dev_ms = kernel_device_ms(torch, step_walls, ("line_opacity_grad",
                                                      "trace_grad_kernel",
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
        # a caller's process-wide TF32 switch on: the float32 fit gradient at
        # N_LINES_PLAIN_CHECK lines against the all-plain float64 path, beside
        # the same with the switch off (the bf and broadening products run in
        # full float32, forward and backward, either way)
        spec32 = fit_model(plan_small, torch.float32)
        obs32 = spec32(torch.tensor(FIT_TRUE, device=dev))[0].detach()
        g_tf32 = {}
        tf32_kept = torch.backends.cuda.matmul.allow_tf32
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                q = start.clone().requires_grad_()
                g_tf32[tf32] = torch.autograd.grad(fit_loss(spec32, obs32, q)[0], q)[0]
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32_kept
        tf32_rel = {k: ((v.double() - grads[1]).abs() / grads[1].abs()).tolist()
                    for k, v in g_tf32.items()}
        log(f"fit gradient float32 at {N_LINES_PLAIN_CHECK} lines against the all-plain float64 "
            "path, rel diff per parameter: TF32 switch off "
            + ", ".join(f"{x:.3e}" for x in tf32_rel[False]) + "; on "
            + ", ".join(f"{x:.3e}" for x in tf32_rel[True])
            + f"; on == off bit for bit: {torch.equal(g_tf32[False], g_tf32[True])}")
        if not all(np.isfinite(v).all() for v in tf32_rel.values()):
            failures.append(f"fit gradient with the TF32 switch on: {tf32_rel}")
        if not torch.equal(g_tf32[False], g_tf32[True]):
            failures.append("fit gradient float32: the TF32 switch changed it: "
                            f"{g_tf32[False].tolist()} off, {g_tf32[True].tolist()} on")
        del spectrum, spec64, spec_s, spec32, observed, obs64, obs_s, obs32
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

    # --- 14. the JAX package's golden stores, run on the card ------------------
    # the configurations of tests/test_golden_regression.py and
    # tests/test_golden_plasma.py on this script's MARCS sun (the stores'
    # own); float64 at the stores' rtol, float32 at util.regression's bars
    try:
        from stardis_tpu_torch.util.regression import (
            GOLDEN_RTOL,
            RegressionData,
            f32_kind,
            f32_ratio,
            golden_arrays,
            golden_ratio,
        )

        golden_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden")
        reset_counts()
        for key in GOLDEN_STORES:
            store = RegressionData(golden_dir, key, rtol=GOLDEN_RTOL)
            for dtype in (torch.float64, torch.float32):
                arrays = golden_arrays(key, model_path, "cuda", dtype)
                if sorted(arrays) != sorted(store.keys()):
                    failures.append(f"golden {key}: arrays {sorted(arrays)} against the "
                                    f"store's {sorted(store.keys())}")
                    continue
                ratios = {}
                for name, value in arrays.items():
                    ref = store[name]
                    if dtype == torch.float64:
                        ratios[name] = (f"rtol {GOLDEN_RTOL:g}", golden_ratio(value, ref))
                    else:
                        ratios[name] = (f32_kind(name), f32_ratio(name, value, ref))
                bad = {k: v for k, v in ratios.items() if not v[1] <= 1.0}
                log(f"golden {key} on the card, {str(dtype)[6:]}: worst error / bar by array "
                    f"(bar): " + ", ".join(f"{k} {r:.3e} ({bar})" for k, (bar, r) in
                                           sorted(ratios.items())))
                if bad:
                    failures.append(f"golden {key} {dtype}: beyond the bar: {bad}")
        launches = path_launches["golden stores"] = read_counts()
        if launches["line_opacity"] < 1 or launches["formal_solution"] < 1:
            failures.append(f"golden stores: a kernel was not launched: {launches}")
    except Exception as exc:  # noqa: BLE001
        failures.append(f"golden store phase: {exc!r}")

    # --- 15. a MESA model and a VALD text line list at Sim100AA's width -------
    try:
        from stardis_tpu_torch import native
        from stardis_tpu_torch.io.synthetic import write_mesa_file, write_vald_linelist

        mesa_path = os.path.join(tmp.name, "sun_mesa.mod")
        write_mesa_file(mesa_path, n_shells=MESA_SHELLS)
        lines = synth_linelist(build_builtin_atom_data(30), N_LINES).linelist_atoms
        vald = {"long": os.path.join(tmp.name, "vald_long.txt"),
                "short": os.path.join(tmp.name, "vald_short.txt")}
        t0 = time.perf_counter()
        write_vald_linelist(vald["long"], lines)
        write_vald_linelist(vald["short"], lines, shortlist=True)
        log(f"MESA+VALD: wrote {MESA_SHELLS} MESA shells and {N_LINES} lines as long and "
            f"short VALD text ({time.perf_counter() - t0:.2f} s)")
        t0 = time.perf_counter()
        native._load_library()  # g++ at first use, kept out of the parse times
        log(f"MESA+VALD: native parser built and loaded in {time.perf_counter() - t0:.2f} s")
        for form, path in vald.items():
            for use_native in (True, False):
                t0 = time.perf_counter()
                table, is_short = native.read_vald_linelist(path, use_native=use_native)
                parse_s = time.perf_counter() - t0
                same = all(np.array_equal(table[c], lines[c]) for c in table.columns)
                log(f"MESA+VALD: {form} file parsed by {native.LAST_PARSER} in {parse_s:.3f} s "
                    f"(host); {len(table)} lines, shortlist {is_short}, columns equal to the "
                    f"in-memory list bit for bit: {same}")
                want = "native" if use_native else "python"
                if not (same and native.LAST_PARSER == want and len(table) == N_LINES
                        and is_short == (form == "short")):
                    failures.append(f"VALD {form} parse by {want}: parser "
                                    f"{native.LAST_PARSER}, equal {same}, short {is_short}")

        def mesa_config(vald_path=None):
            cfg = sim100aa_config(mesa_path)
            cfg["input_model"]["type"] = "mesa"
            if vald_path is not None:
                cfg["opacity"]["line"]["vald_linelist"]["fname"] = vald_path
            return cfg

        def file_run(form="long"):
            out = run_stardis(mesa_config(vald[form]), lam_q, device="cuda",
                              dtype=torch.float32)
            torch.cuda.synchronize()
            return out

        file_run()  # first call: the parser's build and allocator warm-up
        reset_counts()
        t0 = time.perf_counter()
        spec = file_run().spectrum_nu.value
        wall = time.perf_counter() - t0
        launches = path_launches["MESA+VALD"] = read_counts()
        mem_adata = build_builtin_atom_data(30, include_linelists=True, include_molecules=True)
        mem_adata.linelist_atoms = lines
        spec_mem = run_stardis(mesa_config(), lam_q, device="cuda", dtype=torch.float32,
                               atom_data=mem_adata).spectrum_nu.value
        same = bool(np.array_equal(spec, spec_mem))
        log(f"MESA+VALD: run_stardis(device='cuda', float32), {MESA_SHELLS} shells, "
            f"{N_LINES} lines from the VALD file: warm wall {wall:.3f} s (parse included); "
            f"launches {launches}; F_nu[surface] min {spec.min():.4e}, max {spec.max():.4e}; "
            f"equal bit for bit to the lines handed over in memory: {same}")
        if not (spec.shape == (len(lams),) and np.isfinite(spec).all() and (spec > 0).all()
                and same):
            failures.append(f"MESA+VALD F_nu not finite and positive, or file != memory ({same})")
        if launches["line_opacity"] < 1 or launches["formal_solution"] < 1:
            failures.append(f"MESA+VALD: a kernel was not launched: {launches}")
        short_cfg = parse_config_to_model(mesa_config(vald["short"]))[0]
        spec_short = file_run("short").spectrum_nu.value
        flagged = bool(short_cfg.opacity.line.vald_linelist.shortlist)
        log(f"MESA+VALD shortlist: shortlist flag set {flagged}; F_nu[surface] min "
            f"{spec_short.min():.4e}, max {spec_short.max():.4e}")
        if not (flagged and np.isfinite(spec_short).all() and (spec_short > 0).all()):
            failures.append(f"MESA+VALD shortlist: flag {flagged}, F_nu not finite and positive")
        p_wall, busy, ops = device_busy(torch, file_run)
        log(f"MESA+VALD profiled run: wall {p_wall:.4f} s, device busy {busy * 1e3:.2f} ms "
            f"({busy / p_wall:.1%} of the wall), {ops} device ops")

        check_adata = synth_linelist(build_builtin_atom_data(30, include_linelists=True),
                                     N_LINES_PLAIN_CHECK)
        config, check_adata, model = parse_config_to_model(mesa_config(), atom_data=check_adata)
        mplan = build_simulation_plan(config, check_adata, model, nus)
        fk = run_simulation(mplan, device=dev, dtype=torch.float32)[0]
        fp = run_simulation(mplan, device=dev, dtype=torch.float32, plain=True)[0]
        torch.cuda.synchronize()
        rel, zeros_ok = rel_err(fk, fp)
        log(f"MESA+VALD at {N_LINES_PLAIN_CHECK} lines: kernel path vs all-plain path F_nu "
            f"max rel err {rel:.3e} (bound 1e-4)")
        if not (rel <= 1e-4 and zeros_ok and torch.isfinite(fk).all()):
            failures.append(f"MESA+VALD kernel vs plain rel err {rel:.3e}")
        del mplan
    except Exception as exc:  # noqa: BLE001
        failures.append(f"MESA+VALD phase: {exc!r}")

    # --- 16. the sharded paths on a mesh of one repeated card --------------------
    try:
        from stardis_tpu_torch.grid import synthesize_grid
        from stardis_tpu_torch.parallel.batch import run_batch
        from stardis_tpu_torch.parallel.sharding import (
            Mesh,
            make_batch_nu_mesh,
            make_nu_mesh,
            shard_eval_stats,
            shard_spectrum,
        )
        from stardis_tpu_torch.serving import SpectralService

        card0 = torch.device("cuda", 0)
        mesh = make_nu_mesh(devices=[card0] * MESH_SHARDS)

        def bits(label, ours, ref):
            same = (torch.equal(ours, ref) if torch.is_tensor(ours)
                    else bool(np.array_equal(ours, ref)))
            log(f"{label}: equal bit for bit: {same}")
            if not same:
                failures.append(f"{label}: not equal bit for bit")

        def stage1(mplan):
            consts = device_constants(mplan, torch.float32, dev)
            return (*stage_plasma_and_lines(
                mplan, torch.as_tensor(mplan.temperatures, device=dev).to(torch.float32),
                torch.as_tensor(mplan.n_elem, device=dev).to(torch.float32), consts), consts)

        # Sim100AA: run_stardis on the mesh (warm wall beside the unsharded
        # run's), F_nu [D, N] against the unsharded run and K segments
        sim_cfg = sim100aa_config(model_path)
        sim_adata = synth_linelist(build_builtin_atom_data(30, include_linelists=True), N_LINES)

        def sim_run(**kw):
            out = run_stardis(sim_cfg, lam_q, atom_data=sim_adata, **kw)
            torch.cuda.synchronize()
            return out

        sim_run(mesh=mesh)  # warm-up
        reset_counts()
        t0 = time.perf_counter()
        sim_mesh = sim_run(mesh=mesh)
        wall_mesh = time.perf_counter() - t0
        launches = path_launches["Sim100AA mesh"] = read_counts()
        t0 = time.perf_counter()
        sim_one = sim_run()
        wall_one = time.perf_counter() - t0
        if not (launches["line_opacity_range"] == MESH_SHARDS
                and launches["formal_solution"] == MESH_SHARDS):
            failures.append(f"Sim100AA mesh: launches {launches}")
        bits(f"phase 16 Sim100AA run_stardis(mesh={MESH_SHARDS} x cuda:0) spectrum vs unsharded",
             sim_mesh.spectrum_nu.value, sim_one.spectrum_nu.value)
        f_mesh = run_simulation(plan, device=dev, mesh=mesh)[0]
        bits("phase 16 Sim100AA F_nu [D, N] on the mesh vs unsharded", f_mesh,
             run_simulation(plan, device=dev)[0])
        bits(f"phase 16 Sim100AA F_nu [D, N] on the mesh vs nu_segments={MESH_SHARDS}", f_mesh,
             run_simulation(plan, device=dev, nu_segments=MESH_SHARDS)[0])
        s_state, s_quants, s_consts = stage1(plan)
        walls = []
        shard_spectrum(plan, s_state, s_quants, mesh, s_consts, shard_walls=walls)
        log(f"phase 16 Sim100AA: run_stardis warm wall on the mesh {wall_mesh:.4f} s, unsharded "
            f"{wall_one:.4f} s; launches {launches}; shard device times (CUDA events) "
            + ", ".join(f"{w * 1e3:.3f}" for w in walls) + " ms")
        del sim_mesh, sim_one, f_mesh

        # the flagship on the mesh: against phase 10's K = 4 run
        f_state, f_quants, f_consts = stage1(fplan)

        def flagship_mesh_run():
            out = run_stardis(f_cfg, f_lam, device="cuda", dtype=torch.float32,
                              atom_data=f_adata, mesh=mesh)
            torch.cuda.synchronize()
            return out

        reset_counts()
        t0 = time.perf_counter()
        flagship_mesh_run()
        cold = time.perf_counter() - t0
        launches = path_launches["flagship mesh"] = read_counts()
        t0 = time.perf_counter()
        spec_mesh = flagship_mesh_run().spectrum_nu.value
        warm = time.perf_counter() - t0
        bits(f"phase 16 flagship run_stardis(mesh={MESH_SHARDS} x cuda:0) spectrum vs phase 10's "
             f"K = {FLAGSHIP_SEGMENTS}", spec_mesh, spec_k)
        if not (launches["line_opacity_range"] == MESH_SHARDS
                and launches["formal_solution"] == MESH_SHARDS):
            failures.append(f"flagship mesh: launches {launches}")
        walls = []
        f_mesh = shard_spectrum(fplan, f_state, f_quants, mesh, f_consts, shard_walls=walls)
        bits(f"phase 16 flagship F_nu [D, N] shard_spectrum vs segmented_spectrum "
             f"K = {MESH_SHARDS}", f_mesh,
             segmented_spectrum(fplan, f_state, f_quants, MESH_SHARDS, f_consts))
        del f_mesh
        log(f"phase 16 flagship on the mesh: run_stardis cold wall {cold:.3f} s, warm wall "
            f"{warm:.3f} s; launches {launches}; shard device times (CUDA events) "
            + ", ".join(f"{w:.4f}" for w in walls) + " s")
        f_lines = prepare_lines(fplan, [f_state], [f_quants], f_consts)
        stats = {n: shard_eval_stats(f_lines, FLAGSHIP_POINTS, n) for n in (MESH_SHARDS, 8)}
        for n, st in stats.items():
            log(f"phase 16 flagship shard_eval_stats, {n} shards: in-window evaluations per "
                f"shard {st['per_shard_evals']}, unsharded {st['unsharded_evals']}, "
                f"efficiency {st['efficiency']:.4f}")
        del f_lines
        alpha, gamma, doppler = f_quants["atomic"]
        f_iw = lk.window_half_widths(alpha, gamma, doppler, fplan.d_nu, FLAGSHIP_POINTS)
        host = [x.double().cpu().numpy() for x in (gamma, doppler)] + [f_iw.cpu().numpy()]
        centres = lk.line_center_indices(fplan.tracing_nus, fplan.line_data.nu)
        n_lines, n_depth, n_theta = fplan.line_data.n_lines, len(fplan.temperatures), len(fplan.weights)
        for s_i, (a, b) in enumerate(segment_ranges(FLAGSHIP_POINTS, MESH_SHARDS)):
            ev = voigt_evaluations(fplan.tracing_nus, fplan.line_data.nu, centres, *host,
                                   pixels=(a, b))
            k1_ms, k1_by = kernel1_bound(ev, 1, n_lines, n_depth, b - a, 4)
            k2_ms, k2_by = trace_bound(1, n_depth, b - a, n_theta, 4, False)
            log(f"phase 16 flagship shard {s_i} [{a}, {b}): Kernel 1 in-window evaluations by "
                f"region {ev}, bound {k1_ms:.3f} ms ({k1_by}; counted from the source), Kernel 2 "
                f"bound {k2_ms:.4f} ms ({k2_by}); device time {walls[s_i]:.4f} s")
            if sum(ev.values()) != stats[MESH_SHARDS]["per_shard_evals"][s_i]:
                failures.append(f"flagship shard {s_i}: region counts {sum(ev.values())} vs "
                                f"shard_eval_stats {stats[MESH_SHARDS]['per_shard_evals'][s_i]}")
        del alpha, gamma, doppler, f_iw, host, f_state, f_quants, f_consts
        log(f"phase 16 flagship FORECAST, not a measurement: a {MESH_SHARDS}-card wall of "
            f"{warm - sum(walls) + max(walls):.3f} s (this warm wall {warm:.3f} s less the "
            f"{MESH_SHARDS} shards' serial device time {sum(walls):.3f} s plus the slowest "
            f"shard's {max(walls):.3f} s; no peer copy or gather cost counted)")

        # the 16-model batch on a 1-D batch mesh and on a 2 x 2 mesh
        for label, bmesh in (("1-D batch mesh of 4", Mesh([card0] * 4, ("batch",))),
                             ("2 x 2 batch x nu mesh", make_batch_nu_mesh(2, 2, [card0] * 4))):
            run_batch(bplan, batch, mesh=bmesh, dtype=torch.float32)  # warm-up
            reset_counts()
            t0 = time.perf_counter()
            f_m = run_batch(bplan, batch, mesh=bmesh, dtype=torch.float32)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = path_launches[f"batch, {label}"] = read_counts()
            log(f"phase 16 batch on the {label}: warm wall {wall:.4f} s "
                f"({BATCH_MODELS / wall:.1f} atmospheres/s); launches {launches}")
            bits(f"phase 16 16-model batch on the {label} vs unsharded", f_m, f_batch)
        del f_m

        # SpectralService on the mesh against phase 11's unsharded service
        msvc = SpectralService(s_cfg, lam_q, atom_data=s_adata, mesh=mesh)
        reset_counts()
        served_m = [msvc.synthesize(m) for m in s_models]
        launches = path_launches["serving mesh"] = read_counts()
        log(f"phase 16 serving on the mesh: launches {launches}")
        for teff, ours, ref in zip(SERVE_TEFFS, served_m, served):
            bits(f"phase 16 served {teff:.0f} K request on the mesh vs unsharded service",
                 ours["F_nu"], ref["F_nu"])
        del msvc, served_m

        # a 2-chunk grid scan on a 2 x 2 mesh against phase 12's
        mscan = os.path.join(tmp.name, "scan_mesh")
        reset_counts()
        r_m = synthesize_grid(config_b, b_adata, models, b_nus, mscan, batch_size=8,
                              mesh=make_batch_nu_mesh(2, 2, [card0] * 4))
        path_launches["grid scan mesh"] = read_counts()
        if not (r_m["computed"] == 2 and r_m["done"]):
            failures.append(f"grid scan on the mesh: {r_m}")
        for ci in range(2):
            name = f"chunk_{ci:05d}.npz"
            with np.load(os.path.join(mscan, name)) as ours, \
                    np.load(os.path.join(fresh, name)) as ref:
                if not np.array_equal(ours["idx"], ref["idx"]):
                    failures.append(f"grid scan on the mesh: {name} holds other models")
                bits(f"phase 16 grid scan on a 2 x 2 mesh, {name} vs phase 12's",
                     ours["spectrum"], ref["spectrum"])

        # several cards: a mesh over all of them, and each kernel launched on
        # cuda:1 while cuda:0 is current
        n_cards = torch.cuda.device_count()
        if n_cards >= 2:
            bits(f"phase 16 Sim100AA F_nu on a mesh over {n_cards} cards vs one card "
                 f"(nu_segments={n_cards})", run_simulation(plan, device=dev, mesh=make_nu_mesh())[0],
                 run_simulation(plan, device=dev, nu_segments=n_cards)[0])
            torch.cuda.set_device(0)
            _, total, _, _ = stage_spectrum(plan, s_state, s_quants, s_consts)
            source = blackbody_flux_at_nu(s_consts.tracing_nus, s_state.t)
            args, iw = line_inputs(torch.float32)
            gen = torch.Generator(dev).manual_seed(16)
            g = torch.randn((1, *total.shape), device=dev, generator=gen)
            trace_in = (total[None], source[None],
                        torch.as_tensor(plan.ray_distances, device=dev).to(torch.float32)[None],
                        torch.as_tensor(plan.weights, device=dev).to(torch.float32))

            def kernels(device):
                prep = lk.prepare_line_opacity(*(x.to(device) for x in args), iw.to(device))
                tr = [x.to(device).contiguous() for x in trace_in]
                corr = torch.ones(1, device=device)
                return [lk.line_opacity_range(prep),
                        *lk.accumulate_line_opacity_grad_cuda(prep, g.to(device), 0, g.shape[-1]),
                        *solver.raytrace(*tr, track_individual_intensities=True),
                        *solver.raytrace_grad_cuda(*tr, corr, g.to(device), None, False)]

            ref = kernels(card0)
            other = kernels(torch.device("cuda", 1))
            torch.cuda.synchronize(0)
            torch.cuda.synchronize(1)
            names = ("Kernel 1", "Kernel 1b d/dalpha", "d/dgamma", "d/ddoppler", "Kernel 2 F_nu",
                     "I_nu", "Kernel 2b d/dalpha", "d/dsource")
            same = {n: torch.equal(a, b.to(card0)) for n, a, b in zip(names, ref, other)}
            log(f"phase 16 kernels on cuda:1 with cuda:0 current (device {torch.cuda.current_device()}) "
                f"vs cuda:0: {same}")
            if not (all(same.values()) and torch.cuda.current_device() == 0):
                failures.append(f"kernels on cuda:1: {same}")
            del ref, other, total, source, trace_in
        else:
            log("phase 16: the multi-card checks were skipped for want of a second card "
                f"(torch.cuda.device_count() = {n_cards}): peer copies, launches on a second "
                "device and NCCL stay unverified on this machine")
        del s_state, s_quants, s_consts
    except Exception as exc:  # noqa: BLE001
        failures.append(f"mesh phase: {exc!r}")
    # --- 17. the rest of the host surface ------------------------------------------
    t_phase17 = time.perf_counter()
    try:
        import glob
        import logging

        from stardis_tpu_torch.atom_data.convert import convert_frames
        from stardis_tpu_torch.atom_data.synthetic_carsus import build_carsus_frames
        from stardis_tpu_torch.radiation_field import create_stellar_radiation_field
        from stardis_tpu_torch.util.profiling import device_trace
        from stardis_tpu_torch.util.regression import (
            GOLDEN_RTOL,
            RegressionData,
            f32_kind,
            f32_ratio,
            golden_arrays,
            golden_ratio,
        )

        def sim100aa_atom_data():
            return synth_linelist(build_builtin_atom_data(30, include_linelists=True), N_LINES)

        # (a) create_stellar_radiation_field against run_stardis, permuted
        rf_cfg = sim100aa_config(model_path)
        rf_cfg["result_options"] = {"return_radiation_field": True}
        out = run_stardis(rf_cfg, lam_q, device="cuda", dtype=torch.float32,
                          atom_data=sim100aa_atom_data())
        field = out.stellar_radiation_field
        grid = np.asarray(field.frequencies)
        rf_config, rf_adata, rf_model = parse_config_to_model(rf_cfg,
                                                              atom_data=sim100aa_atom_data())
        callers = {"ascending": np.sort(nus),
                   "shuffled": np.random.default_rng(17).permutation(np.sort(nus))}
        create_stellar_radiation_field(callers["ascending"], rf_model, rf_adata, rf_config)
        torch.cuda.synchronize()
        reset_counts()
        rf_walls, rf_same = {}, {}
        for label, caller in callers.items():
            t0 = time.perf_counter()
            rf = create_stellar_radiation_field(caller, rf_model, rf_adata, rf_config)
            torch.cuda.synchronize()
            rf_walls[label] = time.perf_counter() - t0
            perm = torch.as_tensor(np.searchsorted(-grid, -caller), device=dev)
            rf_same[label] = {
                "frequencies": bool(np.array_equal(grid[perm.cpu().numpy()], caller)),
                "F_nu": torch.equal(rf.F_nu, field.F_nu[:, perm]),
                "total": torch.equal(rf.opacities.total_alphas,
                                     field.opacities.total_alphas[:, perm]),
                "I_nu": torch.equal(rf.I_nus, field.I_nus[:, perm]),
            }
        launches = path_launches["radiation field"] = read_counts()
        del rf, field, out
        for label, same in rf_same.items():
            log(f"phase 17 create_stellar_radiation_field (Sim100AA, {N_LINES} lines, I_nu "
                f"tracked), caller's frequencies {label}: warm wall {rf_walls[label]:.4f} s; "
                f"equal bit for bit to run_stardis permuted: {same}")
            if not all(same.values()):
                failures.append(f"create_stellar_radiation_field {label}: {same}")
        log(f"phase 17 create_stellar_radiation_field launches (both calls): {launches}")
        if launches["line_opacity"] < 1 or launches["formal_solution"] < 1:
            failures.append(f"radiation field: a kernel was not launched: {launches}")

        # (b) a warm Sim100AA run_stardis inside device_trace; the stages it logs
        def sim100aa_run():
            out = run_stardis(sim100aa_config(model_path), lam_q, device="cuda",
                              dtype=torch.float32, atom_data=sim100aa_atom_data())
            torch.cuda.synchronize()
            return out

        class Stages(logging.Handler):
            def __init__(self):
                super().__init__(logging.INFO)
                self.messages = []

            def emit(self, record):
                self.messages.append(record.getMessage())

        trace_dir = os.path.join(tmp.name, "trace")
        sim100aa_run()
        stage_log = Stages()
        prof_logger = logging.getLogger("stardis_tpu_torch.util.profiling")
        level = prof_logger.level
        prof_logger.setLevel(logging.INFO)
        prof_logger.addHandler(stage_log)
        reset_counts()
        try:
            with device_trace(trace_dir):
                t0 = time.perf_counter()
                sim100aa_run()
                wall = time.perf_counter() - t0
        finally:
            prof_logger.removeHandler(stage_log)
            prof_logger.setLevel(level)
        launches = path_launches["Sim100AA traced"] = read_counts()
        traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
        with open(traces[0]) as fh:
            events = json.load(fh)["traceEvents"]
        kernel_events = [e for e in events if e.get("cat") == "kernel"]
        trace_ms = {
            "line_opacity": sum(e["dur"] for e in kernel_events if "line_opacity" in e["name"]
                                and "grad" not in e["name"]) * 1e-3,
            "formal_solution": sum(e["dur"] for e in kernel_events
                                   if "trace_kernel" in e["name"]
                                   and "grad" not in e["name"]) * 1e-3,
        }
        prof_ms = kernel_device_ms(torch, sim100aa_run, ("line_opacity_kernel", "trace_kernel"))
        stages = {}
        for msg in stage_log.messages:
            for name, secs in (part.split(": ") for part in msg.split("stage timings: ", 1)[-1]
                               .split(" | ") if part.endswith("s") and ": " in part):
                if name in ("plan", "solve"):
                    stages[name] = float(secs[:-1])
        log(f"phase 17 device_trace: {len(traces)} trace file(s), {len(kernel_events)} kernel "
            "events; "
            f"Kernel 1 (line_opacity) {trace_ms['line_opacity']:.4f} ms, Kernel 2 "
            f"(trace_kernel) {trace_ms['formal_solution']:.4f} ms from the trace; "
            f"kernel_device_ms of a second run {prof_ms['line_opacity_kernel']:.4f} ms, "
            f"{prof_ms['trace_kernel']:.4f} ms; launches {launches}")
        log(f"phase 17 run_stardis stages (its log, 3 decimals): {stages}, sum "
            f"{sum(stages.values()):.3f} s, warm wall under the trace {wall:.4f} s")
        if not (len(traces) == 1 and trace_ms["line_opacity"] > 0
                and trace_ms["formal_solution"] > 0):
            failures.append(f"device_trace: files {traces}, kernel ms {trace_ms}")
        # each logged stage is rounded to the millisecond
        if not (sorted(stages) == ["plan", "solve"] and sum(stages.values()) <= wall + 1e-3):
            failures.append(f"run_stardis stages {stages} against the wall {wall:.4f} s")

        # (c) the kurucz-scale store, built and converted in memory
        t0 = time.perf_counter()
        frames = build_carsus_frames()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        carsus = convert_frames(frames)
        convert_s = time.perf_counter() - t0
        log(f"phase 17 carsus store in memory: build_carsus_frames {build_s:.3f} s, "
            f"convert_frames {convert_s:.3f} s (host); {len(carsus.lines)} lines, "
            f"{len(carsus.linelist_atoms)} VALD lines, {len(carsus.levels)} levels, Z "
            f"{carsus.atom_data.atomic_number.min()}-{carsus.atom_data.atomic_number.max()}, "
            f"molecules {carsus.molecule_data is not None}")
        if not (len(carsus.lines) == CARSUS_LINES and len(carsus.linelist_atoms) ==
                CARSUS_VALD_LINES and carsus.molecule_data is not None):
            failures.append("carsus store: not the kurucz-scale sizes")
        golden_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden")
        store = RegressionData(golden_dir, "carsus_scale", rtol=GOLDEN_RTOL)
        reset_counts()
        for dtype in (torch.float64, torch.float32):
            arrays = golden_arrays("carsus_scale", model_path, "cuda", dtype,
                                   atom_data=copy.deepcopy(carsus))
            if sorted(arrays) != sorted(store.keys()):
                failures.append(f"golden carsus_scale: arrays {sorted(arrays)}")
                continue
            if dtype == torch.float64:
                ratios = {k: (f"rtol {GOLDEN_RTOL:g}", golden_ratio(v, store[k]))
                          for k, v in arrays.items()}
            else:
                ratios = {k: (f32_kind(k), f32_ratio(k, v, store[k])) for k, v in arrays.items()}
            log(f"phase 17 golden carsus_scale on the card, {str(dtype)[6:]}: worst error / bar "
                "by array (bar): " + ", ".join(f"{k} {r:.3e} ({bar})"
                                               for k, (bar, r) in sorted(ratios.items())))
            bad = {k: v for k, v in ratios.items() if not v[1] <= 1.0}
            if bad:
                failures.append(f"golden carsus_scale {dtype}: beyond the bar: {bad}")
        launches = path_launches["carsus golden"] = read_counts()
        if launches["line_opacity"] < 1 or launches["formal_solution"] < 1:
            failures.append(f"carsus golden: a kernel was not launched: {launches}")

        def carsus_run():
            out = run_stardis(sim100aa_config(model_path), lam_q, device="cuda",
                              dtype=torch.float32, atom_data=copy.deepcopy(carsus))
            torch.cuda.synchronize()
            return out

        carsus_run()
        reset_counts()
        t0 = time.perf_counter()
        spec = carsus_run().spectrum_nu.value
        wall = time.perf_counter() - t0
        launches = path_launches["carsus Sim100AA"] = read_counts()
        config, cadata, cmodel = parse_config_to_model(sim100aa_config(model_path),
                                                       atom_data=copy.deepcopy(carsus))
        cplan = build_simulation_plan(config, cadata, cmodel, nus)
        _, quants = stage_plasma_and_lines(
            cplan, torch.as_tensor(cplan.temperatures, device=dev).float(),
            torch.as_tensor(cplan.n_elem, device=dev).float(),
            device_constants(cplan, torch.float32, dev))
        alpha, gamma, doppler = quants["atomic"]
        iw = lk.window_half_widths(alpha, gamma, doppler, cplan.d_nu, len(cplan.tracing_nus))
        evals = voigt_evaluations(
            cplan.tracing_nus, cplan.line_data.nu,
            lk.line_center_indices(cplan.tracing_nus, cplan.line_data.nu),
            gamma.double().cpu().numpy(), doppler.double().cpu().numpy(), iw.cpu().numpy())
        k1_ms, k1_by = kernel1_bound(evals, 1, cplan.line_data.n_lines, iw.shape[1],
                                     len(cplan.tracing_nus), 4)
        k1_dev = kernel_device_ms(torch, carsus_run, ("line_opacity_kernel",))
        log(f"phase 17 carsus store on Sim100AA's grid (20 theta, float32): "
            f"{cplan.line_data.n_lines} VALD lines in the window; warm wall {wall:.3f} s; "
            f"launches {launches}; F_nu[surface] min {spec.min():.4e}, max {spec.max():.4e}; "
            f"Kernel 1 in-window evaluations by Voigt region {evals}, kernel1_bound "
            f"{k1_ms:.4f} ms ({k1_by}), its device time in a further run "
            f"{k1_dev['line_opacity_kernel']:.4f} ms (profiler)")
        if not (spec.shape == (len(lams),) and np.isfinite(spec).all() and (spec > 0).all()):
            failures.append("carsus Sim100AA F_nu not finite and positive")
        if launches["line_opacity"] < 1 or launches["formal_solution"] < 1:
            failures.append(f"carsus Sim100AA: a kernel was not launched: {launches}")
        del carsus, frames, cplan, quants, alpha, gamma, doppler, iw

        # (d) the compile cache, in two child processes
        cache_dir = os.path.join(tmp.name, "kernel_cache")
        repo = os.path.dirname(os.path.abspath(__file__))
        build_dir = _cuda.DEFAULT_BUILD_DIR
        before = sorted(os.listdir(build_dir))
        env = dict(os.environ, STARDIS_COMPILE_CACHE=cache_dir, STARDIS_REPO=repo)
        children = []
        for i in range(2):
            npy = os.path.join(tmp.name, f"cache_child{i}.npy")
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-c", CACHE_CHILD, npy], env=env,
                                 capture_output=True, text=True, timeout=900)
            child_s = time.perf_counter() - t0
            if res.returncode != 0:
                raise RuntimeError(f"compile-cache child {i} failed:\n{res.stderr[-2000:]}")
            children.append((json.loads(res.stdout.strip().splitlines()[-1]), np.load(npy),
                             child_s))
        (first, f_first, s_first), (second, f_second, s_second) = children
        in_cache = sorted(p for p in os.listdir(cache_dir) if p.endswith(".so"))
        cached = (first["loaded"].startswith(cache_dir) and second["loaded"] == first["loaded"]
                  and first["nvcc_ran"] == ["formal_solution"] and second["nvcc_ran"] == []
                  and sorted(os.listdir(build_dir)) == before)
        same = bool(np.array_equal(f_first.view(np.uint32), f_second.view(np.uint32)))
        log(f"phase 17 compile cache: {in_cache} under STARDIS_COMPILE_CACHE; first child "
            f"built it in {first['load_s']:.2f} s (nvcc ran for {first['nvcc_ran']}; process "
            f"{s_first:.1f} s), second loaded it in {second['load_s']:.4f} s (nvcc ran for "
            f"{second['nvcc_ran']}; process {s_second:.1f} s); _build/ unchanged "
            f"{sorted(os.listdir(build_dir)) == before}; launches equal bit for bit: {same}")
        if not (cached and same and len(in_cache) == 1):
            failures.append(f"compile cache: cached {cached}, same {same}, files {in_cache}, "
                            f"children {first}, {second}")
    except Exception as exc:  # noqa: BLE001
        failures.append(f"host surface phase: {exc!r}")
    log(f"phase 17 took {time.perf_counter() - t_phase17:.1f} s")

    # --- 18. the rest of the JAX package's public surface -------------------------
    t_phase18 = time.perf_counter()
    import importlib.util
    import weakref

    from stardis_tpu_torch.base import read_stellar_model
    from stardis_tpu_torch.parallel.batch import STAGE1_CACHE_LIMIT, captured_stage1
    from stardis_tpu_torch.plasma import create_stellar_plasma
    from stardis_tpu_torch.serving import SpectralService
    from stardis_tpu_torch.util import memory as mem

    def example(name):
        """examples/torch/<name>.py as a module."""
        spec = importlib.util.spec_from_file_location(
            f"torch_example_{name}", os.path.join(EXAMPLES_DIR, f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    # (a) the eight examples through main() at their script sizes, twice: the
    # second run is the warm one, and the path whose launches are counted
    try:
        modules = {name: example(name) for name in EXAMPLES}
        for name, module in modules.items():
            module.main()
        results, walls = {}, {}
        reset_counts()
        for name, module in modules.items():
            t0 = time.perf_counter()
            results[name] = module.main()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        launches = path_launches["examples"] = read_counts()
        for name in EXAMPLES:
            log(f"phase 18 example {name}: warm wall {walls[name]:.3f} s ({card})")
        log(f"phase 18 examples: launches {launches}")
        for name in ("quickstart", "rotation_broadening"):
            module = modules[name]
            path = os.path.join(tmp.name, f"example_{name}.mod")
            write_marcs_file(path, teff=module.TEFF, logg=module.LOGG)
            step = 0.01 if name == "quickstart" else 0.02
            ref = run_stardis(module.example_config(path),
                              u.Quantity(np.arange(*module.LAMBDA_RANGE, step), u.AA))
            same = bool(np.array_equal(results[name]["spectrum_nu"], ref.spectrum_nu.value))
            log(f"phase 18 example {name}: F_nu equal bit for bit to run_stardis on its "
                f"configuration: {same}")
            if not same:
                failures.append(f"example {name} differs from run_stardis")
        for name in ("fit_stellar_parameters", "fit_with_emulator"):
            losses = results[name]["losses"]
            log(f"phase 18 example {name}: loss {losses[0]:.4e} -> {losses[-1]:.4e} over "
                f"{len(losses)} steps; parameters {results[name]['params']}")
            if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
                failures.append(f"example {name}: the loss did not fall ({losses})")
        diff = results["flexible_plasma"]["korg_diff"]
        log("phase 18 example flexible_plasma against Korg (max |rel diff|, independent / "
            "coupled; logged, not checked): "
            + ", ".join(f"{k} {a:.3g} / {b:.3g}" for k, (a, b) in diff.items()))
        grid = results["teff_grid"]
        if not (grid["mesh_equal"] and np.isfinite(grid["F_nu"]).all()):
            failures.append("example teff_grid: the mesh differs from the batch")
        if not (launches["line_opacity"] > 0 and launches["formal_solution"] > 0
                and launches["line_opacity_grad"] > 0 and launches["formal_solution_grad"] > 0):
            failures.append(f"examples: a kernel of the path was not launched: {launches}")
    except Exception as exc:  # noqa: BLE001
        failures.append(f"examples phase: {exc!r}")

    # (b) create_stellar_plasma on the MARCS sun against the eager stage 1
    try:
        pconfig, padata, pmodel = parse_config_to_model(sim100aa_config(model_path))
        pplan = build_simulation_plan(pconfig, padata, pmodel, nus)
        pconsts = device_constants(pplan, torch.float32, dev)
        eager, _ = stage_plasma_and_lines(
            pplan, torch.as_tensor(pplan.temperatures, device=dev).float(),
            torch.as_tensor(pplan.n_elem, device=dev).float(), pconsts)
        state, ptables = create_stellar_plasma(pmodel, padata)
        same = (np.array_equal(ptables.zs, pplan.tables.zs)
                and all(torch.equal(getattr(state, f), getattr(eager, f))
                        for f in state._fields))
        log(f"phase 18 create_stellar_plasma on the MARCS sun (float32, {state.t.device}): "
            f"{len(state._fields)} PlasmaState fields equal bit for bit to the eager stage 1: "
            f"{same}")
        if not same:
            failures.append("create_stellar_plasma differs from the eager stage 1")
    except Exception as exc:  # noqa: BLE001
        failures.append(f"create_stellar_plasma phase: {exc!r}")

    # (c) n_threads: -2 is refused before any kernel launches
    try:
        bad = sim100aa_config(model_path)
        bad["n_threads"] = -2
        reset_counts()
        try:
            run_stardis(bad, lam_q)
            refused = "no error"
        except ValueError as exc:
            refused = str(exc)
        counts = read_counts()
        log(f"phase 18 run_stardis with n_threads -2: {refused!r}; launches {counts}")
        if "n_threads" not in refused or any(counts.values()):
            failures.append(f"n_threads -2: {refused!r}, launches {counts}")
    except Exception as exc:  # noqa: BLE001
        failures.append(f"n_threads phase: {exc!r}")

    # (d) the memory model with a captured graph resident: a Sim100AA service
    # on phase 9's wide grid, budgeted at MEMORY_BUDGET_SHARE of its
    # unsegmented peak
    try:
        d_adata = synth_linelist(build_builtin_atom_data(30, include_linelists=True),
                                 MEMORY_LINES, *FLAGSHIP_LINE_RANGE)
        d_lam = u.Quantity(np.linspace(*FLAGSHIP_LAMBDA, MEMORY_POINTS[-1]), u.AA)
        d_cfg = sim100aa_config(model_path)

        def unrepaired_limit():
            """device_bytes_limit as it read before the repair: free plus
            reserved minus allocated, a live pool's free blocks included."""
            free, _ = torch.cuda.mem_get_info(dev)
            return free + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)

        def served_peak(nu_segments):
            """(service, F_nu, footprint peak, (device_bytes_limit before and
            after the first request, the unrepaired reading before and
            after it)): the peak allocated over the first request (the
            capture included) and a warm one, plus the pool's free blocks."""
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            limits = [mem.device_bytes_limit(dev), unrepaired_limit()]
            torch.cuda.reset_peak_memory_stats()
            svc = SpectralService(d_cfg, d_lam, atom_data=d_adata, nu_segments=nu_segments)
            model = read_stellar_model(svc.config, svc.atom_data)
            f_first = svc.synthesize(model)["F_nu"]
            torch.cuda.synchronize()
            limits[1:1] = [mem.device_bytes_limit(dev)]
            limits.append(unrepaired_limit())
            peak = torch.cuda.max_memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            f_warm = svc.synthesize(model)["F_nu"]
            torch.cuda.synchronize()
            peak = max(peak, torch.cuda.max_memory_allocated() - base)
            if not np.array_equal(f_first, f_warm):
                failures.append(f"service nu_segments={nu_segments}: two requests differ")
            return svc, f_warm, peak + svc._stage1.pool_free_bytes, limits

        whole, f_whole, peak_whole, _ = served_peak(1)
        del whole
        budget = int(MEMORY_BUDGET_SHARE * peak_whole)
        os.environ["STARDIS_SEGMENT_BUDGET"] = str(budget)
        try:
            svc, f_auto, peak, (limit0, limit1, raw0, raw1) = served_peak("auto")
        finally:
            del os.environ["STARDIS_SEGMENT_BUDGET"]
        k, graph = svc._nu_segments, svc._stage1
        estimate = model_estimate(svc._plan, k) + graph.pool_bytes
        rel = max_rel(f_auto, f_whole)
        log(f"phase 18 memory model: Sim100AA service, {MEMORY_LINES} lines x "
            f"{MEMORY_POINTS[-1]} points: unsegmented peak {peak_whole / 1e9:.4f} GB; budget "
            f"{budget / 1e9:.4f} GB ({MEMORY_BUDGET_SHARE:.0%}); nu_segments='auto' chose K = "
            f"{k}; peak {peak / 1e9:.4f} GB (allocated + the pool's free blocks); the graph's "
            f"pool {graph.pool_bytes / 1e6:.3f} MB, {graph.pool_free_bytes / 1e6:.3f} MB of it "
            f"free; estimate with the pool {estimate / 1e9:.4f} GB, without it "
            f"{(estimate - graph.pool_bytes) / 1e9:.4f} GB; F_nu against the unsegmented "
            f"service max rel err {rel:.3e} (bound 1e-6) ({card})")
        log(f"phase 18 device_bytes_limit before the service's first request "
            f"{limit0 / 1e9:.6f} GB, after it {limit1 / 1e9:.6f} GB (fell by "
            f"{(limit0 - limit1) / 1e6:.3f} MB; the pool's free blocks "
            f"{graph.pool_free_bytes / 1e6:.3f} MB); free + reserved - allocated, the reading "
            f"before the repair: {raw0 / 1e9:.6f} GB, then {raw1 / 1e9:.6f} GB (fell by "
            f"{(raw0 - raw1) / 1e6:.3f} MB)")
        if not (k > 1 and peak < budget and rel <= 1e-6
                and limit0 - limit1 >= graph.pool_free_bytes
                and graph in mem.resident_pools(graph.device)):
            failures.append(f"budgeted service: K {k}, peak {peak}, budget {budget}, rel "
                            f"{rel:.3e}, limit {limit0} -> {limit1}, pool {graph.pool_bytes}")
        check_estimate(f"budgeted service, K = {k}, the graph's pool included", estimate, peak)
        del svc, graph

        # five batch graphs in run_batch's cache of STAGE1_CACHE_LIMIT: the
        # first one captured is evicted and leaves the registry
        graphs = [weakref.ref(captured_stage1(pplan, n, torch.float32, dev))
                  for n in range(1, STAGE1_CACHE_LIMIT + 2)]
        live = [g() for g in graphs]
        resident = mem.resident_pools(torch.device("cuda", torch.cuda.current_device()))
        left = live[0] is None and all(g is not None for g in live[1:])
        registered = left and all(g in resident for g in live[1:])
        log(f"phase 18 batch graphs for 1-{len(graphs)} models: the first evicted "
            f"{live[0] is None}, its pool out of the registry {left}, the other "
            f"{len(graphs) - 1} registered {registered}; pools "
            + ", ".join(f"{g.pool_bytes / 1e6:.3f}" for g in live[1:] if g is not None) + " MB")
        if not (left and registered):
            failures.append("an evicted batch graph stayed in the registry")
        del live, resident
    except Exception as exc:  # noqa: BLE001
        failures.append(f"memory model phase 18: {exc!r}")
    log(f"phase 18 took {time.perf_counter() - t_phase18:.1f} s")

    # --- 19. molecules on the batched, served, scanned and sharded paths -------
    t_phase19 = time.perf_counter()
    try:
        from stardis_tpu_torch.base import read_stellar_model
        from stardis_tpu_torch.grid import load_grid, synthesize_grid
        from stardis_tpu_torch.parallel.batch import captured_stage1, make_batch, run_batch
        from stardis_tpu_torch.parallel.sharding import Mesh, make_batch_nu_mesh
        from stardis_tpu_torch.serving import SpectralService

        def same_bits(label, ours, ref):
            same = (torch.equal(ours, ref) if torch.is_tensor(ours)
                    else bool(np.array_equal(ours, ref)))
            log(f"phase 19 {label}: equal bit for bit: {same}")
            if not same:
                failures.append(f"phase 19 {label}: not equal bit for bit")

        def members_vs_runs(label, f, cfg, m_paths, adata, bound=1e-5):
            worst = 0.0
            for i, path in enumerate(m_paths):
                cfg_i = copy.deepcopy(cfg)
                cfg_i["input_model"]["fname"] = path
                spec = run_stardis(cfg_i, lam_q, device="cuda", dtype=torch.float32,
                                   atom_data=adata).spectrum_nu.value
                member = f[i, -1].double().cpu().numpy() if torch.is_tensor(f) else f[i, -1]
                worst = max(worst, float(np.abs(member / spec - 1.0).max()))
            log(f"phase 19 {label}: members vs run_stardis of each model max rel err "
                f"{worst:.3e} (bound {bound:g})")
            if not worst <= bound:
                failures.append(f"phase 19 {label}: member vs run_stardis rel err {worst:.3e}")

        m_paths = []
        for i, (teff, radius) in enumerate(zip(np.linspace(*MOL_BATCH_TEFF, MOL_BATCH),
                                               np.linspace(*MOL_BATCH_RADIUS, MOL_BATCH))):
            m_paths.append(os.path.join(tmp.name, f"mol_giant{i}.mod"))
            write_marcs_file(m_paths[-1], **{**GIANT, "teff": float(teff),
                                             "radius_cm": float(radius)})
        m_adata = giant_atom_data(N_LINES, GIANT_MOL_LINES)
        m_batches = {}
        for molecules, coupled in ((True, False), (True, True), (False, False)):
            label = ("coupled" if coupled else "pairwise") if molecules else "no molecules"
            m_cfg = giant_config(m_paths[0], tables, coupled=coupled, molecules=molecules)
            config, m_adata, m0 = parse_config_to_model(m_cfg, atom_data=m_adata)
            m_models = [m0] + [read_stellar_model(config, m_adata, p) for p in m_paths[1:]]
            mplan, mbatch = make_batch(config, m_adata, m_models, nus)
            m_batches[label] = (m_cfg, config, m_models, mplan, mbatch)

            def mol_run(**kw):
                f = run_batch(mplan, mbatch, device=dev, dtype=torch.float32, **kw)
                torch.cuda.synchronize()
                return f

            mol_run()  # warm-up: captures the batch's stage-1 graph
            reset_counts()
            f_m = mol_run()
            launches = path_launches[f"molecule batch, {label}"] = read_counts()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                mol_run()
                walls.append(time.perf_counter() - t0)
            timings = {}
            mol_run(timings=timings)
            wall = sorted(walls)[1]
            n_sets = 2 if molecules else 1
            log(f"phase 19 giant batch, {label}: {MOL_BATCH} spherical giants "
                f"(Teff {MOL_BATCH_TEFF[0]:.0f}-{MOL_BATCH_TEFF[1]:.0f} K), "
                f"{mplan.line_data.n_lines} atomic + "
                f"{mplan.molecule_line_data.n_lines if molecules else 0} molecular lines in "
                f"the window, {len(lams)} lambda x {len(mplan.weights)} theta, 3 file tables, "
                f"float32: run_batch walls " + ", ".join(f"{w:.4f}" for w in walls)
                + f" s; {MOL_BATCH / wall:.2f} atmospheres/s (median); launches {launches}; "
                "stages (s, synchronised): "
                + ", ".join(f"{k} {v:.4f}" for k, v in timings.items()) + f" ({card})")
            if not (launches["line_opacity"] == n_sets
                    and launches["formal_solution_inward"] == 1
                    and torch.isfinite(f_m).all() and (f_m[:, -1] > 0).all()):
                failures.append(f"phase 19 giant batch, {label}: launches {launches}")
            p_wall, busy, ops = device_busy(torch, mol_run)
            log(f"phase 19 giant batch, {label}, profiled: wall {p_wall:.4f} s, device busy "
                f"{busy * 1e3:.2f} ms ({busy / p_wall:.1%} of the wall), {ops} device ops")
            if not molecules:
                continue
            mt = mplan.molecule_tables
            rows_walls = []
            for _ in range(7):
                t0 = time.perf_counter()
                mt.rows_at(mbatch.temperatures)
                rows_walls.append(time.perf_counter() - t0)
            rows_ms = sorted(rows_walls)[3] * 1e3
            log(f"phase 19 giant batch, {label}: the members' K(T) and U(T) rows "
                f"({mt.n_molecules} molecules x {MOL_BATCH} x {len(mplan.temperatures)} depths, "
                f"host) {rows_ms:.4f} ms (median of 7)")
            if not np.array_equal(mbatch.molecule_rows.k_density[0], mt.k_density):
                failures.append(f"phase 19 {label}: the template's rows are not its tables")

            # the graph's replay against the eager stage on the same rows
            graph = captured_stage1(mplan, MOL_BATCH, torch.float32, dev)
            consts = graph.consts
            temps = torch.as_tensor(mbatch.temperatures, device=dev).float()
            n_elem = torch.as_tensor(mbatch.n_elem, device=dev).float()
            rows = tuple(torch.as_tensor(x, device=dev).float() for x in mbatch.molecule_rows)
            flat = lambda out: list(out[0]) + [x for t in out[1].values() for x in t]  # noqa: E731
            eager = flat(stage_plasma_and_lines(mplan, temps, n_elem, consts, rows))
            with graph.replay(mbatch.temperatures, mbatch.n_elem,
                              mbatch.molecule_rows) as out:
                same = all(torch.equal(a, b) for a, b in zip(flat(out), eager))
            log(f"phase 19 giant batch, {label}: stage-1 graph replay == eager call bit for "
                f"bit ({len(eager)} tensors): {same}")
            if not same:
                failures.append(f"phase 19 giant batch, {label}: the replay differs")

            def replay_once():
                with graph.replay(mbatch.temperatures, mbatch.n_elem, mbatch.molecule_rows):
                    pass

            replay_ms = sync_ms(torch, replay_once, 5)
            eager_ms = sync_ms(torch, lambda: stage_plasma_and_lines(mplan, temps, n_elem,
                                                                     consts, rows), 5)
            log(f"phase 19 giant batch, {label}: stage 1 replayed {replay_ms:.3f} ms, eager "
                f"{eager_ms:.3f} ms (medians of 5, synchronised, the rows' copies included "
                f"in the replay); graph pool {graph.pool_bytes / 1e6:.3f} MB")
            del eager, out, temps, n_elem, rows, graph, consts
            members_vs_runs(f"giant batch, {label}", f_m, m_cfg, m_paths, m_adata)
            m_batches[label] += (f_m,)

        # a giant service with molecules, serving other temperatures than its plan's
        cfg_p, config_p, models_p, plan_p, batch_p, f_p = m_batches["pairwise"]
        s_paths = []
        for teff in MOL_SERVE_TEFFS:
            s_paths.append(os.path.join(tmp.name, f"mol_serve{int(teff)}.mod"))
            write_marcs_file(s_paths[-1], **{**GIANT, "teff": teff})
        msvc = SpectralService(copy.deepcopy(cfg_p), lam_q, atom_data=m_adata)
        s_models = [read_stellar_model(msvc.config, msvc.atom_data, p) for p in s_paths]
        msvc.synthesize(s_models[0])  # builds the plan at the first request's model
        reset_counts()
        served = [msvc.synthesize(m) for m in s_models]
        launches = path_launches["molecule serving"] = read_counts()
        svc_walls = []
        for m in s_models:
            t0 = time.perf_counter()
            msvc.synthesize(m)
            svc_walls.append(time.perf_counter() - t0)
        members_vs_runs("giant service " + "/".join(f"{t:.0f}" for t in MOL_SERVE_TEFFS)
                        + " K", np.stack([o["F_nu"] for o in served]), cfg_p, s_paths, m_adata)
        log(f"phase 19 giant service with molecules: warm request walls "
            + ", ".join(f"{w:.4f}" for w in svc_walls) + f" s; launches {launches}; "
            f"sigma re-interpolations {msvc.stats.sigma_reinterp_events}; graph pool "
            f"{msvc._stage1.pool_bytes / 1e6:.3f} MB ({card})")
        if not (launches["line_opacity"] == 2 * len(s_models)
                and launches["formal_solution_inward"] == len(s_models)):
            failures.append(f"phase 19 giant service: launches {launches}")
        fb = msvc.synthesize_batch(models_p)
        rel_b, _ = rel_err(torch.as_tensor(fb), f_p.cpu())
        log(f"phase 19 giant service synthesize_batch of {MOL_BATCH} against run_batch: F_nu "
            f"max rel err {rel_b:.3e} (bound 1e-6)")
        if not rel_b <= 1e-6:
            failures.append(f"phase 19 synthesize_batch rel err {rel_b:.3e}")
        del msvc, served, fb

        # a two-chunk molecule scan, stopped and resumed, against a fresh one
        scan = os.path.join(tmp.name, "mol_scan")
        fresh = os.path.join(tmp.name, "mol_scan_fresh")
        kw = {"batch_size": MOL_BATCH // 2,
              "labels": [{"teff": float(t)} for t in np.linspace(*MOL_BATCH_TEFF, MOL_BATCH)]}
        r1 = synthesize_grid(config_p, m_adata, models_p, nus, scan, max_chunks=1, **kw)
        r2 = synthesize_grid(config_p, m_adata, models_p, nus, scan, **kw)
        reset_counts()
        r3 = synthesize_grid(config_p, m_adata, models_p, nus, fresh, **kw)
        launches = path_launches["molecule grid scan"] = read_counts()
        resumed = load_grid(scan)[0]
        same_bits(f"molecule grid scan stopped {r1['computed']}, resumed {r2['computed']} "
                  "vs fresh", resumed, load_grid(fresh)[0])
        rel_s, _ = rel_err(torch.as_tensor(resumed), f_p[:, -1].cpu())
        log(f"phase 19 molecule grid scan against run_batch of all {MOL_BATCH}: max rel err "
            f"{rel_s:.3e}; launches {launches}")
        if not (r1["computed"] == 1 and r2["skipped"] == 1 and r2["done"]
                and r3["computed"] == 2 and launches["line_opacity"] == 4):
            failures.append(f"phase 19 molecule grid scan: {r1} {r2} {r3} {launches}")

        # the batch on meshes of the card repeated four times
        card0 = torch.device("cuda", 0)
        for label, bmesh in (("'batch' mesh of 4", Mesh([card0] * 4, ("batch",))),
                             ("2 x 2 mesh", make_batch_nu_mesh(2, 2, [card0] * 4))):
            reset_counts()
            f_mesh = run_batch(plan_p, batch_p, mesh=bmesh, dtype=torch.float32)
            torch.cuda.synchronize()
            launches = path_launches[f"molecule batch, {label}"] = read_counts()
            log(f"phase 19 molecule batch on the {label}: launches {launches}")
            same_bits(f"molecule batch on the {label} vs unsharded", f_mesh, f_p)
        del f_mesh

        # a differentiated 4-giant molecule batch, each member's gradient row
        # against the all-plain path
        for coupled in (False, True):
            label = "coupled" if coupled else "pairwise"
            g_cfg = giant_config(m_paths[0], tables, coupled=coupled)
            g_adata = giant_atom_data(N_LINES_PLAIN_CHECK, GIANT_MOL_LINES_PLAIN_CHECK)
            config, g_adata, g0 = parse_config_to_model(g_cfg, atom_data=g_adata)
            g_models = [g0] + [read_stellar_model(config, g_adata, p)
                               for p in m_paths[2::2][:MOL_GRAD_MODELS - 1]]
            gplan, gbatch = make_batch(config, g_adata, g_models, nus)

            def mol_grad(dtype, plain):
                t = torch.as_tensor(gbatch.temperatures, device=dev).to(dtype)
                t.requires_grad_()
                f = run_batch(gplan, dataclasses.replace(gbatch, temperatures=t), device=dev,
                              dtype=dtype, plain=plain)
                return torch.autograd.grad(f[:, -1].sum(), t)[0]

            reset_counts()
            g32 = mol_grad(torch.float32, plain=False)
            torch.cuda.synchronize()
            launches = path_launches[f"molecule batch gradient, {label}"] = read_counts()
            g_plain = mol_grad(torch.float64, plain=True)
            scale = g_plain.abs().amax(dim=1)
            err64 = (mol_grad(torch.float64, plain=False) - g_plain).abs().amax(dim=1) / scale
            err32 = (g32.double() - g_plain).abs().amax(dim=1) / scale
            log(f"phase 19 {MOL_GRAD_MODELS}-giant molecule batch gradient, {label} "
                f"({gplan.line_data.n_lines} + {gplan.molecule_line_data.n_lines} lines): per "
                "member against the all-plain path (float64), max |diff| / member max: float64 "
                "kernel path " + ", ".join(f"{x:.3e}" for x in err64.tolist())
                + " (bound 1e-9); float32 main path "
                + ", ".join(f"{x:.3e}" for x in err32.tolist()) + f"; launches {launches}")
            if not ((err64 <= 1e-9).all() and torch.isfinite(g32).all()
                    and launches["line_opacity_grad"] == 2
                    and launches["formal_solution_grad_inward"] == 1):
                failures.append(f"phase 19 molecule batch gradient, {label}: float64 "
                                f"{err64.tolist()}, launches {launches}")
        del m_batches, f_p
    except Exception as exc:  # noqa: BLE001
        failures.append(f"molecule batch phase 19: {exc!r}")
    log(f"phase 19 took {time.perf_counter() - t_phase19:.1f} s")
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
