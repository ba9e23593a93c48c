#!/usr/bin/env python3
"""Smoke test of stardis_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build both hand-written kernels from stardis_tpu_torch/csrc with nvcc;
  3. Kernel 1 (line opacity) against its plain torch version on the card,
     5k lines x 56 depths x 10k lambda: float64 at rtol 1e-12, float32 at
     max|diff| <= 1e-5 max|plain| per depth row; then both timed at the
     slice's shape (all 47,807 in-window lines, float32; bound 1e-4 per
     row for the two summation orders of that many float32 terms);
  4. Kernel 2 (formal solution) against its plain version at the full
     Sim100AA shape (56 depths x 10k lambda x 20 theta), float32 and float64;
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
     1e-5; both timed on the giant's own;
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
     runs (per-model corrections and cross-sections).

The kernels build in parallel (one nvcc per source).  The last line of
standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is the card's name and power limit, and the line
before that holds each kernel's launches (summed over the main paths of
phases 5, 7 and 8), error and times.
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
KERNELS = ("line_opacity", "formal_solution", "formal_solution_inward")


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


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` warm calls (CUDA events)."""
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
        run_simulation,
        spectrum_batch,
        stage_plasma_and_lines,
    )
    from stardis_tpu_torch.radiation_field import solver
    from stardis_tpu_torch.radiation_field.blackbody import blackbody_flux_at_nu

    dev = torch.device("cuda")
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
    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = {name: pool.submit(_cuda.load, name)
                  for name in ("line_opacity", "formal_solution")}
        for name, fut in builds.items():
            fut.result()
    log(f"built both kernels in {time.perf_counter() - t0:.1f} s")
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
        _, quants = stage_plasma_and_lines(plan, temps, n_elem)
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

    report = {}

    # --- 3. Kernel 1 against its plain version -----------------------------
    try:
        n_all = plan.line_data.n_lines
        subset = torch.linspace(0, n_all - 1, N_LINES_KERNEL_CHECK).round().long().unique()
        for dtype in (torch.float64, torch.float32):
            args, iw = line_inputs(dtype, subset.numpy())
            kern = lk.accumulate_line_windows(*args, iw)
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
        kern = lk.accumulate_line_windows(*args, iw)
        t_plain0 = time.perf_counter()
        plain = lk.accumulate_line_opacity_plain(*args, iw)
        torch.cuda.synchronize()
        plain_first_s = time.perf_counter() - t_plain0
        err = (kern - plain).abs().max().item()
        row, rows_ok = row_err(kern, plain)
        ms = cuda_ms(torch, lambda: lk.accumulate_line_windows(*args, iw), 5)
        plain_ms = cuda_ms(torch, lambda: lk.accumulate_line_opacity_plain(*args, iw), 1)
        # float32 sums of ~48k lines in two orders (the kernel serially per
        # pixel, the plain version chunk by chunk) differ by ~sqrt(L) ulp of
        # the row maximum; the bound allows 1e-4 of it
        log(f"kernel 1 f32 full slice ({n_all} lines x 56 x 10k): kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms (first plain call {plain_first_s:.2f} s), "
            f"max abs err {err:.3e}, max row err / row max {row:.3e} (bound 1e-4)")
        if not (row <= 1e-4 and rows_ok):
            failures.append(f"kernel 1 f32 full-slice row err {row:.3e}")
        report["line_opacity"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del args, iw, kern, plain
    except Exception as exc:  # noqa: BLE001 - report every phase
        failures.append(f"kernel 1 phase: {exc!r}")

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
                log(f"kernel 2 f32 full slice: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                    f"max abs err {err:.3e}")
                report["formal_solution"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    except Exception as exc:  # noqa: BLE001
        failures.append(f"kernel 2 phase: {exc!r}")

    # launch counts of each main path: set to 0 just before it, read just after
    counters = {
        "line_opacity": (lk.accumulate_line_opacity_cuda, "launches"),
        "formal_solution": (solver.raytrace_cuda, "launches"),
        "formal_solution_inward": (solver.raytrace_cuda, "inward_launches"),
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
                    log(f"kernel 2 inward f32 giant: kernel {ms:.3f} ms, "
                        f"plain {plain_ms:.3f} ms")
                del fk, ik, fp, ip
        del inputs, total, source
        report["formal_solution_inward"] = {
            "max_abs_err": max(f32_errs), "ms": ms, "plain_ms": plain_ms,
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
        fk = batch_run()
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
        rel, zeros_ok = rel_err(fk, fp)
        log(f"batch kernels vs plain versions: F_nu max rel err {rel:.3e} (bound 1e-4)")
        if not (rel <= 1e-4 and zeros_ok and torch.isfinite(fk).all()):
            failures.append(f"batch kernel vs plain rel err {rel:.3e}")
        # Kernel 1's own [16, D, N] output on the model axis, in both
        # window modes, against its plain version (phase 3's bound)
        temps = torch.as_tensor(batch.temperatures, device=dev).to(torch.float32)
        n_elem = torch.as_tensor(batch.n_elem, device=dev).to(torch.float32)
        states, quants = zip(*(stage_plasma_and_lines(bplan, temps[b], n_elem[b])
                               for b in range(BATCH_MODELS)))
        for mode in ("reference", "accuracy"):
            mplan = dataclasses.replace(bplan, window_mode=mode)
            ok, op = (spectrum_batch(mplan, states, quants, batch.ray_distances,
                                     plain=plain)[2]["alpha_line_at_nu"]
                      for plain in (False, True))
            row, rows_ok = row_err(ok, op)
            log(f"batch {mode} windows: Kernel 1 alpha_line_at_nu vs plain "
                f"{list(ok.shape)}, max row err / row max {row:.3e} (bound 1e-4)")
            if not (ok.shape[0] == BATCH_MODELS and row <= 1e-4 and rows_ok):
                failures.append(f"batch {mode} alpha_line_at_nu row err {row:.3e}")
        del states, quants, ok, op
        worst = 0.0
        for i, path in enumerate(paths):
            cfg_i = copy.deepcopy(b_cfg)
            cfg_i["input_model"]["fname"] = path
            spec = run_stardis(cfg_i, u.Quantity(b_lams, u.AA), device="cuda",
                               dtype=torch.float32, atom_data=b_adata).spectrum_nu.value
            member = fk[i, -1].double().cpu().numpy()
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
        "formal_solution": ("stardis_tpu_torch/csrc/formal_solution.cu",
                            "stardis_tpu/radiation_field/solver.py:186"),
        "formal_solution_inward": ("stardis_tpu_torch/csrc/formal_solution.cu",
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
