"""One run of one cell: set-up, a closed-loop window, the check against the
reference, and the result line's numbers.

Everything particular to a cell is data or a file of its own, found by
name: ``BENCHMARK.json`` names the cell's configuration and traffic mix
and the metrics it reports; ``configs/<config>.json`` holds the sizes;
``traffic/<traffic>.json`` the mix, whose ``kind`` names the driver in
``drivers/<kind>.py``; ``end_to_end/<metric>.py`` and
``metrics/<metric>.py`` each read one metric; ``limits/<cell>.json`` holds
the limit of each number the check compares.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from . import inputs, kernel1_tap, yardstick
from .reference.spectrum import Reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: length of a traced run's profiled window, at most --seconds
TRACE_SECONDS = 4.0
#: models the reference takes at once
REFERENCE_CHUNK = 8
#: characters of a device operation's name kept in the breakdown
OP_NAME_CHARS = 96


def load_spec():
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_json(folder, name):
    with open(HERE / folder / f"{name}.json") as fh:
        return json.load(fh)


def load_module(folder, name):
    """The module ``<folder>/<name>.py`` (names may hold dots).  A metric
    split by a suffix (``device_idle_pct.fit``: the same quantity, moving
    another cell's end-to-end metric) falls back to the reader of its
    stem, ``<folder>/device_idle_pct.py``."""
    path = HERE / folder / f"{name}.py"
    if not path.exists() and "." in name:
        path = HERE / folder / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(spec, cell_name, section):
    """The metrics of ``section`` ("end_to_end" or "per_layer") the cell
    reports: those listing it, and those listing no cells."""
    return [m for m in spec[section] if cell_name in m.get("workloads", [cell_name])]


class Context:
    """What a driver gets: the configuration and the mix, the seed's
    generator, the device and dtype, a scratch directory under TMPDIR, and
    the atomic data for the program (``adata``)."""

    def __init__(self, config, mix, seed, device, dtype, tmp):
        self.config, self.mix, self.seed = config, mix, seed
        self.rng = np.random.default_rng(seed_words(seed, 0))
        self.device, self.dtype, self.tmp = torch.device(device), dtype, Path(tmp)
        self.adata = inputs.port_atom_data(inputs.atom_data(config))
        self.lambdas = inputs.lambdas_aa(config)
        self.tables = inputs.write_tables(config, self.tmp)


def seed_words(seed, stream):
    """A generator seed for ``stream`` of a run: any whole number, however
    large or negative, maps to one."""
    seed = int(seed)
    return [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, int(seed < 0), stream]


def stratified(rng, n, lo, hi):
    """n draws uniform in [lo, hi), one in each of n equal strata, in a
    random order: every seed gets the same spread of sizes."""
    u = (rng.permutation(n) + rng.random(n)) / n
    return lo + (hi - lo) * u


def closed_loop(driver, seconds, timings=None):
    """Calls one after another until ``seconds`` have passed; the window
    ends when the last call returns.  Returns (window s, latencies s,
    answers per call, failed calls)."""
    latencies, answers, failed = [], [], 0
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        tc = time.perf_counter()
        try:
            out = driver.call(i, None if timings is None else timings.setdefault(i, {}))
        except Exception:  # a failed call counts; the loop goes on
            traceback.print_exc()
            failed += 1
            out = None
        latencies.append(time.perf_counter() - tc)
        answers.append(out)
        i += 1
    return time.perf_counter() - t0, latencies, answers, failed


def profiled_loop(driver, seconds, cuda):
    """``closed_loop`` under torch.profiler, with stage timings where the
    driver takes them: (window, latencies, answers, failed, profile,
    timings)."""
    from torch.profiler import ProfilerActivity, profile

    timings = {}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        window, latencies, answers, failed = closed_loop(driver, seconds, timings)
        if cuda:
            torch.cuda.synchronize()
    return window, latencies, answers, failed, prof, [timings[i] for i in sorted(timings)]


def trace_events(prof):
    """(device events [(name, start_us, end_us)], harness spans [(name,
    start_us, end_us)]) of a profile."""
    device, spans = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) or e.name.startswith("portbench."):
            if e.device_type == torch.autograd.DeviceType.CPU:
                spans.append((e.name.removeprefix("portbench."), e.time_range.start,
                              e.time_range.end))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((e.name, e.time_range.start, e.time_range.end))
    return device, spans


def breakdown(device_events, spans):
    """The ten device operations that took most time, and the ten longest
    idle gaps of the card summed by the harness span the host was in."""
    by_op = {}
    for name, start, end in device_events:
        name = name[:OP_NAME_CHARS]
        by_op[name] = by_op.get(name, 0.0) + (end - start) * 1e-6
    busy = yardstick.busy_intervals([(s, e) for _n, s, e in device_events])
    gaps = {}
    for (_s0, e0), (s1, _e1) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        inside = [(e - s, n) for n, s, e in spans if s <= mid <= e]
        name = min(inside)[1] if inside else "between calls"
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


def kernel_launches(ref, calls, itemsize, model_of=None):
    """Kernel 1's and Kernel 2's launches of ``calls`` (lists of the
    models' reference keys, one list per call), the work of each counted
    from the reference's own line quantities and windows: one Kernel 1
    launch per line set and call, one Kernel 2 launch per call.  A key's
    model is ``ref.model(*key)``, or ``model_of(ref, key)`` where the
    driver module defines that as ``reference_model`` (a fit scales the
    densities too)."""
    model_of = model_of or (lambda ref, key: ref.model(*key))
    plan, consts = ref.plan, ref.consts
    n_nu, n_depth = consts.grid.shape[0], len(plan.temperatures)
    k1, k2 = [], []
    for keys in calls:
        per_set = {}
        for c0 in range(0, len(keys), REFERENCE_CHUNK):
            chunk = [model_of(ref, key) for key in keys[c0:c0 + REFERENCE_CHUNK]]
            _state, quants = ref.stage1(chunk)
            for key, (_alpha, gamma, doppler, iw) in ref.windows(quants).items():
                line_nu, centers = consts.lines[key]
                counts = yardstick.voigt_evaluations_torch(consts.grid, line_nu, centers,
                                                           gamma, doppler, iw)
                total = per_set.setdefault(key, dict.fromkeys(yardstick.REGIONS, 0))
                for region, v in counts.items():
                    total[region] += v
        for key, counts in per_set.items():
            k1.append({"evaluations": counts, "n_models": len(keys),
                       "n_lines": int(consts.lines[key][0].shape[0]), "n_depth": n_depth,
                       "n_out": n_nu, "itemsize": itemsize})
        k2.append({"n_models": len(keys), "n_depth": n_depth, "n_nu": n_nu,
                   "n_theta": len(plan.weights), "inward": bool(plan.inward_rays)})
    return k1, k2


def draw_pixels(rng, n_pix, n_nu):
    """``n_pix`` pixels of an ``n_nu``-pixel grid drawn with ``rng``, both
    ends of the grid among them, ascending (all of them on a smaller grid)."""
    n_pix = min(n_pix, n_nu)
    return np.unique(np.concatenate([[0, n_nu - 1],
                                     rng.choice(np.arange(1, n_nu - 1), n_pix - 2,
                                                replace=False)]))


def line_opacity_err(ours, want):
    """The largest, over line sets and over (model, depth) rows, of the
    largest |kappa - kappa_ref| in the row over the largest kappa_ref in it:
    ``ours`` and ``want`` map each line set to [..., P] arrays.  A row the
    reference holds no line in reads 0 if ours holds none either; a line set
    on one side only, or a value that is not finite, reads inf."""
    if set(ours) != set(want):
        return float("inf")
    worst = 0.0
    for key, k_ref in want.items():
        off = np.max(np.abs(np.asarray(ours[key], np.float64) - k_ref), axis=-1)
        scale = np.max(np.abs(k_ref), axis=-1)
        err = np.where(scale > 0, off / np.where(scale > 0, scale, 1.0),
                       np.where(off == 0, 0.0, np.inf))
        if not np.all(np.isfinite(err)):
            return float("inf")
        worst = max(worst, float(np.max(err, initial=0.0)))
    return worst


def line_opacity_pixel_err(ours, want):
    """The largest, over line sets and over every (model, depth, pixel) at
    which the reference's line sum is above 0, of |kappa - kappa_ref| over
    kappa_ref: the error at the weakest pixel counts as much as at a line's
    core, so lost wings show (where kappa_ref is 0, ``line_opacity_err``
    judges).  A line set on one side only, or a value that is not finite,
    reads inf."""
    if set(ours) != set(want):
        return float("inf")
    worst = 0.0
    for key, k_ref in want.items():
        kappa = np.asarray(ours[key], np.float64)
        if not np.all(np.isfinite(kappa)):
            return float("inf")
        held = k_ref > 0
        worst = max(worst, float(np.max(np.abs(kappa[held] - k_ref[held]) / k_ref[held],
                                        initial=0.0)))
    return worst


def check(ref, answers, mix, seed, n_nu, kept=None, control=None):
    """The check of ``correct``: the calls the run's ``kernel1_tap`` kept
    (``kept``: a sample of ``check_calls`` of the window's calls, drawn from
    the seed, with Kernel 1's output at pixels drawn from the seed, both
    ends of the grid among them), those that returned, against the
    reference at those pixels.  Returns {number: value}:

    * ``spectrum_rel_err``: the largest |F / F_ref - 1| of each answer's
      surface F_nu;
    * ``line_opacity_err``: Kernel 1's output as the call produced it, each
      line set's opacity at every depth, against the reference's line sum
      (``line_opacity_err``: on the scale of each row's largest);
      a call whose launches the tap did not see whole
      (``kernel1_tap.assemble``) reads inf;
    * ``line_opacity_pixel_err``: the same, pixel by pixel on the scale of
      the reference's own value there (``line_opacity_pixel_err``).

    Each line set's spread, a row's largest kappa_ref over its median, goes
    to standard error: the factor by which ``line_opacity_err`` scales an
    error at a row's typical pixel down.

    With a ``control`` reference (``control.py``), its spectra and line
    sums at the same inputs take the program's place: the control's
    readings, returned instead.

    A traffic kind whose answers are not spectra (a fit's model spectra
    and gradients) brings its own ``check`` with this signature in its driver
    module, which ``run`` and ``control_readings`` both call in place of
    this one; ``kept`` is then what its ``Driver.close()`` returned."""
    failed = dict.fromkeys(("spectrum_rel_err", "line_opacity_err", "line_opacity_pixel_err"),
                           float("inf"))
    if not kept:
        return failed
    pixels = kept["pixels"]
    calls = sorted(i for i in kept["calls"] if answers[i] is not None)
    pairs = [(i, b, key, f) for i in calls for b, (key, f) in enumerate(answers[i])]
    if not pairs:
        return failed
    sets = {key: int(line_nu.shape[0]) for key, (line_nu, _c) in ref.consts.lines.items()}
    flux_err = kappa_err = pixel_err = 0.0
    spread = {}
    for c0 in range(0, len(pairs), REFERENCE_CHUNK):
        chunk = pairs[c0:c0 + REFERENCE_CHUNK]
        models = [ref.model(*key) for _call, _b, key, _f in chunk]
        want = {}
        f_ref = ref.surface_flux(models, pixels, want)
        for key, k_ref in want.items():
            row_max, row_median = np.max(k_ref, axis=-1), np.median(k_ref, axis=-1)
            ratio = row_max[row_median > 0] / row_median[row_median > 0]
            lo, hi = spread.get(key, (np.inf, 0.0))
            spread[key] = (min(lo, np.min(ratio, initial=np.inf)),
                           max(hi, np.max(ratio, initial=0.0)))
        if control is None:
            f_ours = np.stack([np.asarray(f, dtype=np.float64)[pixels]
                               for _call, _b, _key, f in chunk])
            per_call = {i: kernel1_tap.assemble(kept["calls"][i], pixels,
                                                {key: sets[key] for key in want})
                        for i in {call for call, _b, _key, _f in chunk}}
            ours = (None if any(v is None for v in per_call.values()) else
                    {key: np.stack([per_call[i][key][b] for i, b, _key, _f in chunk])
                     for key in want})
        else:
            ours = {}
            f_ours = control.surface_flux(models, pixels, ours)
        err = np.abs(f_ours / f_ref - 1.0)
        flux_err = max(flux_err, float(np.max(err)) if np.all(np.isfinite(err))
                       else float("inf"))
        kappa_err = max(kappa_err, float("inf") if ours is None
                        else line_opacity_err(ours, want))
        pixel_err = max(pixel_err, float("inf") if ours is None
                        else line_opacity_pixel_err(ours, want))
    for key, (lo, hi) in spread.items():
        print(f"check: {key} lines: a row's largest kappa_ref over its median "
              f"{lo:.4g} .. {hi:.4g}", file=sys.stderr)
    return {"spectrum_rel_err": flux_err, "line_opacity_err": kappa_err,
            "line_opacity_pixel_err": pixel_err}


def test_sizes(workload):
    """``run``'s overrides for the CPU tests: the ``test_sizes`` of the
    cell's configuration and mix files."""
    cell = next(w for w in load_spec()["workloads"] if w["name"] == workload)
    return {"config": load_json("configs", cell["config"]).get("test_sizes", {}),
            "traffic": load_json("traffic", cell["traffic"]).get("test_sizes", {})}


def run(workload, seed, seconds, trace, device="cuda", dtype=torch.float32,
        t_start=None, overrides=None, log=None, control=False):
    """One run of the cell ``workload``; returns the result line's dict.
    ``overrides`` ({"config": {...}, "traffic": {...}}) replaces top-level
    keys of the configuration and the mix: the CPU tests' small sizes.
    ``control`` (``control.py`` only) adds the control's readings."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec = load_spec()
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    overrides = overrides or {}
    config = {**load_json("configs", cell["config"]), **overrides.get("config", {})}
    mix = {**load_json("traffic", cell["traffic"]), **overrides.get("traffic", {})}
    limits = load_json("limits", workload)
    driver_mod = load_module("drivers", mix["kind"])
    cuda = torch.device(device).type == "cuda"

    cell_check = getattr(driver_mod, "check", check)

    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx = Context(config, mix, seed, device, dtype, tmp)
        log(f"{workload}: inputs at {time.perf_counter() - t_start:.3f} s")
        driver = driver_mod.Driver(ctx)
        # the spectrum check reads Kernel 1's output from the window's calls
        tap = None if cell_check is not check else kernel1_tap.Kernel1Tap(
            draw_pixels(np.random.default_rng(seed_words(seed, 1)), mix["check_pixels"],
                        len(ctx.lambdas)),
            mix["check_calls"], np.random.default_rng(seed_words(seed, 5)),
            len(ctx.lambdas), device, dtype)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        log(f"{workload}: set-up {setup_s:.3f} s")

        timed = driver if tap is None else tap.around(driver)
        if tap is not None:
            tap.install()
        try:
            if trace:
                window, latencies, answers, failed, prof, timings = profiled_loop(
                    timed, min(seconds, TRACE_SECONDS), cuda)
            else:
                window, latencies, answers, failed = closed_loop(timed, seconds)
        finally:
            if tap is not None:
                tap.remove()
        if cuda:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        spectra = sum(len(out) for out in answers if out is not None)
        log(f"{workload}: {len(answers)} calls, {spectra} spectra, {failed} failed in "
            f"{window:.4f} s; call wall median {statistics.median(latencies) * 1e3:.3f} ms "
            f"over {len(latencies)} calls")
        template, keys = driver.template_path, [
            [key for key, _f in out] if out is not None else [] for out in answers]
        kept = driver.close()
        if tap is not None:
            kept = tap.close()
        del driver, tap
        if cuda:
            torch.cuda.empty_cache()

        ref = Reference(inputs.stardis_config(config, template, ctx.tables),
                        inputs.atom_data(config), ctx.lambdas, template, device, torch.float64)
        record = {"window_s": window, "latencies_s": latencies, "spectra": spectra,
                  "calls": len(answers), "setup_s": setup_s}
        metrics, device_info, extra = {}, device_record(cuda, peak, cell["chips"]), {}
        if trace:
            device_events, spans = trace_events(prof)
            del prof
            busy = yardstick.busy_seconds([(s, e) for _n, s, e in device_events])
            k1, k2 = kernel_launches(ref, [k for k in keys if k],
                                     torch.empty((), dtype=dtype).element_size(),
                                     getattr(driver_mod, "reference_model", None))
            record.update(busy_s=busy, device_events=device_events, timings=timings,
                          kernel1=k1, kernel2=k2)
            device_info.update(busy_s=busy, window_s=window)
            extra["breakdown"] = breakdown(device_events, spans)
            section, folder = "per_layer", "metrics"
        else:
            section, folder = "end_to_end", "end_to_end"
        for m in cell_metrics(spec, workload, section):
            value = load_module(folder, m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        t_check = time.perf_counter()
        compared = cell_check(ref, answers, mix, seed, len(ctx.lambdas), kept)
        log(f"{workload}: check {time.perf_counter() - t_check:.3f} s")
        if control:
            extra["control"] = control_readings(cell_check, config, ctx, template, ref,
                                                answers, mix, seed, kept)
    correct = failed == 0 and all(value <= limits[name]["limit"]
                                  for name, value in compared.items())
    for name, value in compared.items():
        log(f"{name} {value!r} limit {limits[name]['limit']!r}")
    return {"correct": bool(correct), "attempted": len(answers), "failed": failed,
            "metrics": metrics, "device": device_info, **extra,
            "compared": {name: {"value": value, "limit": limits[name]["limit"]}
                         for name, value in compared.items()}}


def control_readings(cell_check, config, ctx, template, ref, answers, mix, seed, kept):
    """The control: the reference computed in bfloat16, the precision below
    the configuration's float32, in the program's place on the same sampled
    inputs and pixels, read by the cell's own ``cell_check`` (the driver
    module's, or ``check``): {number: value}.  (TF32, the step below
    float32 for a matrix product, touches only the bound-free product here
    and moves the surface flux less than float32 rounding does: PERF.md.)"""
    low = Reference(inputs.stardis_config(config, template, ctx.tables),
                    inputs.atom_data(config), ctx.lambdas, template, ref.device, torch.bfloat16)
    return cell_check(ref, answers, mix, seed, len(ctx.lambdas), kept, control=low)


def device_record(cuda, peak, chips):
    """The result line's ``device``: the card's name, the cards the cell
    uses, the peak bytes allocated on the card, its power limit."""
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak), "power_limit_w": power_limit()}


def power_limit():
    """The card's power limit [W] as nvidia-smi reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
