"""Each traffic kind, driven whole on the CPU at small sizes in float64,
agrees with the reference; with its timed path broken underneath, the same
run reads ``correct`` false.  The look for a card is ``run.py``'s, which
these tests skip: they call ``bench.run`` on the CPU."""

import numpy as np
import pytest
import torch

from portbench import bench, faults, kernel1_tap

CELLS = [w["name"] for w in bench.load_spec()["workloads"]]
SEED = 2**31 + 77
#: the most a sound float64 run on the CPU reads, by number compared: the
#: spectra, the fit's model spectra, Kernel 1's and Kernel 1b's outputs
#: agree to rounding; the fit's gradient is held to the reference's central
#: difference in the T scale (its truncation reads up to 1.5e-8 of that
#: component at these sizes)
SOUND = {"spectrum_rel_err": 1e-9, "fit_model_err": 1e-9, "fit_grad_rel_err": 1e-7,
         "kernel1b_grad_err": 1e-9, "line_opacity_err": 1e-9, "line_opacity_pixel_err": 1e-9}


def small_run(workload, seconds=0.5, trace=0):
    torch.set_num_threads(2)
    return bench.run(workload, SEED, seconds, trace, "cpu", torch.float64,
                     overrides=bench.test_sizes(workload), log=lambda msg: None)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = small_run(workload)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert all(entry["value"] < SOUND[name] for name, entry in result["compared"].items())
    # every number the limits file holds is compared, Kernel 1's output among them
    assert set(result["compared"]) == set(bench.load_json("limits", workload))
    assert "line_opacity_err" in result["compared"]
    assert list(result)[-1] == "compared"
    names = {m["name"] for m in bench.cell_metrics(bench.load_spec(), workload, "end_to_end")}
    assert set(result["metrics"]) == names


def test_traced_run_reports_per_layer_metrics():
    result = small_run("giant_mol.batch8", trace=1)
    assert result["correct"]
    assert {"continuum_ms", "stage1_ms", "spectrum_mfu"} <= set(result["metrics"])
    assert result["device"]["window_s"] > 0


def altered_answer(monkeypatch):
    """A fault where an answer is produced: the formal solution's F_nu 1 %
    too high at every other pixel."""
    from stardis_tpu_torch import pipeline

    real = pipeline.raytrace

    def fake(*args, **kw):
        f_nu, i_nus = real(*args, **kw)
        f_nu = f_nu.clone()
        f_nu[..., ::2] *= 1.01
        return f_nu, i_nus

    monkeypatch.setattr(pipeline, "raytrace", fake)


def half_batch_left_out(monkeypatch):
    """A fault of a batch: the second half of the members is not computed,
    each replaced by the mean of the first half's."""
    from stardis_tpu_torch.parallel import batch as batch_mod

    real = batch_mod.run_batch

    def fake(plan, batch, **kw):
        f_nu = real(plan, batch, **kw)
        half = f_nu.shape[0] // 2
        f_nu[half:] = f_nu[:half].mean(dim=0)
        return f_nu

    monkeypatch.setattr(batch_mod, "run_batch", fake)


def kernel1b_off(monkeypatch):
    """A fault of a fit's backward: Kernel 1b's plain version returns its
    gradients of alpha, gamma and doppler 1 % too large."""
    from stardis_tpu_torch.opacities import line_kernel

    real = line_kernel.accumulate_line_opacity_plain_backward

    def fake(*args, **kw):
        return tuple(None if g is None else g * 1.01 for g in real(*args, **kw))

    monkeypatch.setattr(line_kernel, "accumulate_line_opacity_plain_backward", fake)


def sigma_gradient_dropped(monkeypatch):
    """A fault of a fit's backward: the instrumental kernel takes sigma
    detached, so the step's gradient in sigma is 0."""
    from stardis_tpu_torch import postprocessing

    real = postprocessing.gaussian_kernel_torch

    def fake(sigma, *args, **kw):
        return real(sigma.detach() if torch.is_tensor(sigma) else sigma, *args, **kw)

    monkeypatch.setattr(postprocessing, "gaussian_kernel_torch", fake)


def kernel1_off(monkeypatch):
    """A fault of Kernel 1 in the measured window alone: its plain version
    returns each model's line opacity 1 % too large there (the saturated
    spectra hardly move), and right in set-up and in the check."""
    faults.scale_kernel1(monkeypatch.setattr, 1.01, plain=True,
                         when=faults.in_window(monkeypatch.setattr))


def kernel1_wings_cut(monkeypatch):
    """A fault of Kernel 1 in the measured window alone: its plain version
    leaves out every term under 1e-3 of its line's peak, as windows cut
    there would."""
    faults.cut_kernel1_wings(monkeypatch.setattr, 1e-3,
                             when=faults.in_window(monkeypatch.setattr))


FAULTS = [(cell, fault) for cell in CELLS
          for fault in (altered_answer, kernel1_off, kernel1_wings_cut)] + [
    ("giant_mol.batch8", half_batch_left_out), ("sim100aa_sun.fit", kernel1b_off),
    ("sim100aa_sun.fit", sigma_gradient_dropped)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_broken_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = small_run(workload)
    assert not result["correct"]
    assert any(v["value"] > v["limit"] and np.isfinite(v["value"])
               for v in result["compared"].values())


def kind(workload):
    cell = next(w for w in bench.load_spec()["workloads"] if w["name"] == workload)
    return bench.load_json("traffic", cell["traffic"])["kind"]


SPECTRUM_CELLS = [c for c in CELLS if kind(c) in ("batch", "serve")]


@pytest.mark.parametrize("workload", SPECTRUM_CELLS)
def test_call_the_tap_did_not_see_whole_reads_inf(workload, monkeypatch):
    """Kernel 1's output counts only as the window's call produced it, every
    line set at every pixel: one kept call with a launch missing reads
    ``line_opacity_err`` inf, and the run is not correct."""
    real_close = kernel1_tap.Kernel1Tap.close

    def close(self):
        kept = real_close(self)
        next(iter(kept["calls"].values())).pop()
        return kept

    monkeypatch.setattr(kernel1_tap.Kernel1Tap, "close", close)
    result = small_run(workload)
    assert result["compared"]["line_opacity_err"]["value"] == float("inf")
    assert result["compared"]["spectrum_rel_err"]["value"] < SOUND["spectrum_rel_err"]
    assert not result["correct"]


@pytest.mark.parametrize("workload", SPECTRUM_CELLS)
def test_tap_reads_the_windows_own_calls(workload, monkeypatch):
    """The kept line opacities are the window's calls' own: with Kernel 1's
    output scaled x1.01 there alone, each of them reads 0.01 off the
    reference, and the run's other readings are a sound run's."""
    kernel1_off(monkeypatch)
    result = small_run(workload)
    assert abs(result["compared"]["line_opacity_err"]["value"] - 0.01) < 1e-9
    assert abs(result["compared"]["line_opacity_pixel_err"]["value"] - 0.01) < 1e-9
    assert result["compared"]["spectrum_rel_err"]["value"] < 0.01
