"""Each traffic kind, driven whole on the CPU at small sizes in float64,
agrees with the reference; with its timed path broken underneath, the same
run reads ``correct`` false.  The look for a card is ``run.py``'s, which
these tests skip: they call ``bench.run`` on the CPU."""

import numpy as np
import pytest
import torch

from portbench import bench

CELLS = [w["name"] for w in bench.load_spec()["workloads"]]
SEED = 2**31 + 77
#: the most a sound float64 run on the CPU reads, by number compared: the
#: spectra, the fit's model spectra and Kernel 1b's outputs agree to
#: rounding; the fit's gradient is held to the reference's central
#: difference in the T scale (its truncation reads up to 1.5e-8 of that
#: component at these sizes)
SOUND = {"spectrum_rel_err": 1e-9, "fit_model_err": 1e-9, "fit_grad_rel_err": 1e-7,
         "kernel1b_grad_err": 1e-9}


def small_run(workload, seconds=0.5, trace=0):
    torch.set_num_threads(2)
    return bench.run(workload, SEED, seconds, trace, "cpu", torch.float64,
                     overrides=bench.test_sizes(workload), log=lambda msg: None)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = small_run(workload)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert all(entry["value"] < SOUND[name] for name, entry in result["compared"].items())
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


FAULTS = [(cell, altered_answer) for cell in CELLS] + [
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
