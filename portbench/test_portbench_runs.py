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


def small_run(workload, seconds=0.5, trace=0):
    torch.set_num_threads(2)
    return bench.run(workload, SEED, seconds, trace, "cpu", torch.float64,
                     overrides=bench.test_sizes(workload), log=lambda msg: None)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = small_run(workload)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert result["compared"]["spectrum_rel_err"]["value"] < 1e-9
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


FAULTS = [(cell, altered_answer) for cell in CELLS] + [
    ("giant_mol.batch8", half_batch_left_out)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_broken_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = small_run(workload)
    assert not result["correct"]
    value = result["compared"]["spectrum_rel_err"]
    assert value["value"] > value["limit"] and np.isfinite(value["value"])
