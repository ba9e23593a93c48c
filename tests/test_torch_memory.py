"""The port's device-memory model (``stardis_tpu_torch.util.memory``).

The invariants of tests/test_memory_model.py held on the port's model: a
generous budget never segments; a tight one segments enough that the
estimate fits; the choice is monotonic in grid size and budget; a hopeless
budget returns 1; a pathological one raises; the STARDIS_SEGMENT_BUDGET
variable sets the budget; without a card the budget is the card's 80 GB.
Plus the counts read off a real plan, and run_stardis(nu_segments="auto")
under a budget that forces segments, equal to the unsegmented run.
The model's coefficients against measured peaks are checked on the card
(chip_smoke.py phase 9)."""

import types

import numpy as np
import pytest
import torch

import stardis_tpu_torch
from stardis_tpu_torch import pipeline as tpipe
from stardis_tpu_torch import units as u
from stardis_tpu_torch.io.synthetic import write_marcs_file
from stardis_tpu_torch.util import memory as mem


def _fake_plan(n_nu=1000, n_depth=56, n_thetas=20, n_lines=0, track=False):
    line_data = types.SimpleNamespace(nu=np.ones(n_lines), n_lines=n_lines) if n_lines else None
    return types.SimpleNamespace(
        tracing_nus=np.linspace(5e14, 4e14, n_nu),
        temperatures=np.full(n_depth, 5000.0),
        weights=np.full(n_thetas, 0.1),
        file_sources=[],
        bf=None,
        ff_slots=np.asarray([]),
        rayleigh_species=[],
        disable_electron_scattering=True,
        line_data=line_data,
        molecule_line_data=None,
        track_individual_intensities=track,
    )


def _per_px(plan):
    return mem.per_pixel_bytes(len(plan.temperatures), len(plan.weights),
                               mem.count_alpha_sources(plan))


def test_generous_budget_never_segments():
    assert mem.choose_nu_segments(_fake_plan(n_nu=500_000), bytes_limit=1 << 50) == 1


@pytest.mark.parametrize("track", [False, True])
def test_tight_budget_segments_and_fits(track):
    # 3 angles: with I_nu tracked at 20, the preallocated [D, N, T] output
    # alone takes most of what segments would save
    plan = _fake_plan(n_nu=200_000, n_thetas=3, n_lines=1000, track=track)
    variable = len(plan.tracing_nus) * _per_px(plan)
    fixed = mem.fixed_overhead_bytes(plan, n_segments=2)
    budget = int((fixed + variable / 4) / mem.HEADROOM)
    k = mem.choose_nu_segments(plan, bytes_limit=budget)
    assert k > 1
    per_seg = -(-len(plan.tracing_nus) // k)
    est = mem.estimate_segment_bytes(
        per_seg, len(plan.temperatures), len(plan.weights), mem.count_alpha_sources(plan),
    ) + mem.fixed_overhead_bytes(plan, n_segments=k)
    assert est <= mem.HEADROOM * budget
    # one segment fewer would not fit
    per_seg = -(-len(plan.tracing_nus) // (k - 1))
    assert (per_seg * _per_px(plan) + fixed > mem.HEADROOM * budget) or k == 2


def test_monotonic_in_grid_and_budget():
    budgets = [1 << 34, 1 << 33, 1 << 32]
    for n_nu in (50_000, 200_000, 800_000):
        ks = [mem.choose_nu_segments(_fake_plan(n_nu=n_nu), bytes_limit=b) for b in budgets]
        assert ks == sorted(ks)
    assert (mem.choose_nu_segments(_fake_plan(n_nu=800_000), bytes_limit=1 << 33)
            >= mem.choose_nu_segments(_fake_plan(n_nu=50_000), bytes_limit=1 << 33))


def test_hopeless_budget_returns_1():
    assert mem.choose_nu_segments(_fake_plan(n_nu=10_000), bytes_limit=1 << 10) == 1


def test_pathological_segment_count_raises():
    plan = _fake_plan(n_nu=600_000)
    fixed = mem.fixed_overhead_bytes(plan, n_segments=2)
    budget = int((fixed + 3 * _per_px(plan)) / mem.HEADROOM)
    with pytest.raises(ValueError, match="sanity bound"):
        mem.choose_nu_segments(plan, bytes_limit=budget)


def test_env_var_budget(monkeypatch):
    plan = _fake_plan(n_nu=800_000)
    assert mem.choose_nu_segments(plan, bytes_limit=1 << 50) == 1
    monkeypatch.setenv("STARDIS_SEGMENT_BUDGET", str(1 << 32))
    assert mem.choose_nu_segments(plan) > 1


def test_device_bytes_limit_without_a_card():
    assert mem.device_bytes_limit("cpu") == mem.DEFAULT_BYTES_LIMIT == 80 * 10**9
    if not torch.cuda.is_available():
        assert mem.device_bytes_limit() == mem.DEFAULT_BYTES_LIMIT


def test_model_terms():
    """Per pixel: the opacity sources, total, source and F_nu, and Kernel 2's
    [D, n, T] buffer; fixed: 8 [L, D] line arrays, plus the preallocated
    F_nu (and I_nu when tracked) only with segments."""
    assert mem.per_pixel_bytes(56, 20, 5, itemsize=4) == 56 * (5 + 3 + 20) * 4
    plan = _fake_plan(n_nu=1000, n_lines=100, track=True)
    assert mem.count_alpha_sources(plan) == 2  # electron scattering + the line set
    assert mem.fixed_overhead_bytes(plan, 1, 8) == 8 * 100 * 56 * 8
    assert mem.fixed_overhead_bytes(plan, 3, 8) == 8 * 100 * 56 * 8 + 21 * 56 * 1000 * 8


def _config(model):
    return {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:5",
        "input_model": {"type": "marcs", "fname": model, "final_atomic_number": 5},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
                    "line": {"disable": False, "broadening": ["radiation", "linear_stark"]}},
        "no_of_thetas": 3,
        "result_options": {},
    }


def test_count_alpha_sources_of_a_plan(tmp_path):
    model = str(tmp_path / "sun.mod")
    write_marcs_file(model)
    config, adata, stellar_model = stardis_tpu_torch.parse_config_to_model(_config(model))
    nus = u.Quantity(np.arange(6555.0, 6575.0, 0.5), u.AA).to(u.Hz, u.spectral()).value
    plan = tpipe.build_simulation_plan(config, adata, stellar_model, nus)
    opacities = tpipe.run_simulation(plan, device="cpu", dtype=torch.float64)[2]
    grids = [k for k in opacities if "gammas" not in k and "doppler" not in k]
    assert mem.count_alpha_sources(plan) == len(grids) == 5


def test_auto_segments_under_a_budget(tmp_path, monkeypatch):
    model = str(tmp_path / "sun.mod")
    write_marcs_file(model)
    cfg = _config(model)
    lam = u.Quantity(np.arange(6555.0, 6575.0, 0.05), u.AA)
    whole = stardis_tpu_torch.run_stardis(cfg, lam, device="cpu", dtype=torch.float64)
    config, adata, stellar_model = stardis_tpu_torch.parse_config_to_model(cfg)
    plan = tpipe.build_simulation_plan(
        config, adata, stellar_model, lam.to(u.Hz, u.spectral()).value)
    per_px = _per_px(plan) * 2  # float64
    budget = int((mem.fixed_overhead_bytes(plan, 2, 8) + per_px * len(lam) / 3) / mem.HEADROOM)
    monkeypatch.setenv("STARDIS_SEGMENT_BUDGET", str(budget))
    assert mem.choose_nu_segments(plan, itemsize=8) in (3, 4)
    seg = stardis_tpu_torch.run_stardis(cfg, lam, device="cpu", dtype=torch.float64,
                                        nu_segments="auto")
    np.testing.assert_allclose(np.asarray(seg.spectrum_nu), np.asarray(whole.spectrum_nu),
                               rtol=1e-12, atol=0)
