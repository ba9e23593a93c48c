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
                               mem.count_alpha_sources(plan),
                               tracked=plan.track_individual_intensities)


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
        tracked=track,
    ) + mem.fixed_overhead_bytes(plan, n_segments=k)
    assert est <= mem.HEADROOM * budget
    # one segment fewer would not fit
    per_seg = -(-len(plan.tracing_nus) // (k - 1))
    assert (per_seg * _per_px(plan) + fixed > mem.HEADROOM * budget) or k == 2


def test_monotonic_in_grid_and_budget():
    # untracked: 56 x 4 planes x 4 B a pixel, so 800k points segment under
    # the smallest budget
    budgets = [1 << 31, 1 << 30, 1 << 29]
    for n_nu in (50_000, 200_000, 800_000):
        ks = [mem.choose_nu_segments(_fake_plan(n_nu=n_nu), bytes_limit=b) for b in budgets]
        assert ks == sorted(ks)
    assert mem.choose_nu_segments(_fake_plan(n_nu=800_000), bytes_limit=budgets[-1]) > 1
    assert (mem.choose_nu_segments(_fake_plan(n_nu=800_000), bytes_limit=1 << 30)
            >= mem.choose_nu_segments(_fake_plan(n_nu=50_000), bytes_limit=1 << 30))


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
    monkeypatch.setenv("STARDIS_SEGMENT_BUDGET", str(1 << 29))
    assert mem.choose_nu_segments(plan) > 1


def test_device_bytes_limit_without_a_card():
    assert mem.device_bytes_limit("cpu") == mem.DEFAULT_BYTES_LIMIT == 80 * 10**9
    if not torch.cuda.is_available():
        assert mem.device_bytes_limit() == mem.DEFAULT_BYTES_LIMIT


def test_model_terms():
    """Per pixel: the opacity sources, total, source and F_nu, and Kernel 2's
    [D, n, T] buffer only when I_nu is tracked (an untracked forward launch
    allocates none); fixed: 8 [L, D] line arrays, plus the preallocated
    F_nu (and I_nu when tracked) only with segments."""
    assert mem.per_pixel_bytes(56, 20, 5, itemsize=4, tracked=True) == 56 * (5 + 3 + 20) * 4
    assert mem.per_pixel_bytes(56, 20, 5, itemsize=4, tracked=False) == 56 * (5 + 3) * 4
    assert (mem.estimate_segment_bytes(1000, 56, 20, 5, 8, tracked=True)
            - mem.estimate_segment_bytes(1000, 56, 20, 5, 8, tracked=False)) == 1000 * 56 * 20 * 8
    for track in (False, True):
        plan = _fake_plan(n_nu=1000, track=track)
        assert _per_px(plan) == 56 * (1 + 3 + (20 if track else 0)) * 4
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


# ----------------------------------------------------------------------
# a captured stage-1 graph's pool (pipeline.CapturedStage1) in the model
# ----------------------------------------------------------------------

class _Capture:
    """Stands in for a CapturedStage1: what ``util.memory.register_pool``
    reads of it."""

    def __init__(self, device, pool_bytes, pool_free_bytes):
        self.device = device
        self.pool_bytes = pool_bytes
        self.pool_free_bytes = pool_free_bytes


def test_pool_bytes_are_fixed_overhead_and_can_raise_k():
    """A graph's pool adds its bytes to the fixed overhead at any K, and a
    budget that holds the whole grid without the pool needs segments with
    it; the K chosen with the pool fits the budget with the pool."""
    plan = _fake_plan(n_nu=200_000, n_lines=1000)
    pool = 40 * 10**6
    for k in (1, 2, 5):
        assert (mem.fixed_overhead_bytes(plan, k, 4, pool_bytes=pool)
                == mem.fixed_overhead_bytes(plan, k, 4) + pool)
    n_nu, per_px = len(plan.tracing_nus), _per_px(plan)
    budget = int((mem.fixed_overhead_bytes(plan, 1) + per_px * n_nu) / mem.HEADROOM) + 1
    assert mem.choose_nu_segments(plan, budget) == 1
    k = mem.choose_nu_segments(plan, budget, pool_bytes=pool)
    assert k > 1
    assert (mem.fixed_overhead_bytes(plan, k, 4, pool) + -(-n_nu // k) * per_px
            <= mem.HEADROOM * budget)
    assert mem.choose_nu_segments(plan, budget, pool_bytes=pool // 2) <= k


def _fake_card(monkeypatch, free=10_000, reserved=3_000, allocated=1_000):
    """torch.cuda's memory queries of one card, cuda:0, without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (free, 80_000))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: reserved)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device: allocated)


def test_live_pools_leave_the_device_limit_and_dead_ones_the_registry(monkeypatch):
    """device_bytes_limit takes out the free bytes of every live pool on
    its device (not another card's); a capture that is dropped leaves the
    registry, and the limit comes back."""
    _fake_card(monkeypatch)
    card0, card1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert mem.device_bytes_limit(card0) == 10_000 + 3_000 - 1_000
    mine = _Capture(card0, pool_bytes=1_500, pool_free_bytes=600)
    other = _Capture(card1, pool_bytes=900, pool_free_bytes=400)
    mem.register_pool(mine)
    mem.register_pool(other)
    assert mem.resident_pools(card0) == [mine]
    for device in (card0, "cuda", None):
        assert mem.device_bytes_limit(device) == 12_000 - 600
    del mine
    assert mem.resident_pools(card0) == []
    assert mem.device_bytes_limit(card0) == 12_000
    assert mem.resident_pools(card1) == [other]


def test_registry_holds_under_racing_threads(monkeypatch):
    """Threads registering and dropping captures while others read the
    limit: every read sees a whole set, and only the kept captures stay."""
    import sys
    import threading

    _fake_card(monkeypatch)
    card0 = torch.device("cuda", 0)
    kept, errors = [], []

    def churn(i):
        try:
            for j in range(200):
                capture = _Capture(card0, 10, 1)
                mem.register_pool(capture)
                if j % 50 == 0:
                    kept.append(capture)
                limit = mem.device_bytes_limit(card0)
                assert 12_000 - 10 * 200 <= limit <= 12_000
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=churn, args=(i,)) for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(mem.resident_pools(card0)) == len(kept) == 40
    assert mem.device_bytes_limit(card0) == 12_000 - 40
    kept.clear()
    assert mem.resident_pools(card0) == []
