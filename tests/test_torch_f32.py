"""float32 against float64 within the port, at the bounds of
tests/test_f32_consistency.py: the line opacity and F_nu within
5e-4 |f64| + 1e-5 max_row |f64| (the absolute term absorbs window-edge
pixels whose mask membership flips with dtype rounding), partition
functions within 1e-4.  The GPU runs the slice in float32."""

import numpy as np
import pytest
import torch

from stardis_tpu_torch import units as u
from stardis_tpu_torch.atom_data import build_builtin_atom_data
from stardis_tpu_torch.base import parse_config_to_model
from stardis_tpu_torch.io.synthetic import write_marcs_file
from stardis_tpu_torch.opacities import line_kernel as tlk
from stardis_tpu_torch.opacities.lines import synth_linelist
from stardis_tpu_torch.pipeline import build_simulation_plan, run_simulation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_f32_tracks_f64(f32, f64):
    f32 = np.asarray(f32, dtype=np.float64)
    err = np.abs(f32 - f64)
    bound = 5e-4 * np.abs(f64) + 1e-5 * np.abs(f64).max(axis=1, keepdims=True)
    bad = err > bound
    assert not bad.any(), (
        f"{bad.sum()} pixels exceed the f32 consistency bound; "
        f"worst ratio {(err / np.maximum(bound, 1e-300)).max():.2f}"
    )


@pytest.mark.parametrize("n_depth", [16, 13])
def test_line_accumulation_f32_tracks_f64(n_depth):
    rng = np.random.default_rng(3)
    n_lines, n_nu = 64, 512
    nus = np.linspace(4.6e14, 4.5e14, n_nu)
    line_nu = np.sort(rng.uniform(nus.min(), nus.max(), n_lines))
    doppler = rng.uniform(1e9, 5e9, (n_lines, n_depth))
    gamma = rng.uniform(1e8, 2e9, (n_lines, n_depth))
    alpha = rng.uniform(0.1, 1.0, (n_lines, n_depth)) * 10 ** rng.uniform(-12, -3, (n_lines, 1))
    nu_ref = float(nus[n_nu // 2])
    d_nu = tlk.grid_min_step(nus)
    centers = torch.from_numpy(tlk.line_center_indices(nus, line_nu))
    out = {}
    for dtype in (torch.float64, torch.float32):
        t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)  # noqa: E731
        iw = tlk.window_half_widths(t(alpha), t(gamma), t(doppler), d_nu, n_nu)
        out[dtype] = tlk.line_opacity_range(tlk.prepare_line_opacity(
            t(nus - nu_ref), t(line_nu - nu_ref), centers, t(alpha), t(gamma), t(doppler), iw
        )).numpy()
    assert out[torch.float32].dtype == np.float32
    _assert_f32_tracks_f64(out[torch.float32], out[torch.float64])


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    model = str(tmp_path_factory.mktemp("f32") / "sun.mod")
    write_marcs_file(model)
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": model, "final_atomic_number": 30},
        "opacity": {
            "bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
            "line": {
                "disable": False,
                "broadening": ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"],
                "vald_linelist": {"use_linelist": True, "use_vald_broadening": True},
            },
        },
        "no_of_thetas": 20,
    }
    adata = synth_linelist(build_builtin_atom_data(30, include_linelists=True), 600,
                           lam_lo=6499.0, lam_hi=6504.0)
    config, adata, model_t = parse_config_to_model(cfg, atom_data=adata)
    lams = np.arange(6500.0, 6503.0, 0.01)
    nus = np.asarray(u.Quantity(lams, u.AA).to(u.Hz, u.spectral()))
    plan = build_simulation_plan(config, adata, model_t, nus)
    return {dtype: run_simulation(plan, device="cpu", dtype=dtype) for dtype in (torch.float64, torch.float32)}


def test_slice_line_opacity_f32_tracks_f64(slice_runs):
    f32 = slice_runs[torch.float32][2]["alpha_line_at_nu"]
    f64 = slice_runs[torch.float64][2]["alpha_line_at_nu"]
    assert f32.dtype == torch.float32
    _assert_f32_tracks_f64(f32.numpy(), f64.numpy())


def test_slice_flux_f32_tracks_f64(slice_runs):
    f32 = slice_runs[torch.float32][0]
    f64 = slice_runs[torch.float64][0]
    assert f32.dtype == torch.float32 and np.isfinite(f32.numpy()).all()
    _assert_f32_tracks_f64(f32.numpy(), f64.numpy())


def test_partition_functions_f32_track_f64(slice_runs):
    u32 = slice_runs[torch.float32][4].partition_function.numpy().astype(np.float64)
    u64 = slice_runs[torch.float64][4].partition_function.numpy()
    assert (np.abs(u32 - u64) / u64).max() < 1e-4


def test_quadratic_stark_f32_tracks_f64():
    """The quadratic Stark width folds e^2 a0^3 (3.4e-44, below float32's
    smallest normal number) in float64 before the cast: H-alpha's width at
    a hot photosphere within 1e-5 of float64 (the unfolded product cast
    alone kept one or two digits, 1.1e-2)."""
    from stardis_tpu_torch.opacities.broadening import calc_gamma_quadratic_stark

    out = {}
    for dtype in (torch.float64, torch.float32):
        t = lambda *x: torch.tensor(x, dtype=dtype)  # noqa: E731
        out[dtype] = calc_gamma_quadratic_stark(
            t(1.0, 2.0)[:, None], t(3.0008, 4.2)[:, None], t(2.0005, 3.1)[:, None],
            t(1e12, 3e14, 1e15)[None, :], t(4500.0, 9000.0, 12000.0)[None, :])
    assert out[torch.float32].dtype == torch.float32
    rel = (out[torch.float32].double() / out[torch.float64] - 1).abs().max().item()
    assert rel < 1e-5, rel
