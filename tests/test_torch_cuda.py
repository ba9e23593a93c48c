"""The hand-written CUDA kernels against their plain torch versions, on the
card.  Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip without
them (a CUDA kernel has no CPU mode).  Run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py``; chip_smoke.py makes the same
comparisons at the slice's full shapes."""

import os
import shutil

import numpy as np
import pytest
import torch

from stardis_tpu_torch.opacities import line_kernel as tlk
from stardis_tpu_torch.radiation_field import solver as tsolver

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("no nvcc to build the kernels")
    return torch.device("cuda")


def _lines(dtype, device, n_lines=300, n_depth=13, n_nu=2000, seed=0):
    rng = np.random.default_rng(seed)
    nus = np.linspace(4.6e14, 4.5e14, n_nu)
    line_nu = np.sort(rng.uniform(nus.min(), nus.max(), n_lines))
    doppler = rng.uniform(1e9, 5e9, (n_lines, n_depth))
    gamma = rng.uniform(1e8, 2e9, (n_lines, n_depth))
    alpha = rng.uniform(0.1, 1.0, (n_lines, n_depth)) * 10 ** rng.uniform(-12, -1, (n_lines, 1))
    nu_ref = float(nus[n_nu // 2])
    t = lambda a: torch.as_tensor(a, device=device).to(dtype)  # noqa: E731
    centers = torch.as_tensor(tlk.line_center_indices(nus, line_nu), device=device)
    return (t(nus - nu_ref), t(line_nu - nu_ref), centers, t(alpha), t(gamma),
            t(doppler), tlk.grid_min_step(nus))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_line_kernel_matches_plain(cuda, dtype):
    grid, line_nu, centers, alpha, gamma, doppler, d_nu = _lines(dtype, cuda)
    iw = tlk.window_half_widths(alpha, gamma, doppler, d_nu, grid.shape[0])
    before = tlk.accumulate_line_opacity_cuda.launches
    ours = tlk.accumulate_line_windows(grid, line_nu, centers, alpha, gamma, doppler, iw)
    torch.cuda.synchronize()
    assert tlk.accumulate_line_opacity_cuda.launches == before + 1
    plain = tlk.accumulate_line_opacity_plain(grid, line_nu, centers, alpha, gamma, doppler, iw)
    ours, plain = ours.double().cpu().numpy(), plain.double().cpu().numpy()
    if dtype == torch.float64:
        np.testing.assert_allclose(ours, plain, rtol=1e-12, atol=0)
    else:
        err = np.abs(ours - plain).max(axis=1)
        assert (err <= 1e-5 * np.abs(plain).max(axis=1)).all()


def test_line_kernel_rejects_unsorted_lines(cuda):
    grid, line_nu, centers, alpha, gamma, doppler, d_nu = _lines(torch.float32, cuda)
    with pytest.raises(ValueError, match="sorted"):
        iw = tlk.window_half_widths(alpha, gamma, doppler, d_nu, grid.shape[0])
        tlk.accumulate_line_windows(grid, line_nu.flip(0), centers.flip(0), alpha, gamma,
                                    doppler, iw)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_formal_solution_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(1)
    n_depth, n_nu, n_theta = 56, 3000, 20
    depth = np.linspace(1.0, 0.0, n_depth)[:, None]
    alphas = 10.0 ** (-9.0 + 9.0 * depth) * (1.0 + 50.0 * rng.random((1, n_nu)) ** 8)
    source = 1e-5 * (1.0 + 3.0 * depth) ** 4 * (1.0 + 0.05 * rng.random((1, n_nu)))
    thetas, weights = tsolver.gauss_legendre_thetas(n_theta)
    ray = np.full((n_depth - 1, 1), 2e6) / np.cos(thetas)[None, :]
    args = [torch.as_tensor(a, device=cuda).to(dtype) for a in (alphas, source, ray, weights)]
    f, i = tsolver.raytrace(*args, photospheric_correction=1.3,
                            track_individual_intensities=True)
    fp, ip = tsolver.raytrace_plain(*args, photospheric_correction=1.3,
                                    track_individual_intensities=True)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(f, fp, rtol=rtol, atol=0)
    torch.testing.assert_close(i, ip, rtol=rtol, atol=0)


def _spherical_atmosphere(n_models, n_depth, n_nu, n_theta, seed):
    """Spherical shells (radii 1e12 cm plus a 5e10 cm atmosphere) so that
    the outer chords miss inner shells (ray distance 0)."""
    rng = np.random.default_rng(seed)
    depth = np.linspace(1.0, 0.0, n_depth)[:, None]
    alphas, sources, rays, corrs = [], [], [], []
    thetas, weights = tsolver.gauss_legendre_thetas(n_theta)
    for b in range(n_models):
        alphas.append(10.0 ** (-11.0 + 10.0 * depth) * (1.0 + 50.0 * rng.random((1, n_nu)) ** 8))
        sources.append(1e-5 * (1.0 + 3.0 * depth) ** 4 * (1.0 + 0.05 * rng.random((1, n_nu))))
        radii = 1e12 + np.linspace(0.0, 5e10 * (1.0 + 0.1 * b), n_depth)
        rays.append(tsolver.calculate_spherical_ray(thetas, radii))
        corrs.append((radii[-1] / (radii[-1] - 1e10)) ** 2)
    return [np.stack(a) for a in (alphas, sources, rays)] + [np.asarray(corrs), weights]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_formal_solution_inward_and_model_axis_match_plain(cuda, dtype):
    alphas, source, ray, corr, weights = _spherical_atmosphere(3, 56, 2000, 20, seed=2)
    assert (ray == 0).any()
    args = [torch.as_tensor(a, device=cuda).to(dtype) for a in (alphas, source, ray, weights)]
    before = tsolver.raytrace_cuda.inward_launches
    f, i = tsolver.raytrace(*args, inward_rays=True, photospheric_correction=corr,
                            track_individual_intensities=True)
    torch.cuda.synchronize()
    assert tsolver.raytrace_cuda.inward_launches == before + 1
    fp, ip = tsolver.raytrace_plain(*args, inward_rays=True, photospheric_correction=corr,
                                    track_individual_intensities=True)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    assert f.shape == (3, 56, 2000) and i.shape == (3, 56, 2000, 20)
    torch.testing.assert_close(f, fp, rtol=rtol, atol=0)
    torch.testing.assert_close(i, ip, rtol=rtol, atol=0)
    # each member of the batch equals its own single-model launch
    for b in range(3):
        fb, _ = tsolver.raytrace(args[0][b], args[1][b], args[2][b], args[3],
                                 inward_rays=True, photospheric_correction=float(corr[b]))
        torch.testing.assert_close(f[b], fb, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["reference", "accuracy"])
def test_line_kernel_model_axis_matches_plain(cuda, dtype, mode):
    grid, line_nu, centers, alpha, gamma, doppler, d_nu = _lines(dtype, cuda)
    scale = torch.tensor([1.0, 30.0, 1e-3], device=cuda, dtype=dtype)[:, None, None]
    alpha_b = alpha[None] * scale
    gamma_b = gamma[None].expand(3, -1, -1) * scale.sqrt()
    doppler_b = doppler[None].expand(3, -1, -1).contiguous()
    eps = 1e-6 * alpha_b.amax(dim=1) if mode == "accuracy" else None
    iw = tlk.window_half_widths(alpha_b, gamma_b, doppler_b, d_nu, grid.shape[0], mode, eps)
    before = tlk.accumulate_line_opacity_cuda.launches
    ours = tlk.accumulate_line_windows(grid, line_nu, centers, alpha_b, gamma_b, doppler_b,
                                       iw)
    torch.cuda.synchronize()
    assert tlk.accumulate_line_opacity_cuda.launches == before + 1
    assert ours.shape == (3, alpha.shape[1], grid.shape[0])
    plain = tlk.accumulate_line_opacity_plain(grid, line_nu, centers, alpha_b, gamma_b,
                                              doppler_b, iw)
    ours, plain = ours.double().cpu().numpy(), plain.double().cpu().numpy()
    if dtype == torch.float64:
        np.testing.assert_allclose(ours, plain, rtol=1e-12, atol=0)
    else:
        err = np.abs(ours - plain).max(axis=2)
        assert (err <= 1e-5 * np.abs(plain).max(axis=2)).all()
