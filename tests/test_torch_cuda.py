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
    ours = tlk.line_opacity_range(
        tlk.prepare_line_opacity(grid, line_nu, centers, alpha, gamma, doppler, iw))
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
        tlk.prepare_line_opacity(grid, line_nu.flip(0), centers.flip(0), alpha, gamma,
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
    ours = tlk.line_opacity_range(
        tlk.prepare_line_opacity(grid, line_nu, centers, alpha_b, gamma_b, doppler_b, iw))
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_range_launch_equals_full_launch_and_plain(cuda, dtype):
    """Kernel 1 over K = 3 pixel ranges (the grid's 2000 pixels not
    divisible by 3) equals the full launch bit for bit; in float64 each
    range equals the plain range sum at 1e-12."""
    grid, line_nu, centers, alpha, gamma, doppler, d_nu = _lines(dtype, cuda)
    iw = tlk.window_half_widths(alpha, gamma, doppler, d_nu, grid.shape[0])
    prepared = tlk.prepare_line_opacity(grid, line_nu, centers, alpha, gamma, doppler, iw)
    full = tlk.line_opacity_range(prepared)
    before = tlk.accumulate_line_opacity_cuda.range_launches
    bounds = [(0, 667), (667, 1334), (1334, 2000)]
    parts = [tlk.line_opacity_range(prepared, a, b - a) for a, b in bounds]
    torch.cuda.synchronize()
    assert tlk.accumulate_line_opacity_cuda.range_launches == before + 3
    assert torch.equal(torch.cat(parts, dim=1), full)
    if dtype == torch.float64:
        for (a, b), part in zip(bounds, parts):
            plain = tlk.accumulate_line_opacity_plain(grid, line_nu, centers, alpha, gamma,
                                                      doppler, iw, p_begin=a, n_out=b - a)
            torch.testing.assert_close(part, plain, rtol=1e-12, atol=0)


def test_segmented_run_stardis_equals_unsegmented(cuda, tmp_path):
    """run_stardis(nu_segments=3) on the card equals the unsegmented run,
    F_nu and I_nu (float32, rtol 1e-6; bit for bit expected)."""
    import stardis_tpu_torch
    from stardis_tpu_torch import units as u
    from stardis_tpu_torch.io.synthetic import write_marcs_file

    model = str(tmp_path / "sun.mod")
    write_marcs_file(model)
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": model, "final_atomic_number": 30},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
                    "line": {"disable": False, "broadening": ["radiation", "van_der_waals"],
                             "vald_linelist": {"use_linelist": True,
                                               "use_vald_broadening": True}}},
        "no_of_thetas": 10,
        "result_options": {"return_radiation_field": True},
    }
    lam = u.Quantity(np.arange(5880.0, 5900.0, 0.01), u.AA)
    whole = stardis_tpu_torch.run_stardis(cfg, lam).stellar_radiation_field
    parts = stardis_tpu_torch.run_stardis(cfg, lam, nu_segments=3).stellar_radiation_field
    assert whole.F_nu.device.type == "cuda" and whole.F_nu.dtype == torch.float32
    torch.testing.assert_close(parts.F_nu, whole.F_nu, rtol=1e-6, atol=0)
    torch.testing.assert_close(parts.I_nus, whole.I_nus, rtol=1e-6, atol=0)
    np.testing.assert_allclose(parts.opacities.total_alphas,
                               whole.opacities.total_alphas.cpu().numpy(), rtol=1e-6, atol=0)


def _row_err(ours, ref, axis):
    """max over the other axes of max_axis |ours - ref| / max_axis |ref|."""
    diff = (ours - ref).abs().amax(dim=axis)
    scale = ref.abs().amax(dim=axis)
    assert bool((diff[scale == 0] == 0).all())
    return (diff[scale > 0] / scale[scale > 0]).max().item()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p_begin, n_out", [(0, 2000), (700, 600)], ids=["whole", "range"])
def test_line_grad_kernel_matches_plain(cuda, dtype, p_begin, n_out):
    """Kernel 1b through the autograd Function against its plain version
    (float64 at 1e-12, float32 at 1e-4 of each depth's largest gradient),
    over a model axis of 2; two launches equal bit for bit."""
    grid, line_nu, centers, alpha, gamma, doppler, d_nu = _lines(dtype, cuda)
    scale = torch.tensor([1.0, 30.0], device=cuda, dtype=dtype)[:, None, None]
    a = (alpha[None] * scale).requires_grad_()
    g = (gamma[None] * scale.sqrt()).requires_grad_()
    d = doppler[None].expand(2, -1, -1).contiguous().requires_grad_()
    iw = tlk.window_half_widths(a, g, d, d_nu, grid.shape[0])
    g_out = torch.randn((2, alpha.shape[1], n_out), device=cuda, dtype=dtype,
                        generator=torch.Generator(cuda).manual_seed(0))

    def kernel_grads():
        prepared = tlk.prepare_line_opacity(grid, line_nu, centers, a, g, d, iw)
        out = tlk.line_opacity_range(prepared, p_begin, n_out)
        return torch.autograd.grad(out, (a, g, d), g_out)

    before = tlk.accumulate_line_opacity_grad_cuda.launches
    first, second = kernel_grads(), kernel_grads()
    torch.cuda.synchronize()
    assert tlk.accumulate_line_opacity_grad_cuda.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    plain = tlk.accumulate_line_opacity_plain_backward(
        g_out, grid, line_nu, centers, a.detach(), g.detach(), d.detach(), iw,
        p_begin=p_begin, n_out=n_out)
    bound = 1e-12 if dtype == torch.float64 else 1e-4
    for k, p in zip(first, plain):
        assert _row_err(k, p, axis=1) <= bound  # per (model, depth), over lines


def _plane_atmosphere(n_depth=56, n_nu=2000, n_theta=20, seed=1):
    rng = np.random.default_rng(seed)
    depth = np.linspace(1.0, 0.0, n_depth)[:, None]
    alphas = 10.0 ** (-9.0 + 9.0 * depth) * (1.0 + 50.0 * rng.random((1, n_nu)) ** 8)
    source = 1e-5 * (1.0 + 3.0 * depth) ** 4 * (1.0 + 0.05 * rng.random((1, n_nu)))
    thetas, weights = tsolver.gauss_legendre_thetas(n_theta)
    ray = np.full((n_depth - 1, 1), 2e6) / np.cos(thetas)[None, :]
    return [a[None] for a in (alphas, source, ray)] + [None, weights]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("track", [False, True], ids=["F", "F_and_I"])
@pytest.mark.parametrize("spherical", [False, True], ids=["plane", "spherical"])
def test_formal_solution_grad_kernel_matches_plain(cuda, dtype, track, spherical):
    """Kernel 2b through the autograd Function against autograd of
    raytrace_plain, per (model, frequency) column over depth: float64 at
    1e-9 of the column's largest gradient (the two sum the weights'
    cancelling terms in other orders); in float32, where the gradient of
    these columns is itself only good to a few per cent against float64,
    the kernel's 2-norm error against the float64 gradient is at most 1.5x
    the plain version's (the worst column's error swings with the incoming
    gradient's cancellations in both).  Two launches are equal bit for
    bit."""
    if spherical:
        alphas, source, ray, corr, weights = _spherical_atmosphere(2, 56, 1000, 20, seed=3)
    else:
        alphas, source, ray, corr, weights = _plane_atmosphere()
    args = [torch.as_tensor(v, device=cuda).to(dtype) for v in (alphas, source, ray, weights)]
    a, s = args[0].clone().requires_grad_(), args[1].clone().requires_grad_()
    gen = torch.Generator(cuda).manual_seed(1)
    g_f = torch.randn(a.shape, device=cuda, dtype=dtype, generator=gen)
    g_i = (torch.randn((*a.shape, len(weights)), device=cuda, dtype=dtype, generator=gen)
           if track else None)

    def kernel_grads():
        f, i = tsolver.raytrace(a, s, args[2], args[3], inward_rays=spherical,
                                photospheric_correction=corr,
                                track_individual_intensities=track)
        outs = [f] + ([i] if track else [])
        grads = [g_f] + ([g_i] if track else [])
        return torch.autograd.grad(outs, (a, s), grads)

    counter = "inward_launches" if spherical else "launches"
    before = getattr(tsolver.raytrace_grad_cuda, counter)
    first, second = kernel_grads(), kernel_grads()
    torch.cuda.synchronize()
    assert getattr(tsolver.raytrace_grad_cuda, counter) == before + 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))

    def plain(*tensors):
        return tsolver.raytrace_plain_backward(*tensors, inward_rays=spherical,
                                               photospheric_correction=corr)

    ref = plain(a.detach(), s.detach(), args[2], args[3], g_f, g_i)
    if dtype == torch.float64:
        for k, p in zip(first, ref):
            assert _row_err(k, p, axis=1) <= 1e-9
        return
    f64 = [None if t is None else t.double()
           for t in (a.detach(), s.detach(), args[2], args[3], g_f, g_i)]
    exact = plain(*f64)
    for k, p, e in zip(first, ref, exact):
        assert (k.double() - e).norm() <= 1.5 * (p.double() - e).norm()
