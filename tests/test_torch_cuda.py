"""The hand-written CUDA kernels against their plain torch versions, on the
card.  Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip without
them (a CUDA kernel has no CPU mode).  Run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py``; chip_smoke.py makes the same
comparisons at the slice's full shapes."""

import ctypes
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


def _windows(kind, alpha, gamma, doppler, d_nu, n_nu, seed=3):
    """Half-windows of one kind: "reference" (window_half_widths),
    "grid-wide" (every window beyond the grid), "short" (1-3 pixels on half
    the pairs, beyond the grid on the others)."""
    if kind == "reference":
        return tlk.window_half_widths(alpha, gamma, doppler, d_nu, n_nu)
    rng = np.random.default_rng(seed)
    iw = np.full(alpha.shape, n_nu + 1)
    if kind == "short":
        iw = np.where(rng.random(alpha.shape) < 0.5, rng.integers(1, 4, alpha.shape), iw)
    return torch.as_tensor(iw, dtype=torch.int32, device=alpha.device)


@pytest.mark.parametrize("windows", ["reference", "grid-wide", "short", "far wing"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_line_kernel_matches_plain(cuda, dtype, windows):
    """Kernel 1 against its plain version: reference windows, every window
    beyond the grid, 1-3-pixel windows beside grid-wide ones, and the far
    wing (Doppler widths / 1000, grid-wide windows: |x| to ~1e8); two
    launches equal bit for bit."""
    grid, line_nu, centers, alpha, gamma, doppler, d_nu = _lines(dtype, cuda)
    if windows == "far wing":
        doppler = doppler * 1e-3
    iw = _windows("grid-wide" if windows == "far wing" else windows, alpha, gamma, doppler,
                  d_nu, grid.shape[0])
    before = tlk.accumulate_line_opacity_cuda.launches
    prepared = tlk.prepare_line_opacity(grid, line_nu, centers, alpha, gamma, doppler, iw)
    ours = tlk.line_opacity_range(prepared)
    again = tlk.line_opacity_range(prepared)
    torch.cuda.synchronize()
    assert tlk.accumulate_line_opacity_cuda.launches == before + 2
    assert torch.equal(ours, again)
    plain = tlk.accumulate_line_opacity_plain(grid, line_nu, centers, alpha, gamma, doppler, iw)
    ours, plain = ours.double().cpu().numpy(), plain.double().cpu().numpy()
    if dtype == torch.float64:
        np.testing.assert_allclose(ours, plain, rtol=1e-12, atol=0)
    else:
        err = np.abs(ours - plain).max(axis=1)
        assert (err <= 1e-5 * np.abs(plain).max(axis=1)).all()


def test_line_kernel_rejects_unsorted_lines(cuda):
    grid, line_nu, centers, alpha, gamma, doppler, d_nu = _lines(torch.float32, cuda)
    iw = tlk.window_half_widths(alpha, gamma, doppler, d_nu, grid.shape[0])
    with pytest.raises(ValueError, match="sorted"):
        tlk.prepare_line_opacity(grid, line_nu.flip(0), centers.flip(0), alpha, gamma,
                                 doppler, iw)
    # the kernel's core guard needs a strictly descending grid
    with pytest.raises(ValueError, match="descend"):
        tlk.prepare_line_opacity(grid.flip(0), line_nu, centers, alpha, gamma, doppler, iw)


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
@pytest.mark.parametrize("spherical", [False, True], ids=["plane", "spherical"])
def test_formal_solution_untracked_equals_tracked(cuda, dtype, spherical):
    """Kernel 2 writes the [B, D, N, T] intensity buffer only when I_nu is
    tracked: tracked and untracked F_nu are equal bit for bit, two launches
    too, and an untracked launch under no_grad raises the peak by less than
    one such buffer (F_nu alone is a T-th of it)."""
    if spherical:
        alphas, source, ray, corr, weights = _spherical_atmosphere(2, 56, 2000, 20, seed=4)
    else:
        alphas, source, ray, corr, weights = _plane_atmosphere()
    args = [torch.as_tensor(a, device=cuda).to(dtype) for a in (alphas, source, ray, weights)]
    kw = {"inward_rays": spherical, "photospheric_correction": corr}
    f_t, i_t = tsolver.raytrace(*args, track_individual_intensities=True, **kw)
    f_u, i_u = tsolver.raytrace(*args, **kw)
    f_again, _ = tsolver.raytrace(*args, **kw)
    torch.cuda.synchronize()
    assert i_u is None and torch.equal(f_t, f_u) and torch.equal(f_u, f_again)
    a = args[0].clone().requires_grad_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        f_n, _ = tsolver.raytrace(a, *args[1:], **kw)
    torch.cuda.synchronize()
    assert torch.equal(f_n, f_u)
    assert torch.cuda.max_memory_allocated() - base < i_t.numel() * i_t.element_size()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_formal_solution_rejects_too_many_angles(cuda, dtype):
    """A T no block can hold raises before any launch; the kernel's own
    shared-memory layout is the wrapper's."""
    before = tsolver.raytrace_cuda.launches
    n = tsolver.TRACE_MAX_THREADS + 1
    alphas = torch.ones((1, 4, 16), dtype=dtype, device=cuda)
    ray = torch.ones((1, 3, n), dtype=dtype, device=cuda)
    with pytest.raises(ValueError, match="formal_solution kernel"):
        tsolver.raytrace(alphas, alphas, ray, torch.ones(n, dtype=dtype, device=cuda))
    assert tsolver.raytrace_cuda.launches == before
    from stardis_tpu_torch import _cuda

    shared = _cuda.load("formal_solution").formal_solution_shared_bytes
    shared.restype = ctypes.c_longlong
    itemsize = torch.empty((), dtype=dtype).element_size()
    for n_depth, n_theta in ((56, 20), (13, 3), (2, 1), (56, 100)):
        tile, nbytes = tsolver.trace_tile(n_depth, n_theta, itemsize)
        assert shared(n_depth, n_theta, tile, tsolver.TRACE_CHUNK, itemsize) == nbytes


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


@pytest.mark.parametrize("case", ["thirds", "inside a region-I span"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_range_launch_equals_full_launch_and_plain(cuda, dtype, case):
    """Kernel 1 over K = 3 pixel ranges equals the full launch bit for bit;
    in float64 each range equals the plain range sum at 1e-12.  "thirds":
    reference windows, the grid's 2000 pixels not divisible by 3;
    "inside a region-I span": grid-wide windows, the boundaries 45 and 301
    pixels above a line's centre, inside its window and in its region I,
    where no block's span starts in the full launch."""
    grid, line_nu, centers, alpha, gamma, doppler, d_nu = _lines(dtype, cuda)
    n_nu = grid.shape[0]
    if case == "thirds":
        iw = _windows("reference", alpha, gamma, doppler, d_nu, n_nu)
        bounds = [(0, 667), (667, 1334), (1334, 2000)]
    else:
        iw = _windows("grid-wide", alpha, gamma, doppler, d_nu, n_nu)
        line = alpha.shape[0] // 3
        cuts = (int(centers[line]) + 45, int(centers[line]) + 301)
        assert all(0 < b < n_nu and b % 32 for b in cuts)
        x = (grid[list(cuts)][:, None] - line_nu[line]) / doppler[line]  # [2, D]
        y = gamma[line] / (tlk.SQRT_PI * tlk.PI) / doppler[line]
        assert bool((x.abs() + y > 15).all())
        bounds = [(0, cuts[0]), (cuts[0], cuts[1]), (cuts[1], n_nu)]
    prepared = tlk.prepare_line_opacity(grid, line_nu, centers, alpha, gamma, doppler, iw)
    full = tlk.line_opacity_range(prepared)
    before = tlk.accumulate_line_opacity_cuda.range_launches
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
@pytest.mark.parametrize("p_begin, n_out, windows", [
    (0, 2000, "adaptive"), (700, 600, "adaptive"), (0, 2000, "grid_wide"), (0, 2000, "short"),
], ids=["whole", "range", "grid_wide_windows", "short_windows"])
def test_line_grad_kernel_matches_plain(cuda, dtype, p_begin, n_out, windows):
    """Kernel 1b through the autograd Function against its plain version
    (float64 at 1e-12, float32 at 1e-4 of each depth's largest gradient),
    over a model axis of 2; two launches equal bit for bit.  Windows: the
    adaptive ones; every window spanning the grid (each tile's span split
    into chunks); half-windows of 1-3 pixels (mostly idle lanes)."""
    grid, line_nu, centers, alpha, gamma, doppler, d_nu = _lines(dtype, cuda)
    scale = torch.tensor([1.0, 30.0], device=cuda, dtype=dtype)[:, None, None]
    a = (alpha[None] * scale).requires_grad_()
    g = (gamma[None] * scale.sqrt()).requires_grad_()
    d = doppler[None].expand(2, -1, -1).contiguous().requires_grad_()
    iw = tlk.window_half_widths(a, g, d, d_nu, grid.shape[0])
    if windows == "grid_wide":
        iw = torch.full_like(iw, grid.shape[0] + 1)
    elif windows == "short":
        iw = torch.randint(1, 4, iw.shape, device=cuda, dtype=iw.dtype,
                           generator=torch.Generator(cuda).manual_seed(2))
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("spherical", [False, True], ids=["plane", "spherical"])
def test_formal_solution_grad_of_flux_independent_of_tracking(cuda, dtype, spherical):
    """The gradient of F_nu alone is the same bit for bit whether or not
    I_nu is tracked: Kernel 2b recomputes the sweep either way (tracked, the
    intensity buffer is only an output); untracked, the forward writes no
    buffer under autograd."""
    if spherical:
        alphas, source, ray, corr, weights = _spherical_atmosphere(2, 56, 1000, 20, seed=3)
    else:
        alphas, source, ray, corr, weights = _plane_atmosphere()
    args = [torch.as_tensor(v, device=cuda).to(dtype) for v in (alphas, source, ray, weights)]
    g_f = torch.randn(args[0].shape, device=cuda, dtype=dtype,
                      generator=torch.Generator(cuda).manual_seed(2))
    grads = {}
    for track in (False, True):
        a, s = args[0].clone().requires_grad_(), args[1].clone().requires_grad_()
        f, i = tsolver.raytrace(a, s, args[2], args[3], inward_rays=spherical,
                                photospheric_correction=corr,
                                track_individual_intensities=track)
        assert (i is not None) == track
        grads[track] = torch.autograd.grad(f, (a, s), g_f)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(grads[False], grads[True]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_formal_solution_grad_checkpointed_outward_matches_plain(cuda, dtype):
    """At more depths than one frequency's block can hold every entering
    intensity of (700 in float64, 1,400 in float32, at 20 angles), the
    outward variant keeps a checkpoint every TRACE_GRAD_SPAN steps and
    recomputes its segments: against autograd of raytrace_plain at the bars
    of test_formal_solution_grad_kernel_matches_plain, two launches equal
    bit for bit."""
    n_depth = 700 if dtype == torch.float64 else 1400
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert tsolver.trace_grad_tile(n_depth, 20, itemsize, False)[1] == tsolver.TRACE_GRAD_SPAN
    alphas, source, ray, corr, weights = _plane_atmosphere(n_depth=n_depth, n_nu=64)
    args = [torch.as_tensor(v, device=cuda).to(dtype) for v in (alphas, source, ray, weights)]
    a, s = args[0].clone().requires_grad_(), args[1].clone().requires_grad_()
    g_f = torch.randn(a.shape, device=cuda, dtype=dtype,
                      generator=torch.Generator(cuda).manual_seed(4))

    def kernel_grads():
        f, _ = tsolver.raytrace(a, s, args[2], args[3])
        return torch.autograd.grad(f, (a, s), g_f)

    before = tsolver.raytrace_grad_cuda.launches
    first, second = kernel_grads(), kernel_grads()
    torch.cuda.synchronize()
    assert tsolver.raytrace_grad_cuda.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    ref = tsolver.raytrace_plain_backward(a.detach(), s.detach(), args[2], args[3], g_f)
    if dtype == torch.float64:
        for k, p in zip(first, ref):
            assert _row_err(k, p, axis=1) <= 1e-9
        return
    exact = tsolver.raytrace_plain_backward(a.detach().double(), s.detach().double(),
                                            args[2].double(), args[3].double(), g_f.double())
    for k, p, e in zip(first, ref, exact):
        assert (k.double() - e).norm() <= 1.5 * (p.double() - e).norm()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("spherical", [False, True], ids=["plane", "spherical"])
def test_formal_solution_grad_layout_is_the_wrappers(cuda, dtype, spherical):
    """Kernel 2b's own shared-memory layout (its checkpoint spans and chunks
    included) is solver.trace_grad_shared's at the tiles and spans
    trace_grad_tile picks and at others, and a T no block can hold raises
    before any launch."""
    from stardis_tpu_torch import _cuda

    shared = _cuda.load("formal_solution_grad").formal_solution_grad_shared_bytes
    shared.restype = ctypes.c_longlong
    itemsize = torch.empty((), dtype=dtype).element_size()
    spans = (tsolver.TRACE_GRAD_SPAN,) if spherical else (1, tsolver.TRACE_GRAD_SPAN)
    for n_depth, n_theta in ((56, 20), (13, 3), (2, 1), (56, 100), (9, 7), (700, 20),
                             (1400, 20)):
        if itemsize == 8 and n_depth == 1400:
            continue
        tile, span, nbytes = tsolver.trace_grad_tile(n_depth, n_theta, itemsize, spherical)
        assert shared(n_depth, n_theta, tile, tsolver.TRACE_GRAD_CHUNK, span, itemsize,
                      int(spherical)) == nbytes
        for f in (1, 3, tile):
            for sp in spans:
                assert shared(n_depth, n_theta, f, tsolver.TRACE_GRAD_CHUNK, sp, itemsize,
                              int(spherical)) == tsolver.trace_grad_shared(
                                  n_depth, n_theta, f, sp, itemsize, spherical)
    n = tsolver.TRACE_MAX_THREADS + 1
    a = torch.ones((1, 4, 16), dtype=dtype, device=cuda)
    before = getattr(tsolver.raytrace_grad_cuda, "inward_launches" if spherical else "launches")
    with pytest.raises(ValueError, match="formal_solution_grad kernel"):
        tsolver.raytrace_grad_cuda(a, a, torch.ones((1, 3, n), dtype=dtype, device=cuda),
                                   torch.ones(n, dtype=dtype, device=cuda),
                                   torch.ones(1, dtype=dtype, device=cuda), a, None, spherical)
    assert getattr(tsolver.raytrace_grad_cuda,
                   "inward_launches" if spherical else "launches") == before


def _batch_on_card(tmp_path, teffs=(4800.0, 5777.0, 6500.0)):
    """(plan, BatchInputs) of a small plane-parallel batch: builtin:30 with
    synthetic VALD lines and VALD broadening, 56 depths, 500 pixels."""
    from stardis_tpu_torch import units as u
    from stardis_tpu_torch.atom_data import build_builtin_atom_data
    from stardis_tpu_torch.base import parse_config_to_model, read_stellar_model
    from stardis_tpu_torch.io.synthetic import write_marcs_file
    from stardis_tpu_torch.opacities.lines import synth_linelist
    from stardis_tpu_torch.parallel.batch import make_batch

    paths = []
    for i, teff in enumerate(teffs):
        paths.append(str(tmp_path / f"m{i}.mod"))
        write_marcs_file(paths[-1], teff=teff)
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": paths[0], "final_atomic_number": 30},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
                    "line": {"disable": False,
                             "broadening": ["radiation", "linear_stark", "quadratic_stark",
                                            "van_der_waals"],
                             "vald_linelist": {"use_linelist": True,
                                               "use_vald_broadening": True}}},
        "no_of_thetas": 10,
    }
    adata = synth_linelist(build_builtin_atom_data(30, include_linelists=True), 2000,
                           5879.0, 5906.0)
    config, adata, model0 = parse_config_to_model(cfg, atom_data=adata)
    models = [model0] + [read_stellar_model(config, adata, p) for p in paths[1:]]
    nus = u.Quantity(np.arange(5880.0, 5905.0, 0.05), u.AA).to(u.Hz, u.spectral()).value
    return make_batch(config, adata, models, nus)


def _stage1_tensors(state, quants):
    return list(state) + [x for triple in quants.values() for x in triple]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_captured_stage1_replays_the_eager_bits(cuda, tmp_path, dtype):
    """A replay of the captured stage 1 equals the eager stage bit for bit,
    and a second replay on other temperatures equals the eager stage on
    those: no stale buffer survives a replay."""
    from stardis_tpu_torch import pipeline as tpipe

    plan, batch = _batch_on_card(tmp_path)
    consts = tpipe.device_constants(plan, dtype, cuda)
    graph = tpipe.CapturedStage1(plan, consts, 3)
    assert graph.pool_bytes > 0
    for scale in (1.0, 1.04, 1.0):
        temps = batch.temperatures * scale
        eager = _stage1_tensors(*tpipe.stage_plasma_and_lines(
            plan, torch.as_tensor(temps, device=cuda).to(dtype),
            torch.as_tensor(batch.n_elem, device=cuda).to(dtype), consts))
        with graph.replay(temps, batch.n_elem) as out:
            replayed = [x.clone() for x in _stage1_tensors(*out)]
        assert all(torch.equal(a, b) for a, b in zip(replayed, eager)), scale


def test_run_batch_replays_a_cached_graph(cuda, tmp_path):
    """run_batch captures stage 1 once per (plan, B) and replays it; its
    F_nu equals the eager stage's through the same spectrum bit for bit,
    and a SpectralService's request equals its eager stage's."""
    from stardis_tpu_torch import pipeline as tpipe
    from stardis_tpu_torch.parallel import batch as tbatch

    plan, batch = _batch_on_card(tmp_path)
    tbatch._STAGE1_CACHE.clear()
    f_nu = tbatch.run_batch(plan, batch)
    again = tbatch.run_batch(plan, batch)
    assert len(tbatch._STAGE1_CACHE) == 1 and torch.equal(f_nu, again)
    consts = tpipe.device_constants(plan, torch.float32, cuda)
    state, quants = tpipe.stage_plasma_and_lines(
        plan, torch.as_tensor(batch.temperatures, device=cuda).float(),
        torch.as_tensor(batch.n_elem, device=cuda).float(), consts)
    lines = tpipe.prepare_lines(plan, state, quants, consts)
    eager = tpipe.spectrum_batch(plan, state, lines, consts, batch.ray_distances)[0]
    assert torch.equal(f_nu, eager)
    tbatch._STAGE1_CACHE.clear()


@pytest.fixture
def grad_graphs():
    """The differentiated stage-1 graphs of one test: none before it, none
    kept after it (each pins its pool, which the memory tests count)."""
    from stardis_tpu_torch import pipeline as tpipe
    from stardis_tpu_torch.parallel import batch as tbatch

    tpipe._STAGE1_GRAD_CACHE.clear()
    tbatch._GRAD_CONSTS.clear()
    yield tpipe._STAGE1_GRAD_CACHE
    tpipe._STAGE1_GRAD_CACHE.clear()
    tbatch._GRAD_CONSTS.clear()


def _giants_on_card(tmp_path, teffs=(3600.0, 4000.0, 4400.0)):
    """(plan, BatchInputs) of spherical giants with pairwise molecules:
    builtin:30 with synthetic VALD atomic and molecular lines, each
    member's K(T) and U(T) rows, 56 depths, 500 pixels."""
    from stardis_tpu_torch import units as u
    from stardis_tpu_torch.atom_data import build_builtin_atom_data
    from stardis_tpu_torch.base import parse_config_to_model, read_stellar_model
    from stardis_tpu_torch.io.synthetic import write_marcs_file
    from stardis_tpu_torch.opacities.lines import synth_linelist, synth_molecule_linelist
    from stardis_tpu_torch.parallel.batch import make_batch

    paths = []
    for i, teff in enumerate(teffs):
        paths.append(str(tmp_path / f"g{i}.mod"))
        write_marcs_file(paths[-1], teff=teff, logg=2.0, spherical=True, radius_cm=1.152e12)
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": paths[0], "final_atomic_number": 30},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H", "H2"],
                    "line": {"disable": False, "broadening": ["radiation", "van_der_waals"],
                             "vald_linelist": {"use_linelist": True,
                                               "use_vald_broadening": True},
                             "include_molecules": True}},
        "no_of_thetas": 10,
    }
    adata = build_builtin_atom_data(30, include_linelists=True, include_molecules=True)
    synth_linelist(adata, 2000, 5879.0, 5906.0)
    synth_molecule_linelist(adata, 1000, 5879.0, 5906.0)
    config, adata, model0 = parse_config_to_model(cfg, atom_data=adata)
    models = [model0] + [read_stellar_model(config, adata, p) for p in paths[1:]]
    nus = u.Quantity(np.arange(5880.0, 5905.0, 0.05), u.AA).to(u.Hz, u.spectral()).value
    return make_batch(config, adata, models, nus)


def _grad_counts():
    """(captures, forward replays, stale backwards) of the differentiated
    stage 1."""
    from stardis_tpu_torch.util import profiling

    c = profiling.counters()
    return [c["stage1_grad_captures"], c["stage1_grad_replays"],
            c["stage1_grad_stale_backwards"]]


def _scaled(temps, n_elem, dtype, device, scale):
    """T s and n / s with s a tensor that requires grad, as a fit's step
    makes them."""
    s = torch.tensor(scale, dtype=dtype, device=device, requires_grad=True)
    return (torch.as_tensor(temps, device=device).to(dtype) * s,
            torch.as_tensor(n_elem, device=device).to(dtype) / s)


def _line_loss(state, quants, seed=0):
    """A weighted sum of alpha, gamma, doppler and n_e, the weights drawn
    from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    used = [state.electron_densities] + [x for triple in quants.values() for x in triple]
    return sum((x * torch.rand(x.shape, generator=gen, dtype=x.dtype).to(x.device)).sum()
               for x in used)


@pytest.mark.parametrize("case", ["one model", "molecule batch"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_differentiated_stage1_replays_the_eager_bits(cuda, tmp_path, grad_graphs, dtype,
                                                      case):
    """Stage 1 under autograd replays its forward and backward graphs: over
    s = 1, 1.03, 0.97, 1 its outputs (bits and strides) and the gradients
    of T s and n / s through a loss on alpha, gamma, doppler and n_e equal
    the eager stage's bit for bit; one capture, a replay a call, no stale
    backward, a pool of its own."""
    from stardis_tpu_torch import pipeline as tpipe

    if case == "one model":
        plan, _batch = _batch_on_card(tmp_path)
        temps0, n_elem0, rows = plan.temperatures, plan.n_elem, None
    else:
        plan, batch = _giants_on_card(tmp_path)
        temps0, n_elem0 = batch.temperatures, batch.n_elem
        rows = tuple(torch.as_tensor(x, device=cuda).to(dtype) for x in batch.molecule_rows)
    consts = tpipe.device_constants(plan, dtype, cuda)
    before = _grad_counts()
    for scale in (1.0, 1.03, 0.97, 1.0):
        runs = []
        for stage in (tpipe._stage_plasma_and_lines, tpipe.stage_plasma_and_lines):
            inputs = _scaled(temps0, n_elem0, dtype, cuda, scale)
            state, quants = stage(plan, *inputs, consts, rows)
            grads = torch.autograd.grad(_line_loss(state, quants), inputs)
            runs.append((_stage1_tensors(state, quants), grads))
        (eager, want), (replayed, got) = runs
        assert all(torch.equal(a, b) and a.stride() == b.stride()
                   for a, b in zip(replayed, eager)), scale
        assert all(torch.equal(a, b) for a, b in zip(got, want)), scale
    assert _grad_counts() == [before[0] + 1, before[1] + 4, before[2]]
    (entry,) = grad_graphs.values()
    assert entry.pool_bytes > 0


def test_stale_backwards_retained_graphs_and_hooks(cuda, tmp_path, grad_graphs):
    """Two forwards, then their backwards in reverse order: each gradient is
    its own forward's (the second backward runs its forward again, counted
    once); a retained graph's two backwards give the same gradient; a hook
    on the returned alpha receives the eager stage's gradient."""
    from stardis_tpu_torch import pipeline as tpipe

    plan, _batch = _batch_on_card(tmp_path)
    dtype = torch.float32
    consts = tpipe.device_constants(plan, dtype, cuda)

    def run(scale, stage=tpipe.stage_plasma_and_lines):
        inputs = _scaled(plan.temperatures, plan.n_elem, dtype, cuda, scale)
        return inputs, stage(plan, *inputs, consts)

    def eager_grads(scale):
        inputs, out = run(scale, tpipe._stage_plasma_and_lines)
        return torch.autograd.grad(_line_loss(*out), inputs)

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    run(1.0)  # the capture
    (first, a), (second, b) = run(1.03), run(0.97)
    before = _grad_counts()
    g_second = torch.autograd.grad(_line_loss(*b), second)
    g_first = torch.autograd.grad(_line_loss(*a), first)
    assert equal(g_first, eager_grads(1.03)) and equal(g_second, eager_grads(0.97))
    assert _grad_counts()[2] == before[2] + 1

    inputs, out = run(1.0)
    loss = _line_loss(*out)
    once = torch.autograd.grad(loss, inputs, retain_graph=True)
    twice = torch.autograd.grad(loss, inputs)
    assert equal(once, twice) and equal(once, eager_grads(1.0))
    assert _grad_counts()[2] == before[2] + 1

    kept = {}
    for name, stage in (("eager", tpipe._stage_plasma_and_lines),
                        ("replayed", tpipe.stage_plasma_and_lines)):
        inputs, (state, quants) = run(1.0, stage)
        quants["atomic"][0].register_hook(lambda g, name=name: kept.__setitem__(name, g.clone()))
        torch.autograd.grad(_line_loss(state, quants), inputs)
    assert torch.equal(kept["eager"], kept["replayed"]) and kept["eager"].abs().amax() > 0


def test_threads_share_one_capture(cuda, tmp_path, grad_graphs):
    """Four threads step forward and backward at scales of their own
    through one entry while the interpreter switches every 10 us: each
    gradient is its own forward's, bit for bit, whichever backwards had to
    run their forward again."""
    import sys
    import threading

    from stardis_tpu_torch import pipeline as tpipe

    plan, _batch = _batch_on_card(tmp_path)
    dtype = torch.float32
    consts = tpipe.device_constants(plan, dtype, cuda)
    scales = (1.0, 1.01, 0.99, 1.02)

    def grads(scale, stage=tpipe.stage_plasma_and_lines):
        inputs = _scaled(plan.temperatures, plan.n_elem, dtype, cuda, scale)
        return torch.autograd.grad(_line_loss(*stage(plan, *inputs, consts)), inputs)

    want = {s: grads(s, tpipe._stage_plasma_and_lines) for s in scales}
    grads(1.0)  # the capture
    got, errors = {s: [] for s in scales}, []

    def work(scale):
        try:
            for _ in range(5):
                got[scale].append(grads(scale))
        except Exception as exc:  # raised again below, in the test's thread
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in scales]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    if errors:
        raise errors[0]
    for s in scales:
        assert len(got[s]) == 5
        assert all(torch.equal(a, b) for g in got[s] for a, b in zip(g, want[s])), s


def test_gradients_replay_the_grad_graph(cuda, tmp_path, monkeypatch, grad_graphs):
    """Temperatures that require grad: run_batch captures no forward-only
    graph; its stage 1 replays the differentiated graphs (one capture, one
    replay a call, the second call on the same constants), and F_nu and
    the gradient equal the eager stage's through the same spectrum bit for
    bit."""
    import dataclasses

    from stardis_tpu_torch import pipeline as tpipe
    from stardis_tpu_torch.parallel import batch as tbatch

    def refuse(*args, **kwargs):
        raise AssertionError("a differentiated run asked for a forward-only stage 1")

    monkeypatch.setattr(tbatch, "captured_stage1", refuse)
    plan, batch = _batch_on_card(tmp_path)
    before = _grad_counts()
    runs = []
    for _ in range(2):
        temps = torch.as_tensor(batch.temperatures, device=cuda).float().requires_grad_()
        f_nu = tbatch.run_batch(plan, dataclasses.replace(batch, temperatures=temps))
        f_nu[:, -1].sum().backward()
        runs.append((f_nu.detach(), temps.grad))
    assert _grad_counts() == [before[0] + 1, before[1] + 2, before[2]]

    consts = tpipe.device_constants(plan, torch.float32, cuda)
    temps = torch.as_tensor(batch.temperatures, device=cuda).float().requires_grad_()
    state, quants = tpipe._stage_plasma_and_lines(
        plan, temps, torch.as_tensor(batch.n_elem, device=cuda).float(), consts)
    lines = tpipe.prepare_lines(plan, state, quants, consts)
    f_nu = tpipe.spectrum_batch(plan, state, lines, consts, batch.ray_distances)[0]
    f_nu[:, -1].sum().backward()
    assert torch.isfinite(temps.grad).all() and (temps.grad.abs().amax(dim=1) > 0).all()
    for got, grad in runs:
        assert torch.equal(got, f_nu.detach()) and torch.equal(grad, temps.grad)


def test_grad_graph_pools_enter_the_memory_model(cuda, tmp_path, grad_graphs):
    """A differentiated capture's pool is positive, registered while its
    entry lives, and leaves the registry with the entry when
    STAGE1_GRAD_CACHE_LIMIT later captures evict it."""
    import weakref

    from stardis_tpu_torch import pipeline as tpipe
    from stardis_tpu_torch.util import memory as mem

    plan, batch = _batch_on_card(tmp_path)
    consts = tpipe.device_constants(plan, torch.float32, cuda)

    def forward(n_models):
        members = [i % len(batch.temperatures) for i in range(n_models)]
        inputs = _scaled(batch.temperatures[members], batch.n_elem[members], torch.float32,
                         cuda, 1.0)
        tpipe.stage_plasma_and_lines(plan, *inputs, consts)

    forward(1)
    (entry,) = grad_graphs.values()
    assert entry.pool_bytes > 0 and 0 <= entry.pool_free_bytes <= entry.pool_bytes
    assert entry in mem.resident_pools(entry.device)
    first = weakref.ref(entry)
    del entry
    for n_models in range(2, 2 + tpipe.STAGE1_GRAD_CACHE_LIMIT):
        forward(n_models)
    assert first() is None
    assert len(grad_graphs) == tpipe.STAGE1_GRAD_CACHE_LIMIT
    assert sorted(map(id, (p for p in mem.resident_pools(torch.device(cuda.type, 0))
                           if isinstance(p, tpipe.CapturedStage1Grad)))) == sorted(
        map(id, grad_graphs.values()))


def test_captured_pools_enter_the_memory_model(cuda, tmp_path, monkeypatch):
    """A captured graph registers its pool while it lives: device_bytes_limit
    falls by at least the pool's free bytes at the capture; a service's
    "auto" segments count its own pool as fixed overhead against the
    budget; a batch graph evicted from run_batch's cache leaves the
    registry."""
    import weakref

    from stardis_tpu_torch import pipeline as tpipe
    from stardis_tpu_torch import units as u
    from stardis_tpu_torch.atom_data import build_builtin_atom_data
    from stardis_tpu_torch.io.synthetic import write_marcs_file
    from stardis_tpu_torch.parallel import batch as tbatch
    from stardis_tpu_torch.serving import SpectralService
    from stardis_tpu_torch.util import memory as mem

    plan, batch = _batch_on_card(tmp_path)
    consts = tpipe.device_constants(plan, torch.float32, cuda)
    torch.cuda.synchronize()
    before = mem.device_bytes_limit(cuda)
    graph = tpipe.CapturedStage1(plan, consts, 3)
    after = mem.device_bytes_limit(cuda)
    assert mem.resident_pools(graph.device) == [graph]
    assert 0 <= graph.pool_free_bytes <= graph.pool_bytes
    assert before - after >= graph.pool_free_bytes
    dropped = weakref.ref(graph)
    del graph
    assert dropped() is None and mem.resident_pools(torch.device(cuda.type, 0)) == []

    model = str(tmp_path / "sun.mod")
    write_marcs_file(model)
    cfg = {"stardis_config_version": 1.0, "atom_data": "builtin:30",
           "input_model": {"type": "marcs", "fname": model, "final_atomic_number": 30},
           "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}},
                       "line": {"disable": False, "broadening": ["radiation"]}},
           "no_of_thetas": 10}
    lam = u.Quantity(np.linspace(4000.0, 7000.0, 200_000), u.AA)
    svc = SpectralService(cfg, lam, nu_segments="auto",
                          atom_data=build_builtin_atom_data(30, include_linelists=True))
    budget = 200 * 10**6
    monkeypatch.setenv("STARDIS_SEGMENT_BUDGET", str(budget))
    from stardis_tpu_torch.base import read_stellar_model

    out = svc.synthesize(read_stellar_model(svc.config, svc.atom_data))
    pool = svc._stage1.pool_bytes
    assert mem.resident_pools(svc._stage1.device) == [svc._stage1]
    assert svc._nu_segments == mem.choose_nu_segments(svc._plan, budget, pool_bytes=pool) > 1
    assert np.isfinite(out["F_nu"]).all()

    tbatch._STAGE1_CACHE.clear()
    first = weakref.ref(tbatch.captured_stage1(plan, 1, torch.float32, cuda))
    for n_models in range(2, 2 + tbatch.STAGE1_CACHE_LIMIT):
        tbatch.captured_stage1(plan, n_models, torch.float32, cuda)
    assert first() is None
    cached = list(tbatch._STAGE1_CACHE.values())
    assert sorted(map(id, mem.resident_pools(svc._stage1.device))) == sorted(
        map(id, cached + [svc._stage1]))
    tbatch._STAGE1_CACHE.clear()
