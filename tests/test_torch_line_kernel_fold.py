"""Kernel 1's arithmetic (csrc/line_opacity.cu) mirrored in torch on the CPU.

The kernel folds each (line, depth) pair's constants once (1/D,
y = gamma / (sqrt(pi) pi D), c0 = y^2 + 1/2, 4 y^2, alpha / (pi D) and
y alpha / (pi D), the window as absolute pixels), evaluates region I
(|x| + y > 15) with one reciprocal, sqrt(pi) Re w = y (x^2 + c0) /
((x^2 - c0)^2 + 4 y^2 x^2) (= Re(i z conj(a)) / |a|^2, a = z^2 - 1/2), and
adds each pixel's in-window lines in a fixed order: the lines l = w (mod
SPLIT) in ascending order, then the SPLIT sums in order of w.  ``_kernel_mirror`` repeats
those steps with torch ops; these tests hold it to the plain version
(``accumulate_line_opacity_plain``) at 1e-13 in float64, whole grid and a
range, for reference, accuracy and 1-3-pixel windows; to the JAX package's
``accumulate_line_opacity_blocked`` at 1e-10 (the bound of
tests/test_torch_line_kernel.py); and in float32 on the far wing (|x| to
~3e6) to the float64 sum at 1e-5 of each row's maximum.  They also hold the
kernel's per-warp shortcut, which takes a span through its loop without
tests only where the span lies in the line's window and outside its core
guard, to the per-pixel test it makes elsewhere: no pixel outside the guard
is in regions II-IV, in either precision."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stardis_tpu.opacities import line_kernel as jlk  # noqa: E402
from stardis_tpu_torch.opacities import line_kernel as tlk  # noqa: E402
from stardis_tpu_torch.opacities.voigt import PI, SQRT_PI, faddeeva_real  # noqa: E402

N_NU = 3000
SPLIT = 4  # csrc/line_opacity.cu's SPLIT: the warps that share a block's lines


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy_lines(n_lines=300, n_depth=5, n_nu=N_NU, seed=0):
    """Lines sorted by frequency over a descending grid; alpha over five
    decades, so reference windows run from the 10-pixel minimum to beyond
    the grid."""
    rng = np.random.default_rng(seed)
    nus = np.linspace(4.6e14, 4.5e14, n_nu)
    line_nu = np.sort(rng.uniform(4.49e14, 4.61e14, n_lines))
    doppler = rng.uniform(1e9, 5e9, (n_lines, n_depth))
    gamma = rng.uniform(1e8, 2e9, (n_lines, n_depth))
    alpha = rng.uniform(0.1, 1.0, (n_lines, n_depth)) * 10 ** rng.uniform(-2, 3, (n_lines, 1))
    return nus, line_nu, alpha, gamma, doppler


def _inputs(windows, dtype=torch.float64, seed=0):
    """(grid, line_nu, centres, alpha, gamma, doppler, iw) in the plain
    layout, grid and lines as offsets from the grid's middle frequency;
    ``windows``: "reference", "accuracy" (epsilon 1e-21 of each depth's
    largest alpha: windows from ~80 pixels to beyond the grid), "short"
    (half-windows of 1-3 pixels on half the pairs, beyond the grid on the
    others) or "far wing" (Doppler widths / 1000, every window beyond the
    grid: |x| to ~3e6)."""
    nus, line_nu, alpha, gamma, doppler = _numpy_lines(seed=seed)
    if windows == "far wing":
        doppler = doppler * 1e-3
    nu_ref = float(nus[len(nus) // 2])
    t = lambda a: torch.as_tensor(a, dtype=torch.float64).to(dtype)  # noqa: E731
    a, g, d = t(alpha), t(gamma), t(doppler)
    centers = torch.as_tensor(tlk.line_center_indices(nus, line_nu))
    d_nu = tlk.grid_min_step(nus)
    if windows == "accuracy":
        iw = tlk.window_half_widths(a, g, d, d_nu, len(nus), "accuracy", 1e-21 * a.amax(dim=0))
    elif windows == "reference":
        iw = tlk.window_half_widths(a, g, d, d_nu, len(nus))
    else:
        rng = np.random.default_rng(seed + 1)
        wide = np.full(alpha.shape, len(nus) + 1)
        iw = wide if windows == "far wing" else np.where(
            rng.random(alpha.shape) < 0.5, rng.integers(1, 4, alpha.shape), wide)
        iw = torch.as_tensor(iw, dtype=torch.int32)
    return t(nus - nu_ref), t(line_nu - nu_ref), centers, a, g, d, iw


def _kernel_mirror(grid, line_nu, centers, alpha, gamma, doppler, iw, p_begin=0, n_out=None):
    """Kernel 1's sum for one model ([L, D] inputs) over pixels [p_begin,
    p_begin + n_out), step by step as the kernel takes it: per line, the
    folded constants, x = (grid - nu) (1/D), region I with one reciprocal,
    the w4 chain (times sqrt(pi)) where |x| + y <= 15, the in-window pixels
    added into the sum of the lines l = w (mod SPLIT) in ascending order;
    then the SPLIT sums added in order of w."""
    n_out = grid.shape[0] - p_begin if n_out is None else n_out
    pix = torch.arange(p_begin, p_begin + n_out)
    g = grid[p_begin:p_begin + n_out]
    parts = torch.zeros((SPLIT, alpha.shape[1], n_out), dtype=alpha.dtype)
    for l in range(alpha.shape[0]):
        c, half = int(centers[l]), iw[l].to(torch.int64)[:, None]
        dop = doppler[l][:, None]
        inv = 1.0 / dop
        y = gamma[l][:, None] / (SQRT_PI * PI) / dop
        c0, k4 = y * y + 0.5, 4.0 * y * y
        scale = alpha[l][:, None] / (PI * dop)
        s1 = y * scale
        x = (g[None, :] - line_nu[l]) * inv
        xx = x * x
        term = (xx * s1 + c0 * s1) * (1.0 / ((xx - c0) ** 2 + k4 * xx))
        yb = y.expand_as(x)
        core = torch.abs(x) + yb <= 15.0
        term[core] = (faddeeva_real(x[core], yb[core]) * SQRT_PI) * scale.expand_as(x)[core]
        inside = (pix >= c - half) & (pix < c + half)
        parts[l % SPLIT] += torch.where(inside, term, torch.zeros((), dtype=term.dtype))
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _rel_err(ours, ref):
    nz = ref != 0
    assert bool((ours[~nz] == 0).all())
    return float(((ours - ref).abs()[nz] / ref.abs()[nz]).max())


@pytest.mark.parametrize("p_begin, n_out", [(0, None), (1234, 777)])
@pytest.mark.parametrize("windows", ["reference", "accuracy", "short"])
def test_mirror_matches_plain(windows, p_begin, n_out):
    """float64: the kernel's folded arithmetic in its order equals the
    plain version at 1e-13 per element (both add positive terms, so each
    pixel's sum keeps its terms' relative error), and a range equals the
    whole grid's columns exactly."""
    args = _inputs(windows)
    plain = tlk.accumulate_line_opacity_plain(*args, p_begin=p_begin, n_out=n_out)
    ours = _kernel_mirror(*args, p_begin, n_out)
    assert ours.shape == plain.shape
    assert _rel_err(ours, plain) <= 1e-13
    if p_begin:
        full = _kernel_mirror(*args)
        assert torch.equal(ours, full[:, p_begin:p_begin + n_out])


def test_mirror_float32_far_wing_matches_float64():
    """float32 on the far wing (|x| to ~3e6, every line over every pixel):
    finite, and within 1e-5 of each row's maximum of the float64 sum."""
    args32 = _inputs("far wing", torch.float32)
    args64 = tuple(a.double() if a.is_floating_point() else a for a in args32)
    ref = tlk.accumulate_line_opacity_plain(*args64)
    ours = _kernel_mirror(*args32)
    assert bool(torch.isfinite(ours).all())
    x_max = float(((args64[0][0] - args64[1]).abs()[:, None] / args64[5]).max())
    assert x_max > 1e6
    err = (ours.double() - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)
    assert float(err.max()) <= 1e-5


def test_mirror_matches_jax_blocked():
    """The mirror against the JAX package's blocked line sum (reference
    windows), float64 at 1e-10 as tests/test_torch_line_kernel.py holds the
    plain version."""
    nus, line_nu, alpha, gamma, doppler = _numpy_lines(n_lines=60, n_depth=6, n_nu=800, seed=3)
    nu_ref = float(nus[len(nus) // 2])
    d_nu = jlk.grid_min_step(nus)
    centers = jlk.line_center_indices(nus, line_nu)
    win = np.asarray(jlk.window_pixels(*map(jnp.asarray, (alpha, gamma, doppler)), d_nu))
    ref = jlk.accumulate_line_opacity_blocked(
        jnp.asarray(nus - nu_ref), jnp.asarray(line_nu - nu_ref), jnp.asarray(centers),
        jnp.asarray(alpha), jnp.asarray(gamma), jnp.asarray(doppler),
        blocked=jlk.assign_window_tiers_blocked(win, len(nus), block=8), d_nu=d_nu, chunk=16)
    t = torch.from_numpy
    a, g, d = t(alpha), t(gamma), t(doppler)
    iw = tlk.window_half_widths(a, g, d, d_nu, len(nus))
    assert int(iw.max()) > len(nus) // 4  # some windows reach far across the grid
    ours = _kernel_mirror(t(nus - nu_ref), t(line_nu - nu_ref), t(centers), a, g, d, iw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-300)


def _core_guard(y, doppler, step_min):
    """Kernel 1's core_guard: the half-width k, in pixels, of [c - k, c + k)
    around a line's centre pixel c outside which every pixel is in region I
    (computed in the inputs' dtype, as the kernel computes it)."""
    reach = (15.0 - y) * doppler / step_min * 1.00001
    return torch.ceil(torch.clamp(reach, 0.0, float(1 << 30))).to(torch.int64) + 2


@pytest.mark.parametrize("windows", ["reference", "far wing"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_core_guard_holds_every_core_pixel(dtype, windows):
    """Kernel 1 takes a warp's span through its loop without tests when the
    line's window covers the span and the span lies outside the line's core
    guard.  Every pixel outside the guard must be in region I by the
    per-pixel test the kernel makes otherwise, |x| + y > 15 with x = (grid -
    nu) (1/D) rounded as the kernel rounds it; the guard is at most three
    pixels wider than the core on each side; and spans that start at an
    offset no tile divides, as a range launch's do, take the shortcut only
    where every pixel is in window and in region I."""
    grid, line_nu, centers, _, gamma, doppler, iw = _inputs(windows, dtype)
    step_min = (grid[:-1] - grid[1:]).amin()
    y = gamma / (SQRT_PI * PI) / doppler  # [L, D]
    k = _core_guard(y, doppler, step_min)
    x = (grid[None, None, :] - line_nu[:, None, None]) * (1.0 / doppler)[:, :, None]
    region1 = x.abs() + y[:, :, None] > 15.0  # [L, D, N]
    off = torch.arange(N_NU)[None, None, :] - centers[:, None, None]
    outside = (off < -k[:, :, None]) | (off >= k[:, :, None])
    assert bool(region1[outside].all())
    core = ~region1
    assert bool(core.any()) == (windows == "reference")
    core_reach = torch.where(core, torch.maximum(-off, off + 1), 0).amax(dim=2)
    inner = core.any(dim=2) & (centers[:, None] >= k) & (centers[:, None] + k <= N_NU)
    assert bool(inner.any()) == (windows == "reference")
    assert bool((k <= core_reach + 3)[inner].all())
    # the shortcut on spans of 128 pixels from pixel 37
    span = 128
    n_spans = (N_NU - 37) // span
    ws = 37 + span * torch.arange(n_spans)  # [S]
    we = ws + span
    half = iw.to(torch.int64)[:, :, None]
    c = centers[:, None, None]
    covered = (c - half <= ws) & (c + half >= we)  # [L, D, S]
    fast = covered & ((ws >= c + k[:, :, None]) | (we <= c - k[:, :, None]))
    spans = region1[:, :, 37:37 + n_spans * span].reshape(*region1.shape[:2], n_spans, span)
    assert bool(spans.all(dim=-1)[fast].all())
    assert float(fast[covered].double().mean()) > 0.9
