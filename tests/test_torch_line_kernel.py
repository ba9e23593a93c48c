"""Line-opacity accumulation: the port's plain torch version (the CPU side of
Kernel 1) against the JAX package's tiered/split/panelized programs.

Tolerances: 1e-10 against ``accumulate_line_opacity_blocked`` (same Voigt,
same window mask, different summation order); 5e-4 against the NumPy
oracle ``accumulate_line_opacity_reference``, which evaluates the exact
Faddeeva function (scipy wofz) where both packages use Humlicek w4 — the
bound the JAX package's own tests hold its kernels to."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stardis_tpu.opacities import line_kernel as jlk  # noqa: E402
from stardis_tpu_torch.opacities import line_kernel as tlk  # noqa: E402

RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_setup(n_lines=37, n_depth=13, n_nu=400, seed=0, strong=False):
    rng = np.random.default_rng(seed)
    nus = np.linspace(4.6e14, 4.5e14, n_nu)  # descending, like the pipeline
    line_nu = np.sort(rng.uniform(nus.min(), nus.max(), n_lines))
    doppler = rng.uniform(1e9, 5e9, (n_lines, n_depth))
    gamma = rng.uniform(1e8, 2e9, (n_lines, n_depth))
    scale = 1e-2 if strong else 1e-12
    alpha = rng.uniform(0.1, 1.0, (n_lines, n_depth)) * scale
    return nus, line_nu, alpha, gamma, doppler


def _port(nus, line_nu, alpha, gamma, doppler, budget=None):
    """The port's call as the pipeline makes it (nu_ref-centred grid)."""
    nu_ref = float(nus[len(nus) // 2])
    d_nu = tlk.grid_min_step(nus)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))  # noqa: E731
    centers = torch.from_numpy(tlk.line_center_indices(nus, line_nu))
    a, g, d = t(alpha), t(gamma), t(doppler)
    iw = tlk.window_half_widths(a, g, d, d_nu, len(nus))
    return tlk.accumulate_line_opacity_plain(
        t(nus - nu_ref), t(line_nu - nu_ref), centers, a, g, d, iw, budget=budget
    ).numpy()


def _jax_blocked(nus, line_nu, alpha, gamma, doppler, block, split=False,
                 core_half=None):
    nu_ref = float(nus[len(nus) // 2])
    d_nu = jlk.grid_min_step(nus)
    centers = jlk.line_center_indices(nus, line_nu)
    win = np.asarray(
        jlk.window_pixels(jnp.asarray(alpha), jnp.asarray(gamma), jnp.asarray(doppler), d_nu)
    )
    blocked = jlk.assign_window_tiers_blocked(win, len(nus), block=block)
    if split:
        blocked.core_half = core_half or int(np.ceil(15.5 * doppler.max() / d_nu)) + 2
    out = jlk.accumulate_line_opacity_blocked(
        jnp.asarray(nus - nu_ref), jnp.asarray(line_nu - nu_ref), jnp.asarray(centers),
        jnp.asarray(alpha), jnp.asarray(gamma), jnp.asarray(doppler),
        blocked=blocked, d_nu=d_nu, chunk=16,
        center_idx_host=centers if split else None,
    )
    return np.asarray(out)


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("block", [3, 8])
def test_plain_matches_jax_blocked_tiers(strong, block):
    args = _random_setup(strong=strong)
    np.testing.assert_allclose(
        _port(*args), _jax_blocked(*args, block=block), rtol=RTOL, atol=1e-300
    )


@pytest.mark.parametrize("strong", [False, True])
def test_plain_matches_jax_split_dense(strong):
    args = _random_setup(n_lines=30, n_depth=12, n_nu=1500, strong=strong)
    np.testing.assert_allclose(
        _port(*args), _jax_blocked(*args, block=4, split=True), rtol=RTOL, atol=1e-300
    )


@pytest.mark.parametrize("strong", [False, True])
def test_plain_matches_numpy_oracle(strong):
    nus, line_nu, alpha, gamma, doppler = _random_setup(n_depth=5, strong=strong)
    oracle = jlk.accumulate_line_opacity_reference(nus, line_nu, alpha, gamma, doppler)
    np.testing.assert_allclose(
        _port(nus, line_nu, alpha, gamma, doppler), oracle, rtol=5e-4, atol=1e-30
    )


def test_plain_matches_jax_on_chirped_grid():
    """Wavelength-uniform 3800-9000 AA grid, doppler ~3 fine pixels, lines at
    the coarse end with windows covering the grid: the case that pins the
    region-I core/wing boundary of the JAX split path."""
    lam = np.linspace(3800.0, 9000.0, 4096)
    nus = np.sort(2.99792458e18 / lam)[::-1].copy()
    d_nu = jlk.grid_min_step(nus)
    n_depth = 8
    rng = np.random.default_rng(7)
    line_nu = np.sort(nus[40:50] - 0.3 * d_nu)
    n_lines = len(line_nu)
    doppler = np.full((n_lines, n_depth), 3.0 * d_nu)
    gamma = np.full((n_lines, n_depth), 0.5 * d_nu)
    alpha = 10.0 ** rng.uniform(10, 12, size=(n_lines, n_depth))
    core_half = jlk.split_core_half(
        float(doppler.max()), d_nu, center_gap_px=jlk.grid_center_gap_px(nus)
    )
    args = (nus, line_nu, alpha, gamma, doppler)
    ref = _jax_blocked(*args, block=8, split=True, core_half=core_half)
    np.testing.assert_allclose(_port(*args), ref, rtol=RTOL, atol=1e-300)


def test_plain_chunking_invariant():
    args = _random_setup(n_lines=60, strong=True, seed=4)
    np.testing.assert_allclose(
        _port(*args, budget=1 << 12), _port(*args), rtol=1e-12, atol=1e-300
    )


def test_host_helpers_match_jax():
    nus, line_nu, alpha, gamma, doppler = _random_setup(strong=True, seed=5)
    assert tlk.grid_min_step(nus) == jlk.grid_min_step(nus)
    assert tlk.grid_min_step(nus[:1]) == jlk.grid_min_step(nus[:1])
    np.testing.assert_array_equal(
        tlk.line_center_indices(nus, line_nu), jlk.line_center_indices(nus, line_nu)
    )
    d_nu = jlk.grid_min_step(nus)
    win_j = np.asarray(
        jlk.window_pixels(jnp.asarray(alpha), jnp.asarray(gamma), jnp.asarray(doppler), d_nu)
    )
    t = [torch.from_numpy(a) for a in (alpha, gamma, doppler)]
    np.testing.assert_array_equal(tlk.window_pixels(*t, d_nu).numpy(), win_j)
    iw = tlk.window_half_widths(*t, d_nu, len(nus)).numpy()
    assert iw.dtype == np.int32
    np.testing.assert_array_equal(iw, np.minimum(np.floor(win_j), len(nus) + 1))


def test_dispatch_on_cpu_is_plain_and_empty_set():
    nus, line_nu, alpha, gamma, doppler = _random_setup(seed=6)
    nu_ref = float(nus[len(nus) // 2])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    centers = t(tlk.line_center_indices(nus, line_nu))
    d_nu = tlk.grid_min_step(nus)
    iw = tlk.window_half_widths(t(alpha), t(gamma), t(doppler), d_nu, len(nus))
    out = tlk.accumulate_line_windows(
        t(nus - nu_ref), t(line_nu - nu_ref), centers, t(alpha), t(gamma), t(doppler), iw,
    )
    np.testing.assert_array_equal(out.numpy(), _port(nus, line_nu, alpha, gamma, doppler))
    empty = tlk.accumulate_line_windows(
        t(nus), t(line_nu[:0]), centers[:0], t(alpha[:0]), t(gamma[:0]),
        t(doppler[:0]), iw[:0],
    )
    assert empty.shape == (alpha.shape[1], len(nus)) and not empty.any()


def test_plain_matches_jax_per_line_tiers():
    """The unblocked per-line-tier schedule (window_block = 0) computes the
    same sum."""
    nus, line_nu, alpha, gamma, doppler = _random_setup(n_lines=50, n_depth=12, seed=8)
    nu_ref = float(nus[len(nus) // 2])
    d_nu = jlk.grid_min_step(nus)
    win = np.asarray(jlk.window_pixels(*map(jnp.asarray, (alpha, gamma, doppler)), d_nu))
    tiers = jlk.assign_window_tiers(win.max(axis=1), len(nus))
    ref = jlk.accumulate_line_opacity_tiered(
        jnp.asarray(nus - nu_ref), jnp.asarray(line_nu - nu_ref),
        jnp.asarray(jlk.line_center_indices(nus, line_nu)),
        jnp.asarray(alpha), jnp.asarray(gamma), jnp.asarray(doppler),
        tiers=tiers, d_nu=d_nu, chunk=16,
    )
    np.testing.assert_allclose(
        _port(nus, line_nu, alpha, gamma, doppler), np.asarray(ref), rtol=RTOL, atol=1e-300
    )
