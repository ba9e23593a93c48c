"""Kernel 2's tiled arithmetic (csrc/formal_solution.cu) mirrored in torch on
the CPU.

A block of the kernel owns F frequencies of one model and all T angles.
It stages what does not depend on the angle once: the gaps' mean
extinction m[g][f] = exp(0.5 (ln a_{g+1} + ln a_g)) and the source; each
(frequency, angle) thread forms tau = m[g][f] ray[g][t], runs the inward
sweep (spherical) and the outward sweep in the plain version's order,
carrying the third term's quotient (s_k - s_{k+1}) / safe(tau_k) over from
the previous step as the exact negation of (s_{k+1} - s_k) / safe(tau_k),
and writes its intensity into a double-buffered chunk of depths; after each
chunk one thread per (depth, frequency) sums w_t I_t in theta order from 0
and writes F_nu times the model's correction.  Threads past the grid's edge
run the last column and write nothing.

``_tile_mirror`` repeats those steps with torch ops, tile by tile and chunk
by chunk.  Its transcendentals (the logs and exps of m, the weights' exp)
come from the plain version's own whole-array calls: torch's CPU exp and
log take a vector path through the body of an array and a scalar one
through its tail, which may round a value differently by its position, and
the tile does not change those functions (on the card every thread calls
the same ones).  Everything the tile does change is basic arithmetic, which
rounds alike in any layout, so the mirror must equal ``raytrace_plain``
bit for bit (``torch.equal``), F_nu and I_nu, in float64 and float32; and
JAX's ``raytrace`` at 1e-9 in float64 (tests/test_torch_solver.py's bound
is 1e-10 on a gentler atmosphere).  Inputs: plane-parallel and spherical
(zero chords, rays through the gap-0 wrap, columns scaled so that per-gap
tau spans the Taylor, middle and saturated regimes, an isothermal layer
whose consecutive sources are equal), T in {1, 3, 20}, N not a multiple of
F, two models.  Also: the wrapper's launch shape (``trace_tile``) and its
autograd plumbing (which launches write the intensity buffer), with the
launch swapped for the plain version."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stardis_tpu.radiation_field import solver as jsolver  # noqa: E402
from stardis_tpu_torch.radiation_field import solver as tsolver  # noqa: E402

N_NU = 37  # no multiple of any tile below


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _safe(x):
    return torch.where(x == 0, torch.ones_like(x), x)


def _tile_mirror(alphas, source, ray, weights, corr, inward, tile, chunk=tsolver.TRACE_CHUNK):
    """F_nu [B, D, N] and I_nu [B, D, N, T] as Kernel 2's blocks compute
    them, tile by tile: alphas, source [B, D, N], ray [B, G, T],
    weights [T], corr [B]."""
    n_models, n_depth, n_nu = alphas.shape
    n_gaps, n_theta = n_depth - 1, len(weights)
    # the plain version's whole-array transcendentals (module docstring)
    log_a = torch.log(alphas[:, None])
    m = torch.exp(0.5 * (log_a[..., 1:, :] + log_a[..., :-1, :]))[:, 0]  # [B, G, N]
    taus = m[:, None] * ray.transpose(1, 2)[..., None]  # [B, T, G, N], plain's layout
    w_all = [w.permute(0, 2, 3, 1) for w in tsolver.calc_weights(taus)]  # [B, G, N, T]
    f_out = torch.full((n_models, n_depth, n_nu), torch.nan, dtype=alphas.dtype)
    i_out = torch.full((n_models, n_depth, n_nu, n_theta), torch.nan, dtype=alphas.dtype)
    for n0 in range(0, n_nu, tile):
        cols = torch.clamp(torch.arange(n0, n0 + tile), max=n_nu - 1)
        valid = torch.arange(n0, n0 + tile) < n_nu
        # staged once per block: m [B, G, F] and S [B, D, F]; a thread's
        # tau is m[g][f] ray[g][t], [B, G, F, T]
        tau = m[:, :, cols, None] * ray[:, :, None, :]
        w0, w1, w2 = (w[:, :, cols] for w in w_all)
        s = source[:, :, cols, None]  # [B, D, F, 1]

        intensity = torch.zeros_like(tau[:, 0])
        if inward:
            tau_top = tau[:, n_gaps - 1]
            tau_g = tau_top
            q_g = (s[:, n_gaps] - s[:, n_gaps - 1]) / _safe(tau_g)
            for g in range(n_gaps - 1, -1, -1):
                tau_gm1 = tau[:, g - 1] if g > 0 else tau_top
                s_g, s_gp1 = s[:, g], s[:, g + 1]
                s_gm1 = s[:, g - 1 if g > 0 else n_gaps]
                denom = _safe(tau_g + tau_gm1)
                second = w1[:, g] * ((s_g - s_gm1) * (tau_g / _safe(tau_gm1))
                                     - (s_g - s_gp1) * (tau_gm1 / _safe(tau_g))) / denom
                q_gm1 = (s_gm1 - s_g) / _safe(tau_gm1)
                third = w2[:, g] * (q_gm1 + q_g) / denom
                step = (1.0 - w0[:, g]) * intensity + w0[:, g] * s_g + second + third
                intensity = torch.where((tau_g != 0) & (tau_gm1 != 0), step, intensity)
                tau_g, q_g = tau_gm1, -q_gm1

        tau_k, s_k, s_kp1 = tau[:, 0], s[:, 0], s[:, 1]
        q_k = (s_k - s_kp1) / _safe(tau_k)
        parts = [torch.empty((chunk, *intensity.shape), dtype=alphas.dtype) for _ in range(2)]
        for c, d0 in enumerate(range(0, n_depth, chunk)):
            part = parts[c % 2]
            d1 = min(d0 + chunk, n_depth)
            for d in range(d0, d1):
                k = d - 1
                if 0 < d < n_gaps:
                    tau_kp1, s_kp2 = tau[:, d], s[:, d + 1]
                    denom = _safe(tau_k + tau_kp1)
                    second = w1[:, k] * ((s_kp1 - s_kp2) * (tau_k / _safe(tau_kp1))
                                         - (s_kp1 - s_k) * (tau_kp1 / _safe(tau_k))) / denom
                    q_kp1 = (s_kp2 - s_kp1) / _safe(tau_kp1)
                    third = w2[:, k] * (q_kp1 + q_k) / denom
                    step = (1.0 - w0[:, k]) * intensity + w0[:, k] * s_kp1 + second + third
                    intensity = torch.where(tau_k != 0, step, intensity)
                    tau_k, s_k, s_kp1, q_k = tau_kp1, s_kp1, s_kp2, -q_kp1
                elif d > 0:  # last gap: constant-source boundary jump
                    st = _safe(tau_k)
                    third = w2[:, k] * (s_k - s_kp1) / (st * st)
                    step = (1.0 - w0[:, k]) * intensity + w0[:, k] * s_kp1 + third
                    intensity = torch.where(tau_k != 0, step, intensity)
                part[d - d0] = intensity
                i_out[:, d, n0:n0 + int(valid.sum())] = intensity[:, valid]
            # after the chunk's barrier: the theta sums in theta order
            for dd in range(d1 - d0):
                total = torch.zeros_like(part[dd][..., 0])
                for t in range(n_theta):
                    total = total + weights[t] * part[dd][..., t]
                f_out[:, d0 + dd, n0:n0 + int(valid.sum())] = (total * corr[:, None])[:, valid]
    return f_out, i_out


def _plane(n_models=2, n_depth=56, n_nu=N_NU, n_theta=20, seed=0):
    """Solar-like columns (opacity and source rising inward, line-like
    spikes); each model's columns scaled by 10^0 .. 10^-9 across the grid,
    so that per-gap tau runs from the Taylor regime to saturation; two
    consecutive depths of equal source (an isothermal layer)."""
    rng = np.random.default_rng(seed)
    depth = np.linspace(1.0, 0.0, n_depth)[None, :, None]
    alphas = (10.0 ** (-6.0 + 9.0 * depth) * (1.0 + 50.0 * rng.random((n_models, 1, n_nu)) ** 8)
              * (1.0 + 0.1 * rng.random((n_models, n_depth, n_nu))))
    alphas = alphas * np.logspace(0.0, -9.0, n_nu)[None, None, :]
    source = 1e-5 * (1.0 + 3.0 * depth) ** 4 * (1.0 + 0.05 * rng.random((n_models, 1, n_nu)))
    source[:, n_depth // 2] = source[:, n_depth // 2 - 1]
    thetas, weights = tsolver.gauss_legendre_thetas(n_theta)
    ray = np.broadcast_to(np.full((n_depth - 1, 1), 2e6) / np.cos(thetas)[None, :],
                          (n_models, n_depth - 1, n_theta)).copy()
    return alphas, source, ray, weights, np.array([1.0, 1.3])[:n_models]


def _spherical(n_models=2, n_depth=56, n_nu=N_NU, n_theta=20, seed=1):
    """Shells 1e12 cm plus an atmosphere of 5e10 cm, so that the outer
    chords miss inner shells (ray distance 0) and the inner ones reach the
    centre, where the inward sweep's gap 0 wraps to tau[G-1] and
    source[G]; the columns scaled as ``_plane``'s; a source that differs at
    every depth but one isothermal pair."""
    alphas, source, _, weights, _ = _plane(n_models, n_depth, n_nu, n_theta, seed)
    alphas = alphas * 2e-3  # chords ~500x the plane-parallel ones
    thetas, _ = tsolver.gauss_legendre_thetas(n_theta)
    rays, corrs = [], []
    for b in range(n_models):
        radii = 1e12 + np.linspace(0.0, 5e10 * (1.0 + 0.1 * b), n_depth)
        rays.append(tsolver.calculate_spherical_ray(thetas, radii))
        corrs.append((radii[-1] / (radii[-1] - 1e10)) ** 2)
    return alphas, source, np.stack(rays), weights, np.asarray(corrs)


def _inputs(geometry, n_theta, dtype, n_depth=56):
    make = _plane if geometry == "plane" else _spherical
    alphas, source, ray, weights, corr = make(n_depth=n_depth, n_theta=n_theta)
    t = lambda a: torch.as_tensor(a).to(dtype)  # noqa: E731
    return t(alphas), t(source), t(ray), t(weights), t(corr), geometry == "spherical"


def _regimes(alphas, ray):
    """Shares of the nonzero per-gap taus in the Taylor, middle and
    saturated regimes; gaps whose chord is zero; rays through the wrap."""
    taus = tsolver.compute_taus(alphas[:, None], ray.transpose(1, 2))  # [B, T, G, N]
    nz = taus > 0
    n = nz.sum().item()
    return ((((taus < tsolver.TAU_TAYLOR) & nz).sum().item() / n,
             ((taus >= tsolver.TAU_TAYLOR) & (taus < tsolver.TAU_SATURATED)).sum().item() / n,
             (taus >= tsolver.TAU_SATURATED).sum().item() / n),
            int((~nz).sum()), int((nz[:, :, 0] & nz[:, :, -1]).sum()))


@pytest.mark.parametrize("geometry", ["plane", "spherical"])
def test_inputs_visit_every_branch(geometry):
    alphas, source, ray, *_ = _inputs(geometry, 20, torch.float64)
    shares, zero_gaps, wrapped = _regimes(alphas, ray)
    assert min(shares) >= 0.05, shares
    assert bool((source[:, 28] == source[:, 27]).all())
    if geometry == "spherical":
        assert zero_gaps > 0 and wrapped > 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_theta", [1, 3, 20])
@pytest.mark.parametrize("geometry", ["plane", "spherical"])
def test_tile_mirror_equals_plain(geometry, n_theta, dtype):
    """The kernel's launch shape (trace_tile), two models, N = 37: equal bit
    for bit to raytrace_plain, F_nu and I_nu."""
    alphas, source, ray, weights, corr, inward = _inputs(geometry, n_theta, dtype)
    tile, _ = tsolver.trace_tile(alphas.shape[1], n_theta, alphas.element_size())
    assert N_NU % tile != 0
    f, i = _tile_mirror(alphas, source, ray, weights, corr, inward, tile)
    fp, ip = tsolver.raytrace_plain(alphas, source, ray, weights, inward, corr,
                                    track_individual_intensities=True)
    assert torch.equal(f, fp) and torch.equal(i, ip)


@pytest.mark.parametrize("tile, chunk, n_depth", [(5, 8, 13), (1, 3, 56), (37, 1, 4), (6, 8, 2)])
@pytest.mark.parametrize("geometry", ["plane", "spherical"])
def test_tile_mirror_any_tile_and_chunk(geometry, tile, chunk, n_depth):
    """Other tiles and chunks (a partial last tile and chunk, one depth per
    chunk, a single gap): the bits do not depend on them."""
    alphas, source, ray, weights, corr, inward = _inputs(geometry, 3, torch.float64,
                                                         n_depth=n_depth)
    f, i = _tile_mirror(alphas, source, ray, weights, corr, inward, tile, chunk)
    fp, ip = tsolver.raytrace_plain(alphas, source, ray, weights, inward, corr,
                                    track_individual_intensities=True)
    assert torch.equal(f, fp) and torch.equal(i, ip)


@pytest.mark.parametrize("n_theta", [1, 3, 20])
@pytest.mark.parametrize("geometry", ["plane", "spherical"])
def test_tile_mirror_matches_jax(geometry, n_theta):
    """Against JAX's raytrace (an associative scan over depth), model by
    model, at 1e-9 (float64)."""
    alphas, source, ray, weights, corr, inward = _inputs(geometry, n_theta, torch.float64)
    tile, _ = tsolver.trace_tile(alphas.shape[1], n_theta, 8)
    f, i = _tile_mirror(alphas, source, ray, weights, corr, inward, tile)
    for b in range(alphas.shape[0]):
        f_ref, i_ref = jsolver.raytrace(
            jnp.asarray(alphas[b].numpy()), jnp.asarray(source[b].numpy()),
            jnp.asarray(ray[b].numpy()), jnp.asarray(weights.numpy()), inward_rays=inward,
            photospheric_correction=float(corr[b]), track_individual_intensities=True)
        np.testing.assert_allclose(f[b].numpy(), np.asarray(f_ref), rtol=1e-9, atol=1e-300)
        np.testing.assert_allclose(i[b].numpy(), np.asarray(i_ref), rtol=1e-9, atol=1e-300)


@pytest.mark.parametrize("n_theta", [1, 3, 20, 100])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_trace_tile_shape(n_theta, itemsize):
    """TRACE_THREADS // T frequencies (1 to TRACE_MAX_TILE) of T angles, the
    shared bytes of the kernel's layout, within the block's limits."""
    tile, shared = tsolver.trace_tile(56, n_theta, itemsize)
    assert tile == max(1, min(tsolver.TRACE_MAX_TILE, tsolver.TRACE_THREADS // n_theta))
    assert tile * n_theta <= tsolver.TRACE_MAX_THREADS
    assert shared == itemsize * (55 * tile + 56 * tile + 55 * n_theta + n_theta
                                 + 2 * tsolver.TRACE_CHUNK * tile * n_theta)
    assert shared <= tsolver.TRACE_MAX_SHARED
    if n_theta == 20:
        assert tile == 8


@pytest.mark.parametrize("n_depth, n_theta", [(56, tsolver.TRACE_MAX_THREADS + 1),
                                              (3000, 20)])
def test_trace_tile_rejects_what_a_block_cannot_hold(n_depth, n_theta):
    """More angles than a block's threads, or chords and stages beyond its
    shared memory (float64), raise before any launch."""
    with pytest.raises(ValueError, match="formal_solution kernel"):
        tsolver.trace_tile(n_depth, n_theta, 8)


@pytest.mark.parametrize("inward", [False, True], ids=["plane", "spherical"])
def test_intensity_buffer_only_where_it_is_read(monkeypatch, inward):
    """raytrace_cuda's autograd plumbing, with the launches replaced by the
    plain versions: the buffer is written (``store``) when I_nu is tracked
    and not otherwise, under autograd too (Kernel 2b recomputes the sweep
    and is handed no buffer); untracked, the Function's second output is
    empty and non-differentiable and raytrace_cuda returns None; the
    gradients equal autograd of raytrace_plain, through F_nu and through a
    tracked I_nu."""
    geometry = "spherical" if inward else "plane"
    alphas, source, ray, weights, corr, _ = _inputs(geometry, 3, torch.float64)
    stores = []

    def fake_launch(a, s, r, w, c, inward_rays, store):
        stores.append(store)
        f, i = tsolver.raytrace_plain(a, s, r, w, inward_rays, c, True)
        return f, (i if store else None)

    def fake_grad(a, s, r, w, c, g_f, g_i, inward_rays):
        assert g_i is None or g_i.shape == (*a.shape, len(w))
        return tsolver.raytrace_plain_backward(a, s, r, w, g_f, g_i, inward_rays, c)

    monkeypatch.setattr(tsolver, "_launch_trace", fake_launch)
    monkeypatch.setattr(tsolver, "raytrace_grad_cuda", fake_grad)
    kw = {"inward_rays": inward, "photospheric_correction": corr}
    f_ref, i_ref = tsolver.raytrace_plain(alphas, source, ray, weights,
                                          track_individual_intensities=True, **kw)

    f, i = tsolver.raytrace_cuda(alphas, source, ray, weights, **kw)
    assert i is None and stores[-1] is False and torch.equal(f, f_ref)
    a = alphas.clone().requires_grad_()
    with torch.no_grad():
        f, i = tsolver.raytrace_cuda(a, source, ray, weights, **kw)
    assert i is None and stores[-1] is False and not f.requires_grad
    f, i = tsolver.raytrace_cuda(alphas, source, ray, weights, track_individual_intensities=True,
                                 **kw)
    assert stores[-1] is True and torch.equal(i, i_ref)

    gen = torch.Generator().manual_seed(4)
    g_f = torch.randn(f_ref.shape, dtype=f_ref.dtype, generator=gen)
    g_i = torch.randn(i_ref.shape, dtype=i_ref.dtype, generator=gen)
    for track in (False, True):
        a, s = alphas.clone().requires_grad_(), source.clone().requires_grad_()
        f, i = tsolver.raytrace_cuda(a, s, ray, weights, track_individual_intensities=track, **kw)
        assert stores[-1] is track and (i is not None) == track
        outs, grads = ([f, i], [g_f, g_i]) if track else ([f], [g_f])
        ours = torch.autograd.grad(outs, (a, s), grads)
        ref = tsolver.raytrace_plain_backward(alphas, source, ray, weights, g_f,
                                              g_i if track else None, **kw)
        assert all(torch.equal(x, y) for x, y in zip(ours, ref))
    s = source.clone().requires_grad_()
    f, _ = tsolver.raytrace_cuda(alphas, s, ray, weights, **kw)
    assert stores[-1] is False and f.requires_grad
