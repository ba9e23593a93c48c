"""Kernel 2b's tiled arithmetic (csrc/formal_solution_grad.cu) mirrored in
torch on the CPU.

A block of the kernel owns F frequencies of one model and all T angles,
as Kernel 2's does.  It stages the gaps' mean extinction m[g][f], the
source and dL/dF_nu once per block; each (frequency, angle) thread forms
tau = m[g][f] ray[g][t] and recomputes the forward in Kernel 2's order
(spherical: the inward sweep first), keeping the intensity entering each
outward step; then runs the reverse outward sweep (the last gap's jump
first, then each step's adjoint from the surface down) and, spherical, a
second inward sweep that keeps the intensity entering each inward step
and the reverse inward sweep with the reference's gap-0 wrap.  The theta
sums alpha_bar = sum_t (q_d + q_{d-1}) / alpha_d and S_bar = sum_t S_bar_t
run in theta order from 0: outward per chunk of depths as each depth
becomes final (from the surface down), inward after the whole reverse.

``_grad_mirror`` repeats those steps with torch ops, tile by tile and
chunk by chunk, on the inputs of tests/test_torch_trace_tile.py (every
weight regime, zero chords, the gap-0 wrap, T in {1, 3, 20}, N not a
multiple of F, two models).  Its transcendentals (m's logs and exps, the
weights' exp) come from whole-array calls, as ``_tile_mirror``'s do, so
its bits do not depend on the tile.  Bars: autograd of ``raytrace_plain``
(``raytrace_plain_backward``) at 1e-9 of each frequency column's largest
gradient in float64, dF and dF + dI; JAX's ``jax.vjp`` of ``raytrace`` at
tests/test_torch_grad.py's ``TRACE_BOUND`` for these tau-spanning columns;
the same bits at every tile and chunk; float32 within 1.5x the plain
version's 2-norm error against float64, the card's bar.  Also the launch
shape ``solver.trace_grad_tile``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stardis_tpu.radiation_field import solver as jsolver  # noqa: E402
from stardis_tpu_torch.radiation_field import solver as tsolver  # noqa: E402
from test_torch_grad import TRACE_BOUND  # noqa: E402
from test_torch_trace_tile import N_NU, _inputs, _safe  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes run the suite at once; one torch thread
    each keeps them from oversubscribing the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights_adjoint(tau, e, g0, g1, g2):
    """dL/dtau through the weights (the kernel's weights_adjoint)."""
    small = g0 * (1.0 - tau) + g1 * (tau * (1.0 - tau)) + g2 * (tau * tau * (1.0 - tau))
    mid = e * (g0 + tau * (g1 + tau * g2))
    return torch.where(tau < tsolver.TAU_TAYLOR, small,
                       torch.where(tau >= tsolver.TAU_SATURATED, torch.zeros_like(tau), mid))


def _step_adjoint(a, b, s0, s1, s2, intensity, lam, w, e):
    """The kernel's step_adjoint: (dL/dI, and the increments of dL/d{a, b,
    s0, s1, s2}) for L = lam, with the weights w = (w0, w1, w2) and e =
    exp(-a) of a; one reciprocal each of safe(a), safe(b), safe(a + b)."""
    w0, w1, w2 = w
    sa, sb = _safe(a), _safe(b)
    isa, isb, iden = 1.0 / sa, 1.0 / sb, 1.0 / _safe(a + b)
    r1, r2 = a * isb, b * isa
    big_a = (s1 - s2) * r1 - (s1 - s0) * r2
    big_b = (s2 - s1) * isb + (s0 - s1) * isa
    second, third = w1 * big_a * iden, w2 * big_b * iden
    li = lam * iden
    a_bar, b_bar = li * w1, li * w2
    den_bar = -li * (second + third)
    ds0 = a_bar * r2 + b_bar * isa
    ds1 = lam * w0 + a_bar * (r1 - r2) - b_bar * (isb + isa)
    ds2 = b_bar * isb - a_bar * r1
    r1_bar, r2_bar = a_bar * (s1 - s2), -a_bar * (s1 - s0)
    sa_bar = -((b_bar * (s0 - s1) + r2_bar * b) * isa) * isa
    sb_bar = -((b_bar * (s2 - s1) + r1_bar * a) * isb) * isb
    da = r1_bar * isb + _weights_adjoint(a, e, lam * (s1 - intensity), li * big_a, li * big_b)
    db = r2_bar * isa
    nz = a + b != 0
    da, db = torch.where(nz, da + den_bar, da), torch.where(nz, db + den_bar, db)
    da = torch.where(a != 0, da + sa_bar, da)
    db = torch.where(b != 0, db + sb_bar, db)
    return lam * (1.0 - w0), da, db, ds0, ds1, ds2


def _inward_steps(tau, s, w, g1, n, intensity, keep):
    """Kernel 2's inward steps g = g1 .. g1 - n + 1 on [B, G, F, T] taus and
    [B, D, F, 1] sources from ``intensity``, the intensity entering step g1
    (the carried quotient formed afresh there); keep(g, I) sees the
    intensity entering each step and, last, entering step g1 - n."""
    n_gaps = tau.shape[1]
    w0, w1, w2 = w
    tau_top = tau[:, n_gaps - 1]
    tau_g = tau[:, g1]
    q_g = (s[:, g1 + 1] - s[:, g1]) / _safe(tau_g)
    for g in range(g1, g1 - n, -1):
        keep(g, intensity)
        tau_gm1 = tau[:, g - 1] if g > 0 else tau_top
        s_g, s_gp1, s_gm1 = s[:, g], s[:, g + 1], s[:, g - 1 if g > 0 else n_gaps]
        denom = _safe(tau_g + tau_gm1)
        second = w1[:, g] * ((s_g - s_gm1) * (tau_g / _safe(tau_gm1))
                             - (s_g - s_gp1) * (tau_gm1 / _safe(tau_g))) / denom
        q_gm1 = (s_gm1 - s_g) / _safe(tau_gm1)
        third = w2[:, g] * (q_gm1 + q_g) / denom
        step = (1.0 - w0[:, g]) * intensity + w0[:, g] * s_g + second + third
        intensity = torch.where((tau_g != 0) & (tau_gm1 != 0), step, intensity)
        tau_g, q_g = tau_gm1, -q_gm1
    keep(g1 - n, intensity)
    return intensity


def _outward_steps(tau, s, w, k0, n, intensity, keep):
    """Kernel 2's outward interior steps k = k0 .. k0 + n - 1 from
    ``intensity``, the intensity entering gap k0 (the carried quotient
    formed afresh there); keep(k, I) sees the intensity entering each step
    and, last, entering gap k0 + n."""
    w0, w1, w2 = w
    tau_k, s_k, s_kp1 = tau[:, k0], s[:, k0], s[:, k0 + 1]
    q_k = (s_k - s_kp1) / _safe(tau_k)
    for k in range(k0, k0 + n):
        keep(k, intensity)
        tau_kp1, s_kp2 = tau[:, k + 1], s[:, k + 2]
        denom = _safe(tau_k + tau_kp1)
        second = w1[:, k] * ((s_kp1 - s_kp2) * (tau_k / _safe(tau_kp1))
                             - (s_kp1 - s_k) * (tau_kp1 / _safe(tau_k))) / denom
        q_kp1 = (s_kp2 - s_kp1) / _safe(tau_kp1)
        third = w2[:, k] * (q_kp1 + q_k) / denom
        step = (1.0 - w0[:, k]) * intensity + w0[:, k] * s_kp1 + second + third
        intensity = torch.where(tau_k != 0, step, intensity)
        tau_k, s_k, s_kp1, q_k = tau_kp1, s_kp1, s_kp2, -q_kp1
    keep(k0 + n, intensity)
    return intensity


def _grad_mirror(alphas, source, ray, weights, corr, inward, g_flux, g_int, tile,
                 chunk=tsolver.TRACE_GRAD_CHUNK, span=None):
    """(dL/dalphas, dL/dsource) [B, D, N] as Kernel 2b's blocks compute
    them, tile by tile: alphas, source [B, D, N], ray [B, G, T], weights
    [T], corr [B], g_flux [B, D, N] or None, g_int [B, D, N, T] or None;
    theta sums per ``chunk`` depths, a checkpoint every ``span`` steps (the
    kernel's: every step outward, TRACE_GRAD_SPAN inward)."""
    if span is None:
        span = tsolver.TRACE_GRAD_SPAN if inward else 1
    n_models, n_depth, n_nu = alphas.shape
    n_gaps, n_theta = n_depth - 1, len(weights)
    # the whole-array transcendentals (module docstring)
    log_a = torch.log(alphas[:, None])
    m = torch.exp(0.5 * (log_a[..., 1:, :] + log_a[..., :-1, :]))[:, 0]  # [B, G, N]
    taus = m[:, None] * ray.transpose(1, 2)[..., None]  # [B, T, G, N], plain's layout
    w_all = [x.permute(0, 2, 3, 1) for x in tsolver.calc_weights(taus)]  # [B, G, N, T]
    e_all = torch.exp(-torch.clamp(taus, max=tsolver.TAU_SATURATED + 10.0)).permute(0, 2, 3, 1)
    g_alpha = torch.full_like(alphas, torch.nan)
    g_source = torch.full_like(alphas, torch.nan)
    wc = weights[None, None, :] * corr[:, None, None]  # [B, 1, T]
    for n0 in range(0, n_nu, tile):
        cols = torch.clamp(torch.arange(n0, n0 + tile), max=n_nu - 1)
        valid = torch.arange(n0, n0 + tile) < n_nu
        n_valid = int(valid.sum())
        # staged once per block: m [B, G, F], S and gF [B, D, F]
        tau = m[:, :, cols, None] * ray[:, :, None, :]  # [B, G, F, T]
        w = [x[:, :, cols] for x in w_all]
        e = e_all[:, :, cols]
        s = source[:, :, cols, None]
        gf = None if g_flux is None else g_flux[:, :, cols, None]
        zero = torch.zeros_like(tau[:, 0])

        def seed(d):
            sd = zero if gf is None else wc * gf[:, d]
            return sd if g_int is None else sd + g_int[:, d, cols]

        def wk(g):
            return [x[:, g] for x in w]

        def write(d, qa, sa):
            g_alpha[:, d, n0:n0 + n_valid] = (qa / alphas[:, d, cols])[:, valid]
            g_source[:, d, n0:n0 + n_valid] = sa[:, valid]

        # the theta sums: a ray hands over one depth at a time; after each
        # chunk (and the last depth) the sums run in theta order and go to
        # finish(d, sum q, sum S_bar)
        pending = []

        def emit(v, sv, depth, finish):
            pending.append((depth, v, sv))
            if len(pending) == chunk or depth == (0 if finish is outward_sums else n_gaps):
                for d, pv, ps in pending:
                    qa, sa = zero[..., 0], zero[..., 0]
                    for t in range(n_theta):
                        qa, sa = qa + pv[..., t], sa + ps[..., t]
                    finish(d, qa, sa)
                pending.clear()

        acc = {}

        def outward_sums(d, qa, sa):
            if inward:
                acc[d] = (qa, sa)
            else:
                write(d, qa, sa)

        def inward_sums(d, qa, sa):
            write(d, acc[d][0] + qa, acc[d][1] + sa)

        # the forward, keeping checkpoints
        ckpt, ckpt_in, last = {}, {}, {}

        def keep_in(g, v):
            if g >= 0 and (n_gaps - 1 - g) % span == 0:
                ckpt_in[(n_gaps - 1 - g) // span] = v

        def keep_out(k, v):
            if k == n_gaps - 1:
                last[0] = v
            elif k % span == 0:
                ckpt[k // span] = v

        start = _inward_steps(tau, s, w, n_gaps - 1, n_gaps, zero, keep_in) if inward else zero
        _outward_steps(tau, s, w, 0, n_gaps - 1, start, keep_out)

        # the reverse outward sweep, the last gap's jump first
        lam = seed(n_gaps)
        tau_k = tau[:, n_gaps - 1]
        c1 = c2 = t_bar = zero
        w0, _, w2 = wk(n_gaps - 1)
        s0, s1 = s[:, n_gaps - 1], s[:, n_gaps]
        ist = 1.0 / _safe(tau_k)
        ist2 = ist * ist
        third = w2 * (s0 - s1) * ist2
        nz = tau_k != 0
        c1 = torch.where(nz, c1 + lam * w2 * ist2, c1)
        c2 = torch.where(nz, c2 + (lam * w0 - lam * w2 * ist2), c2)
        jump = (_weights_adjoint(tau_k, e[:, n_gaps - 1], lam * (s1 - last[0]), zero,
                                 lam * (s0 - s1) * ist2)
                - 2.0 * lam * third * ist)
        t_bar = torch.where(nz, jump, t_bar)
        lam = torch.where(nz, lam * (1.0 - w0), lam)
        lam = lam + seed(n_gaps - 1)
        q_hi, seg, k0 = zero, {}, 0
        for k in range(n_gaps - 2, -1, -1):
            if k == n_gaps - 2 or (k + 1) % span == 0:  # the top of a segment
                k0 = k - k % span
                seg.clear()
                _outward_steps(tau, s, w, k0, k - k0, ckpt[k0 // span],
                               lambda kk, v: seg.__setitem__(kk, v))
            tau_kp1, tau_k = tau_k, tau[:, k]
            nz = tau_k != 0
            d_lam, da, db, ds0, ds1, ds2 = _step_adjoint(
                tau_k, tau_kp1, s[:, k], s[:, k + 1], s[:, k + 2], seg[k], lam, wk(k),
                e[:, k])
            lam = torch.where(nz, d_lam, lam)
            a_bar = torch.where(nz, zero + da, zero)
            t_bar = torch.where(nz, t_bar + db, t_bar)
            c0 = torch.where(nz, zero + ds0, zero)
            c1 = torch.where(nz, c1 + ds1, c1)
            c2 = torch.where(nz, c2 + ds2, c2)
            q_k1 = 0.5 * t_bar * tau_kp1
            emit(q_hi + q_k1, c2, k + 2, outward_sums)
            q_hi, c2, c1, t_bar = q_k1, c1, c0, a_bar
            lam = lam + seed(k)
        q_0 = 0.5 * t_bar * tau_k
        emit(q_hi + q_0, c2, 1, outward_sums)
        emit(q_0, c1, 0, outward_sums)
        if not inward:
            continue

        # the reverse inward sweep from dL/dI_0, the centre up, with the
        # gap-0 wrap; its theta sums added to the outward reverse's
        tau_top = tau[:, n_gaps - 1]
        q_w = s_w = q_p = q_pp = s_p = s_c = zero
        i0 = 0
        for g in range(n_gaps):
            i = n_gaps - 1 - g
            if g == 0 or (i + 1) % span == 0:  # the last step of a segment
                i0 = i - i % span
                seg.clear()
                _inward_steps(tau, s, w, n_gaps - 1 - i0, i - i0, ckpt_in[i0 // span],
                              lambda gg, v: seg.__setitem__(gg, v))
            sm1 = g - 1 if g > 0 else n_gaps
            tau_g, tau_gm1 = tau[:, g], tau[:, g - 1] if g > 0 else tau_top
            nz = (tau_g != 0) & (tau_gm1 != 0)
            d_lam, da, db, dsp, dsg, dsm = _step_adjoint(
                tau_g, tau_gm1, s[:, g + 1], s[:, g], s[:, sm1], seg[g], lam, wk(g), e[:, g])
            lam = torch.where(nz, d_lam, lam)
            q_g = torch.where(nz, 0.5 * (zero + da) * tau_g, zero)
            q_b = 0.5 * (zero + db) * tau_gm1
            if g > 0:
                q_p = torch.where(nz, q_p + q_b, q_p)
                s_p = torch.where(nz, s_p + (zero + dsm), s_p)
            else:
                q_w = torch.where(nz, q_w + q_b, q_w)
                s_w = torch.where(nz, s_w + (zero + dsm), s_w)
            s_n = torch.where(nz, zero + dsp, zero)
            s_c = torch.where(nz, s_c + (zero + dsg), s_c)
            if g > 0:
                emit(q_p + q_pp if g > 1 else q_p, s_p, g - 1, inward_sums)
            q_pp, q_p, s_p, s_c = q_p, q_g, s_c, s_n
        q_last = q_w + q_p
        emit(q_last + q_pp if n_gaps > 1 else q_last, s_p, n_gaps - 1, inward_sums)
        emit(q_last, s_w + s_c, n_gaps, inward_sums)
        assert not pending
    return g_alpha, g_source


def _grads(dtype, geometry, n_theta, track, n_depth=56, seed=7):
    """The inputs (as _inputs) and seeded normal dL/dF_nu and dL/dI_nu
    (None unless ``track``)."""
    alphas, source, ray, weights, corr, inward = _inputs(geometry, n_theta, dtype, n_depth)
    rng = np.random.default_rng(seed)
    g_f = torch.as_tensor(rng.standard_normal(alphas.shape)).to(dtype)
    g_i = torch.as_tensor(rng.standard_normal((*alphas.shape, n_theta))).to(dtype)
    return alphas, source, ray, weights, corr, inward, g_f, (g_i if track else None)


def _col_err(ours, ref):
    """max over (model, frequency) columns of max_depth |ours - ref| /
    max_depth |ref|; columns where ref is 0 must be 0."""
    diff = (ours - ref).abs().amax(dim=1)
    scale = ref.abs().amax(dim=1)
    assert bool((diff[scale == 0] == 0).all())
    return (diff[scale > 0] / scale[scale > 0]).max().item()


def _launch_tile(alphas, n_theta, inward):
    return tsolver.trace_grad_tile(alphas.shape[1], n_theta, alphas.element_size(), inward)[0]


@pytest.mark.parametrize("track", [False, True], ids=["dF", "dF_and_dI"])
@pytest.mark.parametrize("n_theta", [1, 3, 20])
@pytest.mark.parametrize("geometry", ["plane", "spherical"])
def test_grad_mirror_matches_plain(geometry, n_theta, track):
    """At the kernel's launch tile (float64, N = 37 no multiple of it),
    against autograd of raytrace_plain at 1e-9 of each column's largest."""
    alphas, source, ray, weights, corr, inward, g_f, g_i = _grads(
        torch.float64, geometry, n_theta, track)
    tile = _launch_tile(alphas, n_theta, inward)
    assert N_NU % tile != 0 or tile == 1
    ours = _grad_mirror(alphas, source, ray, weights, corr, inward, g_f, g_i, tile)
    ref = tsolver.raytrace_plain_backward(alphas, source, ray, weights, g_f, g_i, inward, corr)
    for o, r in zip(ours, ref):
        assert torch.isfinite(o).all()
        assert _col_err(o, r) <= 1e-9


@pytest.mark.parametrize("n_theta", [1, 3, 20])
@pytest.mark.parametrize("geometry", ["plane", "spherical"])
def test_grad_mirror_matches_jax_vjp(geometry, n_theta):
    """Against JAX's jax.vjp of raytrace, model by model, dF and dF + dI,
    per frequency column at TRACE_BOUND (these columns' tau spans the
    Taylor threshold)."""
    alphas, source, ray, weights, corr, inward, g_f, g_i = _grads(
        torch.float64, geometry, n_theta, True)
    tile = _launch_tile(alphas, n_theta, inward)
    bound = TRACE_BOUND["spanning_giant" if inward else "spanning_plane"]
    for track in (False, True):
        ours = _grad_mirror(alphas, source, ray, weights, corr, inward, g_f,
                            g_i if track else None, tile)
        for b in range(alphas.shape[0]):
            def jax_trace(al, so, b=b):
                return jsolver.raytrace(al, so, jnp.asarray(ray[b].numpy()),
                                        jnp.asarray(weights.numpy()), inward_rays=inward,
                                        photospheric_correction=float(corr[b]),
                                        track_individual_intensities=True)

            _, vjp = jax.vjp(jax_trace, jnp.asarray(alphas[b].numpy()),
                             jnp.asarray(source[b].numpy()))
            cot_i = g_i[b].numpy() if track else np.zeros(g_i[b].shape)
            ref = vjp((jnp.asarray(g_f[b].numpy()), jnp.asarray(cot_i)))
            for o, r in zip(ours, ref):
                assert _col_err(o[b:b + 1], torch.as_tensor(np.array(r))[None]) <= bound


@pytest.mark.parametrize("tile, chunk, span, n_depth", [
    (5, 8, 3, 13), (1, 3, 1, 56), (37, 1, 8, 4), (6, 8, 8, 2), (3, 56, 55, 56), (8, 4, 16, 56)])
@pytest.mark.parametrize("geometry", ["plane", "spherical"])
def test_grad_mirror_any_tile_chunk_and_span(geometry, tile, chunk, span, n_depth):
    """Other tiles, chunks and checkpoint spans (a partial last tile,
    chunk and segment, one depth per chunk, one chunk for all depths, a
    checkpoint at every step, one segment for all, a single gap): the same
    bits as at the launch shape, dF and dF + dI."""
    for track in (False, True):
        alphas, source, ray, weights, corr, inward, g_f, g_i = _grads(
            torch.float64, geometry, 3, track, n_depth=n_depth)
        ours = _grad_mirror(alphas, source, ray, weights, corr, inward, g_f, g_i, tile, chunk,
                            span)
        ref = _grad_mirror(alphas, source, ray, weights, corr, inward, g_f, g_i,
                           _launch_tile(alphas, 3, inward))
        assert all(torch.equal(x, y) for x, y in zip(ours, ref))
        plain = tsolver.raytrace_plain_backward(alphas, source, ray, weights, g_f, g_i, inward,
                                                corr)
        assert all(_col_err(x, y) <= 1e-9 for x, y in zip(ours, plain))


@pytest.mark.parametrize("geometry", ["plane", "spherical"])
def test_grad_mirror_float32_within_plain_error(geometry):
    """float32 (T = 20, dF and dF + dI): the mirror's 2-norm error against
    the float64 gradient within 1.5x the plain version's own, as the card's
    Kernel 2b is held."""
    for track in (False, True):
        args32 = _grads(torch.float32, geometry, 20, track)
        args64 = _grads(torch.float64, geometry, 20, track)
        alphas, source, ray, weights, corr, inward, g_f, g_i = args32
        ours = _grad_mirror(alphas, source, ray, weights, corr, inward, g_f, g_i,
                            _launch_tile(alphas, 20, inward))
        plain = tsolver.raytrace_plain_backward(alphas, source, ray, weights, g_f, g_i, inward,
                                                corr)
        a, s, r, w, c, _, gf64, gi64 = args64
        exact = tsolver.raytrace_plain_backward(a, s, r, w, gf64, gi64, inward, c)
        for o, p, x in zip(ours, plain, exact):
            assert torch.isfinite(o).all()
            assert (o.double() - x).norm() <= 1.5 * (p.double() - x).norm()


@pytest.mark.parametrize("inward", [False, True], ids=["plane", "spherical"])
@pytest.mark.parametrize("n_theta", [1, 3, 20, 100])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_trace_grad_tile_shape(n_theta, itemsize, inward):
    """Kernel 2's tile (TRACE_THREADS // T frequencies), halved only while
    a block's shared bytes (``trace_grad_shared``, csrc/formal_solution_grad.cu's
    layout) exceed TRACE_MAX_SHARED; at 56 depths the outward sweep keeps
    every entering intensity (a span of 1), the inward one a checkpoint
    every TRACE_GRAD_SPAN steps; at 20 angles 8 frequencies, with the
    layout's bytes counted by hand."""
    tile, span, shared = tsolver.trace_grad_tile(56, n_theta, itemsize, inward)
    assert span == (tsolver.TRACE_GRAD_SPAN if inward else 1)

    def layout(f):
        return tsolver.trace_grad_shared(56, n_theta, f, span, itemsize, inward)

    halvings = [max(1, min(tsolver.TRACE_MAX_TILE, tsolver.TRACE_THREADS // n_theta))]
    while halvings[-1] > 1:
        halvings.append(halvings[-1] // 2)
    i = halvings.index(tile)
    assert shared == layout(tile)
    assert i == 0 or layout(halvings[i - 1]) > tsolver.TRACE_MAX_SHARED
    assert tile * n_theta <= tsolver.TRACE_MAX_THREADS and shared <= tsolver.TRACE_MAX_SHARED
    if n_theta == 20:
        # outward: m 55 x 8, S and gF 2 x 56 x 8, chords 55 x 20, weights 20,
        # (54 entering intensities + 4 x 4 chunk planes) x 160; inward: (7 +
        # 16 + 7 checkpoints and chunks + 8 segment planes) x 160 and the
        # outward reverse's sums 2 x 56 x 8 in place of the 54
        assert tile == 8
        assert shared == itemsize * {False: 13_656, True: 9_432}[inward]


@pytest.mark.parametrize("inward", [False, True], ids=["plane", "spherical"])
@pytest.mark.parametrize("n_theta", [1, 3, 20, 26])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_trace_grad_tile_takes_every_depth_kernel_2_takes(n_theta, itemsize, inward):
    """Up to 26 angles Kernel 2b takes every depth count Kernel 2's forward
    takes (``trace_tile``); the outward variant keeps checkpoints exactly
    where one frequency's block cannot hold every entering intensity."""
    def takes(fn, n_depth):
        try:
            fn(n_depth)
        except ValueError:
            return False
        return True

    lo, hi = 2, 20_000  # the most depths Kernel 2 takes
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if takes(lambda d: tsolver.trace_tile(d, n_theta, itemsize), mid) \
            else (lo, mid - 1)
    for n_depth in (lo // 2, lo):
        tile, span, shared = tsolver.trace_grad_tile(n_depth, n_theta, itemsize, inward)
        assert shared <= tsolver.TRACE_MAX_SHARED
        if not inward:
            one = tsolver.trace_grad_shared(n_depth, n_theta, 1, 1, itemsize, False)
            assert (span > 1) == (one > tsolver.TRACE_MAX_SHARED)
            assert span in (1, tsolver.TRACE_GRAD_SPAN)


@pytest.mark.parametrize("inward", [False, True], ids=["plane", "spherical"])
@pytest.mark.parametrize("n_depth, n_theta, itemsize", [(56, tsolver.TRACE_MAX_THREADS + 1, 4),
                                                        (2000, 20, 8), (3000, 20, 4)])
def test_trace_grad_tile_rejects_what_a_block_cannot_hold(n_depth, n_theta, itemsize, inward):
    """More angles than a block's threads, or one frequency's layout beyond
    a block's shared memory, raise before any launch."""
    with pytest.raises(ValueError, match="formal_solution_grad kernel"):
        tsolver.trace_grad_tile(n_depth, n_theta, itemsize, inward)
