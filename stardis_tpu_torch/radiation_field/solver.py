"""Formal solution of the radiative-transfer equation (Kernel 2).

van Noort 2001 short characteristics with parabolic source interpolation,
as in ``stardis_tpu/radiation_field/solver.py``:

* segment optical depth tau = exp((ln a_k + ln a_{k+1})/2) * ds;
* weights w0/w1/w2 in three tau regimes (Taylor below 5e-4, saturated
  from 50);
* spherical models first sweep each chord inward (surface -> centre), with
  the reference's wrap of tau[g-1] / source[g-1] at gap 0, and the result
  seeds the outward sweep; the flux gets the per-model photospheric
  correction (r_outer / r_ref)^2;
* the depth sweep I_{k+1} = a_k I_k + b_k, a first-order recurrence: the
  JAX package runs it as an associative scan (a TPU way to parallelise a
  serial loop); here the plain version is a Python loop over depth and the
  kernel (csrc/formal_solution.cu) a serial loop per (model, nu, theta)
  thread, a block holding a tile of frequencies and all their angles,
  with the theta-invariant mean extinction and source staged once per
  tile and the theta sum fused; its backward, Kernel 2b
  (csrc/formal_solution_grad.cu), recomputes the sweep in the same tile
  and saves no intensity.

Every function takes a leading model axis: alphas and source [B, D, N],
ray distances [B, G, T], one correction per model.  ``raytrace`` also
takes a single model ([D, N], [G, T]) and returns it without the axis.
It dispatches on the device of its tensors: the plain version on the CPU,
the kernel on a CUDA device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _cuda

TAU_TAYLOR = 5e-4
TAU_SATURATED = 50.0


def gauss_legendre_thetas(num_of_thetas):
    """theta quadrature: thetas = x/2 + pi/4, weights = w * pi/2, so an
    isotropic intensity I integrates to F = pi * I."""
    x, w = np.polynomial.legendre.leggauss(num_of_thetas)
    thetas = x / 2.0 + 0.5 * np.pi / 2.0
    weights = w * np.pi / 2.0
    return thetas, weights


def calculate_spherical_ray(thetas, depth_points_radii):
    """Chord lengths [G, T] through the shells for each impact parameter
    b = r_outer sin(theta) (host NumPy); 0 where a chord misses a shell."""
    radii = np.asarray(depth_points_radii)
    out = np.zeros((len(radii) - 1, len(thetas)))
    for ti, theta in enumerate(np.asarray(thetas)):
        b = radii[-1] * np.sin(theta)
        with np.errstate(invalid="ignore"):
            z = np.sqrt(radii**2 - b**2)  # NaN where the ray misses the shell
        dz = np.diff(z)
        good = ~np.isnan(dz)
        out[good, ti] = dz[good]
    return out


def calc_weights(delta_tau):
    """w0, w1, w2 with three tau regimes."""
    tau = delta_tau
    exp_tau = torch.exp(-torch.clamp(tau, max=TAU_SATURATED + 10.0))

    w0_mid = 1.0 - exp_tau
    w1_mid = w0_mid - tau * exp_tau
    w2_mid = 2.0 * w1_mid - tau * tau * exp_tau

    w0_small = tau * (1.0 - tau / 2.0)
    w1_small = tau**2 * (0.5 - tau / 3.0)
    w2_small = tau**3 * (1.0 / 3.0 - tau / 4.0)

    small = tau < TAU_TAYLOR
    big = tau >= TAU_SATURATED
    one = torch.ones_like(tau)
    w0 = torch.where(small, w0_small, torch.where(big, one, w0_mid))
    w1 = torch.where(small, w1_small, torch.where(big, one, w1_mid))
    w2 = torch.where(small, w2_small, torch.where(big, 2.0 * one, w2_mid))
    return w0, w1, w2


def _safe(tau):
    return torch.where(tau == 0.0, torch.ones_like(tau), tau)


def compute_taus(alphas, ray_dist):
    """tau[..., g, n] = exp(mean(ln alpha)) * ds_g from alphas [..., D, N]
    and ray_dist [..., G] (broadcast against each other).  Zero distances
    give tau = 0."""
    log_a = torch.log(alphas)
    mean_alphas = torch.exp(0.5 * (log_a[..., 1:, :] + log_a[..., :-1, :]))
    return mean_alphas * ray_dist[..., :, None]


def _inward_intensity(s, taus, w0, w1, w2):
    """Intensity at gap 0 after the spherical inward sweep
    I[g] = a'_g I[g+1] + b'_g, g = G-1 .. 0, from I = 0 at the surface.

    At g = 0 tau[g-1] wraps to tau[G-1] and source[g-1] to source[G], the
    last element of the FULL source array: the reference's negative
    indexing, kept on purpose.  A gap with tau[g] = 0 or tau[g-1] = 0
    passes the intensity through."""
    n_gaps = taus.shape[-2]
    tau_g = taus
    tau_gm1 = torch.roll(taus, 1, dims=-2)
    s_gm1 = torch.roll(s, 1, dims=-2)[..., :-1, :]
    s_g = s[..., :-1, :]
    s_gp1 = s[..., 1:, :]

    denom = tau_g + tau_gm1
    second = (
        w1
        * (
            (s_g - s_gm1) * (tau_g / _safe(tau_gm1))
            - (s_g - s_gp1) * (tau_gm1 / _safe(tau_g))
        )
        / _safe(denom)
    )
    third = (
        w2
        * ((s_gm1 - s_g) / _safe(tau_gm1) + (s_gp1 - s_g) / _safe(tau_g))
        / _safe(denom)
    )
    zero = (tau_g == 0.0) | (tau_gm1 == 0.0)
    return _sweep(zero, 1.0 - w0, (w0 * s_g, second, third), range(n_gaps - 1, -1, -1),
                  torch.zeros_like(third[..., 0, :]))


def _sweep(zero, a, terms, gaps, intensity, trail=None):
    """The recurrence I <- a I + t1 + t2 + t3 over ``gaps`` in order, summed
    in the reference's order; a gap where ``zero`` passes I through.
    ``trail`` collects the intensity after each gap."""
    t1, t2, t3 = terms
    for g in gaps:
        step = a[..., g, :] * intensity + t1[..., g, :] + t2[..., g, :] + t3[..., g, :]
        intensity = torch.where(zero[..., g, :], intensity, step)
        if trail is not None:
            trail.append(intensity)
    return intensity


def single_theta_trace(source, taus, inward_rays=False):
    """Intensity at every depth point along each ray.

    source : [..., D, N] (D = G + 1), broadcast against taus
    taus : [..., G, N]
    inward_rays : spherical chords get the surface->centre sweep first
    returns I : [..., D, N]
    """
    n_gaps = taus.shape[-2]
    w0, w1, w2 = calc_weights(taus)
    s = source

    if inward_rays:
        i_inner = _inward_intensity(s, taus, w0, w1, w2)
    else:
        i_inner = torch.zeros_like(taus[..., 0, :] * s[..., 0, :])

    # gaps 0 .. G-2: parabolic interior formula
    tau_k = taus[..., : n_gaps - 1, :]
    tau_kp1 = taus[..., 1:n_gaps, :]
    s_k = s[..., : n_gaps - 1, :]
    s_kp1 = s[..., 1:n_gaps, :]
    s_kp2 = s[..., 2 : n_gaps + 1, :]
    w1_i = w1[..., : n_gaps - 1, :]
    w2_i = w2[..., : n_gaps - 1, :]

    denom = tau_k + tau_kp1
    second = (
        w1_i
        * (
            (s_kp1 - s_kp2) * (tau_k / _safe(tau_kp1))
            - (s_kp1 - s_k) * (tau_kp1 / _safe(tau_k))
        )
        / _safe(denom)
    )
    third = (
        w2_i
        * ((s_kp2 - s_kp1) / _safe(tau_kp1) + (s_k - s_kp1) / _safe(tau_k))
        / _safe(denom)
    )
    # last gap: constant-source boundary jump
    tau_last = taus[..., -1:, :]
    third_last = w2[..., -1:, :] * (s[..., -2:-1, :] - s[..., -1:, :]) / _safe(tau_last) ** 2

    zero = taus == 0.0
    terms = (
        w0 * s[..., 1:, :],
        torch.cat([second, torch.zeros_like(third_last)], dim=-2),
        torch.cat([third, third_last], dim=-2),
    )
    intensity = [i_inner]
    _sweep(zero, 1.0 - w0, terms, range(n_gaps), i_inner, trail=intensity)
    return torch.stack(intensity, dim=-2)


def _corrections(photospheric_correction, n_models, like):
    """None, a number or one value per model -> [B] tensor like ``like``."""
    if photospheric_correction is None:
        return torch.ones(n_models, dtype=like.dtype, device=like.device)
    corr = torch.as_tensor(photospheric_correction, dtype=like.dtype, device=like.device)
    return corr.expand(n_models) if corr.ndim == 0 else corr


def _as_batch(alphas, source, ray_distances):
    """(single, alphas, source, rays) with a leading model axis added to a
    single model's [D, N] / [G, T] arrays."""
    if alphas.ndim == 2:
        return True, alphas[None], source[None], ray_distances[None]
    return False, alphas, source, ray_distances


def _strip(single, f_nu, i_nus):
    if single:
        return f_nu[0], (None if i_nus is None else i_nus[0])
    return f_nu, i_nus


def raytrace(alphas, source, ray_distances, weights, inward_rays=False,
             photospheric_correction=None, track_individual_intensities=False):
    """F_nu = correction * sum_theta w_theta I_theta, and I_nus when
    tracked (else None).

    alphas, source : [B, D, N], or [D, N] for one model
    ray_distances : [B, G, T], or [G, T]
    weights : [T]
    photospheric_correction : None, a number, or [B] (one per model)
    returns F_nu [B, D, N] and I_nus [B, D, N, T] (without B for one model)
    """
    if alphas.device.type == "cpu":
        return raytrace_plain(
            alphas, source, ray_distances, weights, inward_rays,
            photospheric_correction, track_individual_intensities,
        )
    if alphas.device.type != "cuda":
        raise ValueError(f"no formal-solution path for device {alphas.device}")
    single, alphas, source, ray_distances = _as_batch(alphas, source, ray_distances)
    return _strip(single, *raytrace_cuda(
        alphas, source, ray_distances, weights, inward_rays,
        photospheric_correction, track_individual_intensities,
    ))


def raytrace_plain(alphas, source, ray_distances, weights, inward_rays=False,
                   photospheric_correction=None,
                   track_individual_intensities=False):
    """Plain torch version (shapes as ``raytrace``): all models and angles
    at once, a Python loop over depth, then the theta sum in theta order
    (as the kernel sums it)."""
    single, alphas, source, ray_distances = _as_batch(alphas, source, ray_distances)
    taus = compute_taus(alphas[:, None], ray_distances.transpose(1, 2))  # [B, T, G, N]
    i_nus = single_theta_trace(source[:, None], taus, inward_rays)  # [B, T, D, N]
    w = weights.to(i_nus.dtype)
    f_nu = torch.zeros_like(i_nus[:, 0])
    for t in range(i_nus.shape[1]):
        f_nu = f_nu + w[t] * i_nus[:, t]
    if photospheric_correction is not None:
        corr = _corrections(photospheric_correction, alphas.shape[0], f_nu)
        f_nu = f_nu * corr[:, None, None]
    if track_individual_intensities:
        return _strip(single, f_nu, torch.movedim(i_nus, 1, -1))  # [B, D, N, T]
    return _strip(single, f_nu, None)


def raytrace_plain_backward(alphas, source, ray_distances, weights, g_flux, g_intensity=None,
                            inward_rays=False, photospheric_correction=None):
    """Plain version of Kernel 2b: (dL/dalphas, dL/dsource) from
    torch.autograd.grad of ``raytrace_plain`` (shapes as ``raytrace``),
    given g_flux = dL/dF_nu and, optionally, g_intensity = dL/dI_nus
    [B, D, N, T]; either may be None."""
    with torch.enable_grad():
        a = alphas.detach().requires_grad_()
        s = source.detach().requires_grad_()
        track = g_intensity is not None
        f_nu, i_nus = raytrace_plain(a, s, ray_distances, weights, inward_rays,
                                     photospheric_correction, track)
        outs = [(f_nu, g_flux), (i_nus, g_intensity)]
        outs = [(o, g) for o, g in outs if g is not None]
        return torch.autograd.grad([o for o, _ in outs], (a, s), [g for _, g in outs],
                                   allow_unused=True, materialize_grads=True)


_TRACE_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
#: Kernel 2's block: TRACE_THREADS // T frequencies of T angles, at most
#: TRACE_MAX_TILE frequencies and at most TRACE_MAX_THREADS threads (the
#: kernel's __launch_bounds__); its theta sum runs per TRACE_CHUNK depths;
#: its shared memory may reach the H100's per-block opt-in limit
TRACE_THREADS = 160
TRACE_MAX_TILE = 32
TRACE_MAX_THREADS = 512
TRACE_CHUNK = 8
TRACE_MAX_SHARED = 232_448
#: Kernel 2b's theta sums run per TRACE_GRAD_CHUNK depths; its recomputed
#: sweeps keep a checkpoint every TRACE_GRAD_SPAN steps where they keep
#: checkpoints (the build's -DSPAN, _cuda.KERNEL_FLAGS)
TRACE_GRAD_CHUNK = 4
TRACE_GRAD_SPAN = _cuda.TRACE_GRAD_SPAN


def trace_tile(n_depth, n_theta, itemsize):
    """(frequencies per block, dynamic shared bytes) of Kernel 2's launch
    for D depths and T angles; raises ValueError where one block cannot
    hold T angles.  The bytes are csrc/formal_solution.cu's layout: the
    gaps' mean extinction [G][F], the source [D][F], the chords [G][T],
    the weights [T] and the double-buffered theta-sum chunks
    [2][TRACE_CHUNK][F][T]."""
    tile = max(1, min(TRACE_MAX_TILE, TRACE_THREADS // n_theta))
    n_gaps = n_depth - 1
    shared = itemsize * (n_gaps * tile + n_depth * tile + n_gaps * n_theta + n_theta
                         + 2 * TRACE_CHUNK * tile * n_theta)
    if tile * n_theta > TRACE_MAX_THREADS or shared > TRACE_MAX_SHARED:
        raise ValueError(
            f"formal_solution kernel: {n_theta} angles at {n_depth} depths need "
            f"{tile * n_theta} threads and {shared} B of shared memory per block "
            f"(at most {TRACE_MAX_THREADS} and {TRACE_MAX_SHARED})")
    return tile, shared


def trace_grad_shared(n_depth, n_theta, tile, span, itemsize, inward):
    """Dynamic shared bytes of one block of Kernel 2b (csrc/formal_solution_grad.cu's
    shared_elems; a launch checks the two agree): the gaps' mean
    extinction [G][F], the source and dL/dF_nu [D][F], the chords [G][T],
    the weights [T]; the outward sweep's checkpoints [ceil((G - 1) / span)][F][T]
    (every interior gap's entering intensity at a span of 1); the
    double-buffered theta-sum chunks [2][2 TRACE_GRAD_CHUNK][F][T];
    inward, the inward sweep's checkpoints [ceil(G / S)][F][T] (S =
    TRACE_GRAD_SPAN); at a span of S a recomputed segment [S][F][T];
    inward, the outward reverse's theta sums [2][D][F]."""
    n_gaps, big = n_depth - 1, TRACE_GRAD_SPAN
    planes = (-(-(n_gaps - 1) // span) + 4 * TRACE_GRAD_CHUNK
              + (-(-n_gaps // big) if inward else 0) + (big if span > 1 else 0))
    return itemsize * (n_gaps * tile + 2 * n_depth * tile + n_gaps * n_theta + n_theta
                       + planes * tile * n_theta + (2 * n_depth * tile if inward else 0))


def trace_grad_tile(n_depth, n_theta, itemsize, inward):
    """(frequencies per block, outward checkpoint span, dynamic shared
    bytes) of Kernel 2b's launch for D depths and T angles.  The tile is
    Kernel 2's (TRACE_THREADS // T frequencies), halved only while a block
    would exceed TRACE_MAX_SHARED.  The outward variant keeps every
    entering intensity (a span of 1) while one frequency's block can hold
    them, else a checkpoint every TRACE_GRAD_SPAN steps; the inward
    variant always keeps checkpoints.  Up to 26 angles this takes every
    depth count Kernel 2's forward takes (trace_tile); beyond, the chords
    and checkpoints leave fewer (at T = 100, 482 depths in float32 and 230
    in float64 against Kernel 2's 554 and 269).  Raises ValueError where no
    block holds T angles: more than TRACE_MAX_THREADS of them, or, at T =
    20, beyond 2,259 depths in float32 and 1,120 in float64 (outward)."""
    top = max(1, min(TRACE_MAX_TILE, TRACE_THREADS // n_theta))
    shared = None
    for span in ((TRACE_GRAD_SPAN,) if inward else (1, TRACE_GRAD_SPAN)):
        tile = top
        while tile > 1 and trace_grad_shared(n_depth, n_theta, tile, span, itemsize,
                                             inward) > TRACE_MAX_SHARED:
            tile //= 2
        shared = trace_grad_shared(n_depth, n_theta, tile, span, itemsize, inward)
        if shared <= TRACE_MAX_SHARED:
            break
    if tile * n_theta > TRACE_MAX_THREADS or shared > TRACE_MAX_SHARED:
        raise ValueError(
            f"formal_solution_grad kernel: {n_theta} angles at {n_depth} depths need "
            f"{tile * n_theta} threads and {shared} B of shared memory per block "
            f"(at most {TRACE_MAX_THREADS} and {TRACE_MAX_SHARED})")
    return tile, span, shared


def raytrace_cuda(alphas, source, ray_distances, weights, inward_rays=False,
                  photospheric_correction=None,
                  track_individual_intensities=False):
    """Kernel 2 (csrc/formal_solution.cu) on CUDA tensors [B, D, N] /
    [B, G, T]; raises on anything the kernel does not take.  Spherical
    models (``inward_rays``) launch the kernel's inward-sweep variant.

    Differentiable in alphas and source (and through F_nu and the tracked
    I_nus): the backward is Kernel 2b (csrc/formal_solution_grad.cu),
    which recomputes the sweep from alphas and source.  The kernel writes
    the intensity buffer [B, D, N, T] only when I_nus is tracked; nothing
    of that size is allocated or saved otherwise, under autograd too.  Ray
    distances, weights and the corrections are constants of the plan."""
    n_models = alphas.shape[0]
    if any(t.requires_grad for t in (ray_distances, weights)) or (
            torch.is_tensor(photospheric_correction)
            and photospheric_correction.requires_grad):
        raise ValueError("formal_solution kernel: only alphas and source are differentiable")
    correction = _corrections(photospheric_correction, n_models, alphas).contiguous()
    track = bool(track_individual_intensities)
    f_nu, intensity = _Raytrace.apply(alphas, source, ray_distances, weights, correction,
                                      bool(inward_rays), track)
    return f_nu, (intensity if track else None)


def _launch_trace(alphas, source, ray_distances, weights, correction, inward_rays, track):
    """Kernel 2's launch on contiguous tensors: F_nu [B, D, N] and, when
    I_nus is tracked, the intensity buffer [B, D, N, T], else None."""
    n_models, n_depth, n_nu = alphas.shape
    dtype = alphas.dtype
    tensors = (alphas, source, ray_distances, weights, correction)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"formal_solution kernel takes float32/float64, not {dtype}")
    if any(t.dtype != dtype for t in tensors):
        raise TypeError("formal_solution kernel: mixed dtypes")
    if any(not t.is_cuda or t.device != alphas.device for t in tensors):
        raise ValueError("formal_solution kernel: all tensors must be on one CUDA device")
    if n_depth < 2 or source.shape != alphas.shape:
        raise ValueError("formal_solution kernel: alphas/source must be [B, D >= 2, N]")
    n_theta = weights.shape[0]
    if ray_distances.shape != (n_models, n_depth - 1, n_theta):
        raise ValueError("formal_solution kernel: ray_distances must be [B, D - 1, T]")
    if correction.shape != (n_models,):
        raise ValueError("formal_solution kernel: one photospheric correction per model")
    tile, _ = trace_tile(n_depth, n_theta, alphas.element_size())
    intensity = (torch.empty((n_models, n_depth, n_nu, n_theta), dtype=dtype,
                             device=alphas.device) if track else None)
    f_nu = torch.empty((n_models, n_depth, n_nu), dtype=dtype, device=alphas.device)
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = _cuda.bind("formal_solution", f"formal_solution_{suffix}", _TRACE_ARGS)
    p = _cuda.ptr
    status = _cuda.launch(
        fn, alphas.device,
        p(alphas), p(source), p(ray_distances), p(weights), p(correction),
        ctypes.c_void_p(None) if intensity is None else p(intensity), p(f_nu),
        n_models, n_depth, n_nu, n_theta, tile, TRACE_CHUNK, int(bool(inward_rays)),
    )
    if inward_rays:
        _cuda.count(raytrace_cuda, "inward_launches")
    else:
        _cuda.count(raytrace_cuda, "launches")
    _cuda.check("formal_solution", status)
    return f_nu, intensity


class _Raytrace(torch.autograd.Function):
    """Kernel 2 forward, Kernel 2b backward.  The second output is the
    tracked intensity buffer, or an empty tensor marked non-differentiable
    when I_nus is not tracked.  Only the inputs are saved: Kernel 2b
    recomputes the sweep."""

    @staticmethod
    def forward(ctx, alphas, source, ray_distances, weights, correction, inward_rays, track):
        alphas, source, ray_distances, weights = (
            t.contiguous() for t in (alphas, source, ray_distances, weights))
        f_nu, intensity = _launch_trace(alphas, source, ray_distances, weights, correction,
                                        inward_rays, track)
        if intensity is None:
            intensity = alphas.new_empty(0)
            ctx.mark_non_differentiable(intensity)
        ctx.save_for_backward(alphas, source, ray_distances, weights, correction)
        ctx.inward_rays = inward_rays
        ctx.set_materialize_grads(False)
        return f_nu, intensity

    @staticmethod
    def backward(ctx, g_flux, g_intensity):
        grads = raytrace_grad_cuda(*ctx.saved_tensors, g_flux, g_intensity, ctx.inward_rays)
        return (*grads, None, None, None, None, None)


_TRACE_GRAD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def raytrace_grad_cuda(alphas, source, ray_distances, weights, correction, g_flux,
                       g_intensity, inward_rays):
    """Kernel 2b (csrc/formal_solution_grad.cu): (dL/dalphas, dL/dsource)
    [B, D, N] from Kernel 2's inputs and the incoming gradients of F_nu
    [B, D, N] and I_nus [B, D, N, T] (either may be None), each output
    written once.  The kernel recomputes the forward sweep in its blocks
    and allocates nothing beyond the two outputs; the gradient of F_nu
    does not depend on whether I_nus was tracked."""
    n_models, n_depth, n_nu = alphas.shape
    n_theta = weights.shape[0]
    dtype = alphas.dtype
    saved = (alphas, source, ray_distances, weights, correction)
    if any(t.dtype != dtype or t.device != alphas.device or not t.is_contiguous()
           for t in saved):
        raise ValueError("formal_solution_grad kernel: inputs must be contiguous, of one "
                         "dtype, on one CUDA device")
    if (source.shape != alphas.shape
            or ray_distances.shape != (n_models, n_depth - 1, n_theta)
            or correction.shape != (n_models,)):
        raise ValueError("formal_solution_grad kernel: shapes must be Kernel 2's")
    itemsize, inward = alphas.element_size(), bool(inward_rays)
    tile, span, shared = trace_grad_tile(n_depth, n_theta, itemsize, inward)

    def incoming(g, shape):
        if g is None:
            return None
        if g.shape != shape or g.dtype != dtype or g.device != alphas.device:
            raise ValueError(f"formal_solution_grad kernel: gradient must be {shape}, {dtype}")
        return g.contiguous()

    g_flux = incoming(g_flux, alphas.shape)
    g_intensity = incoming(g_intensity, (*alphas.shape, n_theta))
    g_alpha = torch.empty_like(alphas)
    g_source = torch.empty_like(alphas)
    if g_flux is None and g_intensity is None:
        return g_alpha.zero_(), g_source.zero_()
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = _cuda.bind("formal_solution_grad", f"formal_solution_grad_{suffix}",
                    _TRACE_GRAD_ARGS)
    layout = _cuda.bind("formal_solution_grad", "formal_solution_grad_shared_bytes",
                        [ctypes.c_int] * 7)
    layout.restype = ctypes.c_longlong
    if layout(n_depth, n_theta, tile, TRACE_GRAD_CHUNK, span, itemsize, int(inward)) != shared:
        raise RuntimeError("formal_solution_grad kernel: its shared layout is not "
                           "trace_grad_shared's")

    def p(t):
        return ctypes.c_void_p(None) if t is None else _cuda.ptr(t)

    status = _cuda.launch(
        fn, alphas.device,
        p(alphas), p(source), p(ray_distances), p(weights), p(correction), p(g_flux),
        p(g_intensity), p(g_alpha), p(g_source), n_models, n_depth, n_nu, n_theta, tile,
        TRACE_GRAD_CHUNK, span, int(inward),
    )
    if inward_rays:
        _cuda.count(raytrace_grad_cuda, "inward_launches")
    else:
        _cuda.count(raytrace_grad_cuda, "launches")
    _cuda.check("formal_solution_grad", status)
    return g_alpha, g_source


#: launches of the outward (plane-parallel) and inward-sweep (spherical)
#: variants of Kernel 2, and of Kernel 2b
raytrace_cuda.launches = 0
raytrace_cuda.inward_launches = 0
raytrace_grad_cuda.launches = 0
raytrace_grad_cuda.inward_launches = 0
