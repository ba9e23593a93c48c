# Frozen copy of stardis_tpu_torch/radiation_field/solver.py at commit 9c7d618, cut to its plain
# torch path (no kernel): part of the benchmark's reference.  Keep it as it is.
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


import numpy as np
import torch


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


