"""The plain reference of one step of a spectral fit: the rotation and
instrumental broadening, the mean normalisation, the mean-squared loss
against an observed spectrum and its gradient, in plain torch, in the
precision of the ``Reference`` it is given (float64 for the reference,
bfloat16 for the control), on any device.  It imports nothing of the
program.

The surface F_nu over the whole grid comes from ``reference.spectrum``, and
so does the line sum whose gradients in alpha, gamma and doppler (autograd
through it) are Kernel 1b's outputs as the reference has them.
Derivatives in v sin i and sigma are autograd's through the functions
below; derivatives in the temperature scale s (temperatures times s,
densities over s, as a fit at fixed pressure scales them) are central
differences.  The line windows are integers that the program holds
fixed under differentiation (piecewise constant), so the two evaluations
of the difference keep every (line, depth) window of the centre point.

Departures from the published formulas, all shared with the fit as its
users run it:

* the rotation profile (Gray, The Observation and Analysis of Stellar
  Photospheres, 3rd ed., eq. 18.14: linear limb darkening epsilon) is
  sampled at the pixels' velocities on a static support and normalised to
  unit sum, so its analytic denominator drops out; |v sin i| is held at
  1e-5 km/s or more;
* the instrumental profile is a Gaussian sampled at the pixels and
  normalised to unit sum (scipy's ``gaussian_filter1d`` kernel), not the
  pixel-integrated one; |sigma| is held at 1e-6 px or more;
* both convolutions repeat the edge sample beyond the grid (scipy.ndimage's
  'reflect' boundary).
"""

from __future__ import annotations

import numpy as np
import torch

from . import spectrum

#: limb darkening of the rotation profile
LIMB_DARKENING = 0.6


def rotation_kernel(vel_pix, v_sin_i, half, epsilon=LIMB_DARKENING):
    """Gray's rotation profile at the velocities of 2 half + 1 pixels
    (``vel_pix`` km/s apart), normalised to unit sum; v_sin_i a 0-d tensor."""
    v_l = torch.clamp(torch.abs(v_sin_i), min=1e-5)
    v = torch.arange(-half, half + 1, dtype=v_l.dtype, device=v_l.device) * vel_pix
    q = 1.0 - (v / v_l) ** 2
    inside = q > 0.0
    q = torch.where(inside, q, torch.zeros_like(q))
    root = torch.sqrt(torch.where(inside, q, torch.ones_like(q))) * inside
    profile = 2.0 * (1.0 - epsilon) * root + 0.5 * np.pi * epsilon * q
    return profile / profile.sum()


def gaussian_kernel(sigma, radius):
    """A Gaussian of standard deviation ``sigma`` pixels (0-d tensor) at
    2 radius + 1 pixels, normalised to unit sum."""
    s = torch.clamp(torch.abs(sigma), min=1e-6)
    x = torch.arange(-radius, radius + 1, dtype=s.dtype, device=s.device)
    w = torch.exp(-0.5 * (x / s) ** 2)
    return w / w.sum()


def convolve_reflect(flux, kernel):
    """sum_j kernel[j] flux[i + half - j] for each pixel i of flux [N], the
    flux beyond either end mirrored with its edge sample repeated; the
    kernel has 2 half + 1 taps."""
    n, half = flux.shape[0], (kernel.shape[0] - 1) // 2
    index = torch.as_tensor(np.pad(np.arange(n), half, mode="symmetric"), device=flux.device)
    padded = flux[index]
    out = torch.zeros_like(flux)
    for j in range(kernel.shape[0]):
        out = out + kernel[j] * padded[2 * half - j:2 * half - j + n]
    return out


def model_spectrum(surface, v_sin_i, sigma, vel_pix, half, radius):
    """The fit's model: the surface F_nu [N] broadened by rotation, then by
    the instrument, over its mean."""
    broad = convolve_reflect(surface, rotation_kernel(vel_pix, v_sin_i, half))
    broad = convolve_reflect(broad, gaussian_kernel(sigma, radius))
    return broad / broad.mean()


def surface_flux(ref, model, held=None):
    """The surface F_nu of ``model`` over the whole grid [N] (float64 host
    array, computed in ``ref``'s precision) and its windows {line set: iw};
    with ``held``, those windows in place of the model's own."""
    own, used = ref.windows, {}

    def windows(quants):
        out = own(quants)
        if held is not None:
            out = {key: (*triple[:3], held[key]) for key, triple in out.items()}
        used.update({key: triple[3] for key, triple in out.items()})
        return out

    ref.windows = windows
    try:
        flux = ref.surface_flux([model], np.arange(ref.consts.grid.shape[0]))[0]
    finally:
        del ref.windows
    return flux, used


def scaled_model(ref, path, t_scale):
    """The model in ``path`` with its temperatures times ``t_scale`` and
    its densities over it."""
    model = ref.model(path, t_scale)
    model.composition.density = model.composition.density / float(t_scale)
    return model


def step(ref, path, params, observed, vel_pix, half, radius, fd_step):
    """What one step of a fit computes at ``params`` = (s, v sin i, sigma),
    in ``ref``'s precision: (the model spectrum [N], the gradient of the
    mean-squared loss against ``observed`` [N] in (s, v sin i, sigma), and
    ``vjp``: a cotangent [N] -> the model's Jacobian transposed, applied
    to it, [3]).  Host float64 arrays."""
    s, v_sin_i, sigma = (float(p) for p in params)
    dtype, device = ref.dtype, ref.device

    def tensor(x, grad=False):
        return torch.tensor(np.asarray(x, dtype=np.float64), device=device).to(
            dtype).requires_grad_(grad)

    centre, windows = surface_flux(ref, scaled_model(ref, path, s))
    up, _ = surface_flux(ref, scaled_model(ref, path, s + fd_step), windows)
    down, _ = surface_flux(ref, scaled_model(ref, path, s - fd_step), windows)
    v, sg, obs = tensor(v_sin_i, True), tensor(sigma, True), tensor(observed)
    model = model_spectrum(tensor(centre), v, sg, vel_pix, half, radius)
    with torch.no_grad():
        m_up = model_spectrum(tensor(up), v, sg, vel_pix, half, radius)
        m_down = model_spectrum(tensor(down), v, sg, vel_pix, half, radius)

    def grads(scalar):
        """[d/ds, d/dv sin i, d/dsigma] of scalar(model)."""
        g_v, g_sigma = torch.autograd.grad(scalar(model), (v, sg), retain_graph=True)
        with torch.no_grad():
            g_s = (float(scalar(m_up)) - float(scalar(m_down))) / (2.0 * fd_step)
        return np.array([g_s, float(g_v), float(g_sigma)])

    def vjp(cotangent):
        weights = tensor(cotangent)
        return grads(lambda m: torch.sum(weights * m))

    gradient = grads(lambda m: torch.mean((m - obs) ** 2))
    return model.detach().double().cpu().numpy(), gradient, vjp


def model_at(ref, path, params, vel_pix, half, radius):
    """The fit's model spectrum [N] of the model in ``path`` at ``params``
    = (s, v sin i, sigma), in ``ref``'s precision: a host float64 array."""
    s, v_sin_i, sigma = (float(p) for p in params)
    flux, _ = surface_flux(ref, scaled_model(ref, path, s))

    def tensor(x):
        return torch.tensor(np.asarray(x, dtype=np.float64), device=ref.device).to(ref.dtype)

    with torch.no_grad():
        model = model_spectrum(tensor(flux), tensor(v_sin_i), tensor(sigma), vel_pix, half,
                               radius)
    return model.double().cpu().numpy()


def line_gradients(ref, model, kappa, pick):
    """Kernel 1b's outputs as the reference has them, for ``model``: for
    each line set ``key`` of ``kappa`` ({key: a gradient with respect to
    that set's line opacity, [D, N]}), the gradients of sum(kappa * line
    sum) with respect to alpha, gamma and doppler of the lines ``pick(key,
    reach)`` (indices; ``reach`` [L] marks the lines whose window holds a
    pixel of the grid at some depth), each [len, D]: autograd through
    ``spectrum.line_sum_at`` at the reference's own line quantities and
    windows, in ``ref``'s precision, a chunk of lines at a time.  Host
    float64 arrays {key: (alpha's, gamma's, doppler's)}."""
    _state, quants = ref.stage1([model])
    grid = ref.consts.grid
    n_nu = grid.shape[0]
    pixels = torch.arange(n_nu, device=ref.device)
    out = {}
    for key, (alpha, gamma, doppler, iw) in ref.windows(quants).items():
        if key not in kappa:
            continue
        line_nu, centers = ref.consts.lines[key]
        widest = iw[0].amax(dim=1).to(torch.int64)
        reach = ((widest > 0) & (centers - widest < n_nu) & (centers + widest > 0)).cpu().numpy()
        index = torch.as_tensor(np.asarray(pick(key, reach), dtype=np.int64), device=ref.device)
        weights = torch.as_tensor(np.asarray(kappa[key], dtype=np.float64),
                                  device=ref.device).to(ref.dtype)
        per_chunk = max(1, spectrum.CHUNK_ELEMENTS // (alpha.shape[-1] * n_nu))
        parts = []
        for c0 in range(0, len(index), per_chunk):
            lines = index[c0:c0 + per_chunk]
            leaves = [x[:, lines].detach().clone().requires_grad_()
                      for x in (alpha, gamma, doppler)]
            total = spectrum.line_sum_at(grid, line_nu[lines], centers[lines], *leaves,
                                         iw[:, lines], pixels)
            grads = torch.autograd.grad(torch.sum(weights * total[0]), leaves, allow_unused=True)
            parts.append([torch.zeros_like(x[0]) if g is None else g[0]
                          for g, x in zip(grads, leaves)])
        out[key] = tuple(torch.cat([p[i] for p in parts]).double().cpu().numpy()
                         if parts else np.zeros((0, alpha.shape[-1])) for i in range(3))
    return out
