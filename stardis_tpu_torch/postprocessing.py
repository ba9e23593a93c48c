"""Post-processing: rotational and instrumental broadening (PyTorch).

The port of ``stardis_tpu/postprocessing.py``, in two tiers:

* host NumPy/SciPy functions (``rotation_broadening``,
  ``instrumental_broadening``): Gray's rotational kernel with linear limb
  darkening convolved by ``scipy.ndimage.convolve1d``, and
  ``gaussian_filter1d``; Quantity in and out;
* torch functions (``rotation_kernel_torch``, ``rotation_broadening_torch``,
  ``gaussian_kernel_torch``, ``instrumental_broadening_torch``) on the
  device of the flux, differentiable with respect to the flux, v sin i,
  the limb darkening and sigma, so a spectral fit can take its gradient
  through the broadening (``loss.backward()`` after the pipeline's
  stages).  The kernel support is a static size; Gray's profile is exactly
  zero beyond |v| >= v sin i, so any support >= v_rot / vel_pix gives the
  host result after normalisation.

The convolution runs under scipy.ndimage's default 'reflect' boundary
(the edge sample repeated, numpy's "symmetric" padding, built by flip and
concatenate: torch's own "reflect" padding does not repeat the edge), as
a product of the padded flux's sliding windows with the kernel, in full
float32 and with a backward that is equal run to run.
"""

from __future__ import annotations

import numpy as np
import torch

from . import units as u
from .constants import C_KMS
from .util.matmul import full_float32_matmul


def rotation_broadening(velocity_per_pix, wavelength, flux, v_rot=None, limb_darkening=0.6):
    """Convolve a spectrum with Gray's rotational profile (host).

    velocity_per_pix : Quantity [km/s] or number, the velocity width of one
        pixel (the profile is only right where it is constant)
    wavelength : Quantity [AA]; flux : array or Quantity, F_lambda
    v_rot : Quantity [km/s] or number, v sin i (|v sin i| < 1e-5 returns
        the flux unchanged; a negative value acts as its magnitude)
    returns (wavelength, broadened Quantity [erg/s/cm^2/AA])
    """
    vel_pix = (velocity_per_pix.to(u.km / u.s).value if hasattr(velocity_per_pix, "to")
               else float(velocity_per_pix))
    if v_rot is None:
        v_rot_kms = 0.0
    else:
        v_rot_kms = v_rot.to(u.km / u.s).value if hasattr(v_rot, "to") else float(v_rot)
    flux_vals = np.asarray(flux, dtype=float)
    unit = u.erg / u.s / u.cm**2 / u.AA
    if np.abs(v_rot_kms) < 1e-5:
        return wavelength, u.Quantity(flux_vals, unit)

    v_rot_by_c = max(1e-5, abs(v_rot_kms)) / C_KMS
    half_width_pix = int(round(abs(v_rot_kms) / abs(vel_pix)))
    profile_velocity = (np.linspace(-half_width_pix, half_width_pix, 2 * half_width_pix + 1)
                        * vel_pix)
    profile = np.maximum(0.0, 1.0 - (profile_velocity / v_rot_kms) ** 2)
    rotational_profile = (
        2.0 * (1.0 - limb_darkening) * np.sqrt(profile)
        + 0.5 * np.pi * limb_darkening * profile
    ) / (np.pi * v_rot_by_c * (1.0 - limb_darkening / 3.0))
    kernel = rotational_profile / rotational_profile.sum()
    from scipy.ndimage import convolve1d

    return wavelength, u.Quantity(convolve1d(flux_vals, kernel), unit)


def instrumental_broadening(wavelength, flux, resolution=None, sigma_aa=None):
    """Gaussian instrumental broadening (host) on a uniform wavelength
    grid, by a resolving power R = lambda / dlambda (FWHM) or a Gaussian
    sigma in Angstroms."""
    lam = np.asarray(wavelength, dtype=float)
    flux_vals = np.asarray(flux, dtype=float)
    dlam = np.diff(lam)
    if not np.allclose(dlam, dlam[0], rtol=1e-6):
        raise ValueError("instrumental_broadening requires a uniform grid")
    if sigma_aa is None:
        if resolution is None:
            raise ValueError("give either resolution or sigma_aa")
        fwhm = np.mean(lam) / resolution
        sigma_aa = fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    sigma_pix = sigma_aa / abs(dlam[0])
    from scipy.ndimage import gaussian_filter1d

    return wavelength, u.Quantity(gaussian_filter1d(flux_vals, sigma_pix),
                                  u.erg / u.s / u.cm**2 / u.AA)


def _symmetric_pad(flux, half):
    """numpy's "symmetric" padding of a 1-D tensor: the edge sample is
    repeated (scipy.ndimage's 'reflect')."""
    n = flux.shape[0]
    if half <= n:
        return torch.cat([flux[:half].flip(0), flux, flux[n - half:].flip(0)])
    index = np.pad(np.arange(n), half, mode="symmetric")
    return flux[torch.as_tensor(index, device=flux.device)]


def _reflect_convolve(flux, kernel, half: int):
    """Convolve with a centred odd kernel (2 half + 1 taps) under the
    'reflect' boundary, as jnp.convolve on the padded flux: each output is
    the dot product of its window of the padded flux (a strided view)
    with the flipped kernel, a matrix-vector product in full float32.  Its
    backward (the product's transpose and ``unfold``'s gather) adds in a
    fixed order, so gradients are equal run to run; cuDNN's conv1d picks
    its backward algorithms outside any scope the forward could set."""
    if half == 0:
        return flux * kernel[0]
    windows = _symmetric_pad(flux, half).unfold(0, 2 * half + 1, 1)  # [N, 2 half + 1]
    return full_float32_matmul(windows, kernel.flip(0))


def _scalar(x, like):
    """A number or 0-d tensor as a tensor of ``like``'s dtype and device (a
    tensor keeps its autograd graph)."""
    if torch.is_tensor(x):
        return x.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def rotation_kernel_torch(vel_pix, v_rot_kms, half_width_pix: int, limb_darkening=0.6,
                          dtype=torch.float64, device="cpu"):
    """Gray's rotational kernel on a static support of 2 half_width_pix + 1
    pixels, normalised; differentiable in v_rot_kms and limb_darkening.

    |v sin i| is clamped below at 1e-5 km/s (the host function's identity
    threshold), so v_rot -> 0 gives an exact delta (the flux unchanged,
    zero gradient) instead of 0/0; the sqrt at the profile's zero crossing
    is guarded so the gradient stays finite."""
    like = torch.empty(0, dtype=dtype, device=device)
    v_rot_safe = torch.clamp(torch.abs(_scalar(v_rot_kms, like)), min=1e-5)
    i = torch.arange(-half_width_pix, half_width_pix + 1, dtype=dtype, device=device)
    v = i * vel_pix
    profile = 1.0 - (v / v_rot_safe) ** 2
    pos = profile > 0.0
    sqrt_prof = torch.where(pos, torch.sqrt(torch.where(pos, profile, 1.0)), 0.0)
    profile = torch.where(pos, profile, 0.0)
    v_rot_by_c = v_rot_safe / C_KMS
    ld = _scalar(limb_darkening, like)
    kern = (
        2.0 * (1.0 - ld) * sqrt_prof + 0.5 * np.pi * ld * profile
    ) / (np.pi * v_rot_by_c * (1.0 - ld / 3.0))
    return kern / torch.sum(kern)


def rotation_broadening_torch(vel_pix, flux, v_rot_kms, limb_darkening=0.6,
                              half_width_pix: int | None = None):
    """Rotational broadening of flux [N] (F_lambda on a constant-velocity
    grid) on its device, differentiable in flux, v_rot_kms and
    limb_darkening.

    vel_pix : velocity width of one pixel [km/s]
    half_width_pix : static kernel half-support; needed when v_rot_kms
        changes between calls (a fit), and then at least v_rot / vel_pix
        for every v_rot the fit explores.  Default round(|v_rot| / vel_pix),
        the host kernel's support."""
    if half_width_pix is None:
        half_width_pix = int(round(abs(float(v_rot_kms)) / abs(float(vel_pix))))
    kern = rotation_kernel_torch(vel_pix, v_rot_kms, half_width_pix, limb_darkening,
                                 dtype=flux.dtype, device=flux.device)
    return _reflect_convolve(flux, kern, half_width_pix)


def gaussian_kernel_torch(sigma_pix, radius_pix: int, dtype=torch.float64, device="cpu"):
    """Normalised Gaussian kernel on a static support (differentiable in
    sigma_pix); scipy's gaussian_filter1d kernel for radius_pix =
    int(4 sigma + 0.5).  |sigma| is clamped below at 1e-6 px, so sigma = 0
    is an exact delta."""
    like = torch.empty(0, dtype=dtype, device=device)
    sigma_safe = torch.clamp(torch.abs(_scalar(sigma_pix, like)), min=1e-6)
    x = torch.arange(-radius_pix, radius_pix + 1, dtype=dtype, device=device)
    phi = torch.exp(-0.5 * (x / sigma_safe) ** 2)
    return phi / torch.sum(phi)


def instrumental_broadening_torch(flux, sigma_pix, radius_pix: int | None = None):
    """Gaussian instrumental broadening of flux [N] on its device,
    differentiable in flux and sigma_pix [pixels]; radius_pix (static)
    defaults to scipy's int(4 sigma + 0.5) and is needed when sigma changes
    between calls."""
    if radius_pix is None:
        radius_pix = int(4.0 * abs(float(sigma_pix)) + 0.5)
    kern = gaussian_kernel_torch(sigma_pix, radius_pix, dtype=flux.dtype, device=flux.device)
    return _reflect_convolve(flux, kern, radius_pix)
