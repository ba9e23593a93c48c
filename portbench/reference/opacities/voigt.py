# Frozen copy of stardis_tpu_torch/opacities/voigt.py at commit 9c7d618,
# trimmed to what the benchmark reaches: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""Voigt profile via the Humlicek (1982) w4 rational approximation (PyTorch).

The plain torch port of ``stardis_tpu/opacities/voigt.py``, with the same
4-region Faddeeva evaluation and Voigt convention:

    z   = (delta_nu + i gamma / (sqrt(pi) * pi)) / doppler_width
    phi = Re[w(z)] / (sqrt(pi) * doppler_width)

Complex arithmetic is carried as explicit (re, im) pairs and all four
regions are evaluated branchlessly, selected with torch.where.  This is the
plain version that the CUDA line kernel (csrc/line_opacity.cu) reproduces
with a per-element branch.
"""

from __future__ import annotations

import numpy as np
import torch

SQRT_PI = float(np.sqrt(np.pi))
PI = float(np.pi)

# Humlicek region III: P(t)/Q(t), Horner coefficients from the top degree
REGION3_P = (0.5642236, 3.778987, 11.96482, 20.20933, 16.4955)
REGION3_Q = (1.0, 6.699398, 21.69274, 39.27121, 38.82363, 16.4955)
# Humlicek region IV: w = exp(u) - t P(u)/Q(u), u = t^2; the alternating
# nesting of the published form is folded into the coefficient signs and P
# is negated after the Horner pass
REGION4_P = (-0.56419, 1.320522, -35.7668, 219.031, -1540.787, 3321.99, -36183.31)
REGION4_Q = (-1.0, 1.84144, -61.5704, 364.219, -2186.18, 9022.23, -24322.8, 32066.6)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _horner(coeffs, vr, vi, like):
    pr = torch.full_like(like, coeffs[0])
    pi_ = torch.zeros_like(like)
    for c in coeffs[1:]:
        pr, pi_ = _cmul(pr, pi_, vr, vi)
        pr = pr + c
    return pr, pi_


def faddeeva_real(x, y):
    """Re[w(x + iy)] for y >= 0, Humlicek w4 regions (branchless)."""
    # t = y - i x ;  u = t^2 ;  s = |x| + y
    tr, ti = y, -x
    ur, ui = _cmul(tr, ti, tr, ti)
    s = torch.abs(x) + y

    zr, zi = x, y
    z2r, z2i = _cmul(zr, zi, zr, zi)

    # --- Region I: w = (i/sqrt(pi)) * z / (z^2 - 0.5)
    n1r, n1i = -zi / SQRT_PI, zr / SQRT_PI
    w1r, _ = _cdiv(n1r, n1i, z2r - 0.5, z2i)

    # --- Region II: w = i z (z^2/sqrt(pi) - 1.4104739589) / (0.75 + z^2 (z^2 - 3))
    ar, ai = z2r / SQRT_PI - 1.4104739589, z2i / SQRT_PI
    nr, ni = _cmul(zr, zi, ar, ai)
    nr, ni = -ni, nr  # multiply by i
    dr, di = _cmul(z2r, z2i, z2r - 3.0, z2i)
    w2r, _ = _cdiv(nr, ni, 0.75 + dr, di)

    # --- Region III: rational P(t)/Q(t)
    p3r, p3i = _horner(REGION3_P, tr, ti, x)
    q3r, q3i = _horner(REGION3_Q, tr, ti, x)
    w3r, _ = _cdiv(p3r, p3i, q3r, q3i)

    # --- Region IV: w = exp(u) - t P(u)/Q(u)
    p4r, p4i = _horner(REGION4_P, ur, ui, x)
    p4r, p4i = -p4r, -p4i
    nr4, ni4 = _cmul(tr, ti, p4r, p4i)
    q4r, q4i = _horner(REGION4_Q, ur, ui, x)
    fr, _ = _cdiv(nr4, ni4, q4r, q4i)
    # exp(u) clamped: region IV has ur <= ~33; the clamp only touches inputs
    # that another region is selected for
    w4r = torch.exp(torch.clamp(ur, max=60.0)) * torch.cos(ui) - fr

    in_i = s > 15.0
    in_ii = ~in_i & (s > 5.5)
    in_iii = ~in_i & ~in_ii & (y >= 0.195 * torch.abs(x) - 0.176)
    return torch.where(
        in_i, w1r, torch.where(in_ii, w2r, torch.where(in_iii, w3r, w4r))
    )


def faddeeva_real_region1(x, y):
    """Re[w(x + iy)] via the region-I rational only; exact where
    s = |x| + y > 15, the points where faddeeva_real selects it too."""
    z2r, z2i = _cmul(x, y, x, y)
    n1r, n1i = -y / SQRT_PI, x / SQRT_PI
    w1r, _ = _cdiv(n1r, n1i, z2r - 0.5, z2i)
    return w1r


def voigt_profile(delta_nu, doppler_width, gamma):
    """Reference-convention Voigt profile; phi(0, 1, 0) = 1/sqrt(pi)."""
    x = delta_nu / doppler_width
    y = gamma / (SQRT_PI * PI) / doppler_width
    return faddeeva_real(x, y) / (SQRT_PI * doppler_width)
