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


# ----------------------------------------------------------------------
# derivatives of the w4 regions (the backward of the line sum)
#
# Each region is an analytic function of z = x + iy (regions I, II) or of
# t = y - ix = -iz (III, IV), so with W = dw/dz:
#     d Re w / dx = Re W,   d Re w / dy = -Im W,
# and dw/dz = -i dw/dt.  These are the derivatives of the rational formulas
# that faddeeva_real selects, not of the true Faddeeva function: the
# identity w' = -2zw + 2i/sqrt(pi) holds only for the latter and would miss
# the approximation's own derivative by its error (~1e-4).
# ----------------------------------------------------------------------


def _horner_d(coeffs, vr, vi, like):
    """P(v) and P'(v) by Horner; P rounds as ``_horner``'s."""
    pr = torch.full_like(like, coeffs[0])
    pi_ = torch.zeros_like(like)
    dr, di = torch.zeros_like(like), torch.zeros_like(like)
    for c in coeffs[1:]:
        dr, di = _cmul(dr, di, vr, vi)
        dr, di = dr + pr, di + pi_
        pr, pi_ = _cmul(pr, pi_, vr, vi)
        pr = pr + c
    return pr, pi_, dr, di


def _region1_grad(x, y, z2r, z2i):
    """(Re w, W) of region I: w = (i/sqrt(pi)) z / (z^2 - 0.5),
    W = -(i/sqrt(pi)) (z^2 + 0.5) / (z^2 - 0.5)^2."""
    ar, ai = z2r - 0.5, z2i
    d = ar * ar + ai * ai
    re = ((-y / SQRT_PI) * ar + (x / SQRT_PI) * ai) / d
    cr, ci = _cmul(ar, -ai, ar, -ai)  # conj(z^2 - 0.5)^2
    mr, mi = _cmul(z2r + 0.5, z2i, cr, ci)
    s = SQRT_PI * d * d
    return re, mi / s, -mr / s


def faddeeva_real_region1_grad(x, y):
    """(Re w, d Re w/dx, d Re w/dy) of the region-I rational: the
    derivative of ``faddeeva_real_region1``."""
    z2r, z2i = _cmul(x, y, x, y)
    re, wr, wi = _region1_grad(x, y, z2r, z2i)
    return re, wr, -wi


def faddeeva_real_grad(x, y):
    """(Re w, d Re w/dx, d Re w/dy) of the w4 region that ``faddeeva_real``
    selects at each (x, y) (branchless; the unselected regions' values are
    discarded by the selection, never multiplied into a result)."""
    tr, ti = y, -x
    ur, ui = _cmul(tr, ti, tr, ti)
    s = torch.abs(x) + y
    z2r, z2i = _cmul(x, y, x, y)

    # region I
    re1, w1r, w1i = _region1_grad(x, y, z2r, z2i)

    # region II: w = N/D, N = i (z^3/sqrt(pi) - K z), D = 0.75 + z^2 (z^2 - 3);
    # W = (N' - w D') / D, N' = i (3 z^2/sqrt(pi) - K), D' = 2 z (2 z^2 - 3)
    k2 = 1.4104739589
    ar, ai = z2r / SQRT_PI - k2, z2i / SQRT_PI
    nr, ni = _cmul(x, y, ar, ai)
    nr, ni = -ni, nr
    dr, di = _cmul(z2r, z2i, z2r - 3.0, z2i)
    dr = 0.75 + dr
    re2, im2 = _cdiv(nr, ni, dr, di)
    npr, npi = -(3.0 * z2i / SQRT_PI), 3.0 * z2r / SQRT_PI - k2
    dpr, dpi = _cmul(2.0 * x, 2.0 * y, 2.0 * z2r - 3.0, 2.0 * z2i)
    er, ei = _cmul(re2, im2, dpr, dpi)
    w2r, w2i = _cdiv(npr - er, npi - ei, dr, di)

    # region III: w = P(t)/Q(t); dw/dt = (P' - w Q') / Q
    p3r, p3i, dp3r, dp3i = _horner_d(REGION3_P, tr, ti, x)
    q3r, q3i, dq3r, dq3i = _horner_d(REGION3_Q, tr, ti, x)
    re3, im3 = _cdiv(p3r, p3i, q3r, q3i)
    er, ei = _cmul(re3, im3, dq3r, dq3i)
    t3r, t3i = _cdiv(dp3r - er, dp3i - ei, q3r, q3i)

    # region IV: w = exp(u) - t r(u), r = P/Q;
    # dw/dt = 2 t exp(u) - r - 2 u r',  r' = (P' - r Q') / Q
    p4r, p4i, dp4r, dp4i = _horner_d(REGION4_P, ur, ui, x)
    p4r, p4i, dp4r, dp4i = -p4r, -p4i, -dp4r, -dp4i
    nr4, ni4 = _cmul(tr, ti, p4r, p4i)
    q4r, q4i, dq4r, dq4i = _horner_d(REGION4_Q, ur, ui, x)
    fr, _ = _cdiv(nr4, ni4, q4r, q4i)
    mag = torch.exp(torch.clamp(ur, max=60.0))
    er, ei = mag * torch.cos(ui), mag * torch.sin(ui)
    re4 = er - fr
    rr, ri = _cdiv(p4r, p4i, q4r, q4i)
    cr, ci = _cmul(rr, ri, dq4r, dq4i)
    drr, dri = _cdiv(dp4r - cr, dp4i - ci, q4r, q4i)
    ar, ai = _cmul(2.0 * tr, 2.0 * ti, er, ei)
    br, bi = _cmul(2.0 * ur, 2.0 * ui, drr, dri)
    t4r, t4i = ar - rr - br, ai - ri - bi

    in_i = s > 15.0
    in_ii = ~in_i & (s > 5.5)
    in_iii = ~in_i & ~in_ii & (y >= 0.195 * torch.abs(x) - 0.176)

    def pick(v1, v2, v3, v4):
        return torch.where(in_i, v1, torch.where(in_ii, v2, torch.where(in_iii, v3, v4)))

    # d/dx = Re W = Im(dw/dt), d/dy = -Im W = Re(dw/dt) for regions III, IV
    return (pick(re1, re2, re3, re4), pick(w1r, w2r, t3i, t4i),
            pick(-w1i, -w2i, t3r, t4r))


def voigt_profile_region1(delta_nu, doppler_width, gamma):
    """Reference-convention Voigt via the region-I formula."""
    x = delta_nu / doppler_width
    y = gamma / (SQRT_PI * PI) / doppler_width
    return faddeeva_real_region1(x, y) / (SQRT_PI * doppler_width)


def voigt_profile(delta_nu, doppler_width, gamma):
    """Reference-convention Voigt profile; phi(0, 1, 0) = 1/sqrt(pi)."""
    x = delta_nu / doppler_width
    y = gamma / (SQRT_PI * PI) / doppler_width
    return faddeeva_real(x, y) / (SQRT_PI * doppler_width)
