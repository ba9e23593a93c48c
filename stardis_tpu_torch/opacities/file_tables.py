"""Tabulated cross-section files (host-side NumPy).

The port of ``stardis_tpu/opacities/file_tables.py`` for the three formats
the reference reads, parsed without pandas:

* ``H2plus_bf``  — Stancil 1994: wavelength [nm] x T table; values such as
                   ``7.34-5`` carry an implicit exponent; scale 1e-18 cm^2.
* ``Hminus_ff``  — Bell & Berrington 1987: wavelength [AA] x theta = 5040/T
                   table whose header tokens end in commas; scale
                   1e-26 k_B T.
* ``Hminus_bf``  — Wishart 1979: two-column wavelength [AA], sigma [cm^2]
                   CSV.

The tables are interpolated onto (depth temperature x wavelength) once per
plan; the device multiplies by the species number density
(``continuum.calc_alpha_file``).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ..constants import K_B_CGS

logger = logging.getLogger(__name__)


def _interp2d_linear(x_tab, y_tab, values, x_query, y_query):
    """Bilinear interpolation on a rectilinear grid, 0 outside it."""
    from scipy.interpolate import RegularGridInterpolator

    interp = RegularGridInterpolator(
        (np.asarray(x_tab, dtype=float), np.asarray(y_tab, dtype=float)),
        values,
        bounds_error=False,
        fill_value=0.0,
    )
    shape = np.broadcast_shapes(x_query.shape, y_query.shape)
    pts = np.stack(
        [np.broadcast_to(x_query, shape), np.broadcast_to(y_query, shape)], axis=-1
    )
    return interp(pts)


def _rows(fpath, sep=None):
    """Non-empty rows of tokens, with everything from '#' on dropped."""
    rows = []
    for line in Path(fpath).read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            rows.append([tok.strip() for tok in line.split(sep)])
    return rows


def _is_number(token):
    try:
        float(token)
    except ValueError:
        return False
    return True


def _stancil_column(tokens):
    """One table column as floats; a column with any token that does not
    parse reads every '-' as 'e-' (the implicit exponent of '7.34-5')."""
    if all(_is_number(t) for t in tokens):
        return [float(t) for t in tokens]
    return [float(t.replace("-", "e-")) for t in tokens]


def sigma_file(tracing_lambdas, temperatures, fpath, opacity_source):
    """sigma [n_depth, n_lambda] for a tabulated opacity source."""
    lambdas = np.asarray(tracing_lambdas, dtype=float)
    temps = np.asarray(temperatures, dtype=float)

    if opacity_source == "H2plus_bf":
        header, *body = _rows(fpath)
        wave_aa = np.array([float(r[0]) for r in body]) * 10.0  # nm -> AA
        file_temps = np.array([float(t) for t in header[1:]])
        table = np.array(
            [_stancil_column([r[j] for r in body]) for j in range(1, len(header))]
        ).T
        sig = _interp2d_linear(
            wave_aa, file_temps, table, lambdas[None, :], temps[:, None]
        ) * 1e-18
        if np.any(sig == 0):
            logger.warning(
                "H2+ bf: outside interpolation range at some depth points; "
                "assuming 0 opacity there."
            )
        return sig

    if opacity_source == "Hminus_ff":
        header, *body = _rows(fpath)
        thetas = np.array([float(t.strip(",")) for t in header[1:]])
        data = np.array([[float(t) for t in r] for r in body])
        sig = _interp2d_linear(
            data[:, 0], thetas, data[:, 1:], lambdas[None, :], (5040.0 / temps)[:, None]
        )
        sig = sig * 1e-26 * K_B_CGS * temps[:, None]
        if np.any(sig == 0):
            logger.warning(
                "H- ff: outside interpolation range at some depth points; "
                "assuming 0 opacity there."
            )
        return sig

    if opacity_source == "Hminus_bf":
        data = np.array([[float(t) for t in r] for r in _rows(fpath, sep=",")])
        sig_1d = np.interp(lambdas, data[:, 0], data[:, 1])
        return np.broadcast_to(sig_1d, (len(temps), len(lambdas))).copy()

    raise ValueError(f"Unknown opacity_source: {opacity_source}")


# ----------------------------------------------------------------------
# John 1988 analytic H- fits (no data file needed).  As in the JAX
# package, ``opacity.file`` does not reach them (ROADMAP.md Queue 3).
# ----------------------------------------------------------------------

_JOHN88_BF_C = np.array(
    [152.519, 49.534, -118.858, 92.536, -34.194, 4.982]
)


def john88_hminus_bf_sigma(lambda_aa):
    """H- bound-free cross-section [cm^2 per H- ion], John 1988 eq. 4-5.

    Valid 1250 AA < lambda < 16419 AA (the photodetachment threshold); 0
    outside.
    """
    lam_um = np.asarray(lambda_aa, dtype=float) / 1e4
    lam0 = 1.6419  # um, threshold
    x = np.clip(1.0 / lam_um - 1.0 / lam0, 0.0, None)
    f = np.zeros_like(lam_um)
    sqrt_x = np.sqrt(x)
    for n, c in enumerate(_JOHN88_BF_C, start=1):
        f = f + c * sqrt_x ** (n - 1)
    sigma = 1e-18 * lam_um**3 * x**1.5 * f
    return np.where((lam_um > 0.125) & (lam_um < lam0), sigma, 0.0)


_JOHN88_FF_TABLE_HIGH = np.array(
    # lambda > 0.3645 um coefficients A_n..F_n for n=1..6 (John 1988 table 3a)
    [
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [2483.346, 285.827, -2054.291, 2827.776, -1341.537, 208.952],
        [-3449.889, -1158.382, 8746.523, -11485.632, 5303.609, -812.939],
        [2200.040, 2427.719, -13651.105, 16755.524, -7510.494, 1132.738],
        [-696.271, -1841.400, 8624.970, -10051.530, 4400.067, -655.020],
        [88.283, 444.517, -1863.864, 2095.288, -901.788, 132.985],
    ]
)


def john88_hminus_ff_sigma(lambda_aa, temperature):
    """H- free-free 'cross-section' [cm^4/dyn], [T, lambda]: kappa / (n(HI)
    n_e k_B T), the Bell & Berrington table convention the reference uses
    (multiply by n(HI) n_e k_B T for alpha in 1/cm).  John 1988 eq. 6.
    Valid lambda > 3645 AA, 1400 K < T < 10080 K; clipped at 0.
    """
    lam_um = np.atleast_1d(np.asarray(lambda_aa, dtype=float)) / 1e4
    t = np.atleast_1d(np.asarray(temperature, dtype=float))[:, None]
    theta = 5040.0 / t
    kappa = np.zeros((t.shape[0], lam_um.shape[0]))
    for n in range(1, 7):
        a, b, c, d, e, f = _JOHN88_FF_TABLE_HIGH[n - 1]
        kappa = kappa + theta ** ((n + 1) / 2.0) * (
            lam_um**2 * a
            + b
            + c / lam_um
            + d / lam_um**2
            + e / lam_um**3
            + f / lam_um**4
        )
    # John's formula gives kappa in cm^4/dyn once scaled by 1e-29
    return np.clip(kappa * 1e-29, 0.0, None)
