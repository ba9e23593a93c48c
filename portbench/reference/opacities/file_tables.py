# Frozen copy of stardis_tpu_torch/opacities/file_tables.py at commit 9c7d618,
# trimmed to what the benchmark reaches: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
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


