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

The reference interpolates a table bilinearly at every (depth temperature,
wavelength) point, 0 outside the table.  Bilinear weights on a rectilinear
grid are the product of the two 1-D weights, so a ``FileTable`` is read
and interpolated in wavelength once per plan: ``g`` [K, N], one row per
tabulated temperature (or theta).  A model's sigma is then, per depth, a
weight between two rows of ``g`` and a factor (``FileSigmaRows``): the
device expands it (``continuum.calc_alpha_file_rows``), and ``dense`` does
the same arithmetic on the host (``sigma_file``).
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import numpy as np

from ..constants import K_B_CGS

logger = logging.getLogger(__name__)

#: the warning each 2-D format gives where its sigma is 0 somewhere
_OUTSIDE = {
    "H2plus_bf": "H2+ bf: outside interpolation range at some depth points; "
                 "assuming 0 opacity there.",
    "Hminus_ff": "H- ff: outside interpolation range at some depth points; "
                 "assuming 0 opacity there.",
}


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


def _ascending(axis, values, dim):
    """``axis`` ascending, ``values`` flipped along ``dim`` to match (scipy's
    ``RegularGridInterpolator`` takes descending axes too)."""
    axis = np.asarray(axis, dtype=np.float64)
    if len(axis) > 1 and axis[0] > axis[-1]:
        axis, values = axis[::-1], np.flip(values, dim)
    if not np.all(np.diff(axis) > 0):
        raise ValueError("a cross-section table's axis must be strictly monotonic")
    return axis, values


def _bracket(axis, x):
    """scipy's linear interval and weight on an ascending ``axis``: (i, w,
    inside) with axis[i] <= x < axis[i + 1] (the last interval at x ==
    axis[-1]), w = (x - axis[i]) / (axis[i + 1] - axis[i]); where x lies
    outside the axis, i = 0, w = 0 and inside is False."""
    inside = (x >= axis[0]) & (x <= axis[-1])
    i = np.clip(np.searchsorted(axis, x, side="right") - 1, 0, len(axis) - 2)
    w = (x - axis[i]) / (axis[i + 1] - axis[i])
    return np.where(inside, i, 0), np.where(inside, w, 0.0), inside


@dataclasses.dataclass(eq=False)
class FileTable:
    """One ``opacity.file`` table, read once and interpolated in wavelength
    onto a plan's tracing grid (``read_file_table``).

    g : [K, N] float64, the table at each of its K temperatures (H2plus_bf)
        or thetas = 5040 / T (Hminus_ff) at the N tracing wavelengths, 0
        where a wavelength lies outside the table (bilinear weights
        factorise); Hminus_bf depends on the wavelength alone: K = 1, the
        Wishart curve by ``np.interp``
    axis : [K] the temperatures or thetas, ascending; None for Hminus_bf
    """

    name: str
    g: np.ndarray
    axis: np.ndarray | None

    def __post_init__(self):
        # where a row or a pair of neighbouring rows holds a 0, for the
        # warning (the tables are non-negative)
        zero = self.g == 0
        self._zero_row = zero.any(axis=1)
        self._zero_pair = (zero[:-1] & zero[1:]).any(axis=1)

    def rows_at(self, temperatures) -> FileSigmaRows:
        """The table's sigma at ``temperatures`` [..., D] (float64 on the
        host), not expanded: per depth the bracketing rows of ``g``, the
        weight between them and the format's factor, 0 where the
        temperature (or theta) lies outside the table.  Warns as the
        reference does where the expanded sigma would hold a 0."""
        temps = np.asarray(temperatures, dtype=np.float64)
        if self.axis is None:  # Hminus_bf
            zeros = np.zeros(temps.shape)
            return FileSigmaRows(self, zeros.astype(np.int64), zeros, np.ones(temps.shape))
        if self.name == "H2plus_bf":
            lo, w, inside = _bracket(self.axis, temps)
            factor = np.where(inside, 1e-18, 0.0)
        else:  # Hminus_ff
            lo, w, inside = _bracket(self.axis, 5040.0 / temps)
            factor = np.where(inside, 1e-26 * K_B_CGS * temps, 0.0)
        rows = FileSigmaRows(self, lo, w, factor)
        # sigma is 0 at a depth where the factor is, or where the rows that
        # the weight reads hold a 0 in the same column
        zero_lerp = np.where(w == 0, self._zero_row[lo],
                             np.where(w == 1, self._zero_row[rows.hi], self._zero_pair[lo]))
        if np.any(factor == 0) or np.any(zero_lerp):
            logger.warning(_OUTSIDE[self.name])
        return rows

    def sigma(self, temperatures):
        """sigma [..., D, N] at ``temperatures`` [..., D], float64 on the host."""
        return self.rows_at(temperatures).dense()


@dataclasses.dataclass(eq=False)
class FileSigmaRows:
    """A file table's sigma at each depth of one or more models, not
    expanded: sigma[..., d, n] = factor[..., d] ((1 - w[..., d])
    g[lo[..., d], n] + w[..., d] g[lo[..., d] + 1, n]), with g the table's
    (``FileTable.rows_at``).  Indexing and ``reshape`` act on the depth
    arrays, as they would on the leading axes of the dense [..., D, N]
    array."""

    table: FileTable
    lo: np.ndarray  # [..., D] int64
    w: np.ndarray  # [..., D] float64
    factor: np.ndarray  # [..., D] float64: the format's scale, 0 outside the table

    def __len__(self):
        return len(self.lo)

    @property
    def hi(self):
        return np.minimum(self.lo + 1, len(self.table.g) - 1)

    def __getitem__(self, index):
        return FileSigmaRows(self.table, self.lo[index], self.w[index], self.factor[index])

    def reshape(self, *shape):
        return FileSigmaRows(self.table, self.lo.reshape(*shape), self.w.reshape(*shape),
                             self.factor.reshape(*shape))

    def dense(self, pixels=slice(None)):
        """sigma [..., D, n] over the grid's columns ``pixels``, float64."""
        g = self.table.g[:, pixels]
        w = self.w[..., None]
        return self.factor[..., None] * ((1.0 - w) * g[self.lo] + w * g[self.hi])

    def packed(self):
        """[3, C] float64 of the C depth columns: lo, w, factor (one copy
        to the device)."""
        return np.stack([self.lo.reshape(-1), self.w.reshape(-1), self.factor.reshape(-1)])


def read_file_table(fpath, opacity_source, tracing_lambdas) -> FileTable:
    """Read a table of ``opacity_source``'s format and interpolate it at
    ``tracing_lambdas`` [N] (AA), as the reference's bilinear
    interpolation does in wavelength, 0 outside the table."""
    lambdas = np.asarray(tracing_lambdas, dtype=np.float64)
    if opacity_source == "Hminus_bf":
        data = np.array([[float(t) for t in r] for r in _rows(fpath, sep=",")])
        return FileTable(opacity_source, np.interp(lambdas, data[:, 0], data[:, 1])[None],
                         None)
    if opacity_source == "H2plus_bf":
        header, *body = _rows(fpath)
        wave = np.array([float(r[0]) for r in body]) * 10.0  # nm -> AA
        axis = [float(t) for t in header[1:]]
        values = np.array(
            [_stancil_column([r[j] for r in body]) for j in range(1, len(header))]
        ).T  # [wavelength, T]
    elif opacity_source == "Hminus_ff":
        header, *body = _rows(fpath)
        axis = [float(t.strip(",")) for t in header[1:]]
        data = np.array([[float(t) for t in r] for r in body])
        wave, values = data[:, 0], data[:, 1:]  # [wavelength, theta]
    else:
        raise ValueError(f"Unknown opacity_source: {opacity_source}")
    wave, values = _ascending(wave, values, 0)
    axis, values = _ascending(axis, values, 1)
    i, y, inside = _bracket(wave, lambdas)
    g = (1.0 - y)[:, None] * values[i] + y[:, None] * values[i + 1]
    return FileTable(opacity_source, np.ascontiguousarray(np.where(inside[:, None], g, 0.0).T),
                     axis)


def sigma_file(tracing_lambdas, temperatures, fpath, opacity_source):
    """sigma [n_depth, n_lambda] for a tabulated opacity source."""
    table = read_file_table(fpath, opacity_source, tracing_lambdas)
    return table.sigma(np.asarray(temperatures, dtype=np.float64))


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
