# Frozen copy of stardis_tpu_torch/units.py at commit 9c7d618,
# trimmed to what the benchmark reaches: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""Minimal unit/quantity system (astropy-free).

The reference framework exposes its API through `astropy.units` Quantities
(e.g. ``run_stardis(config, tracing_lambdas * u.AA)``).  So as not to depend
on astropy, this module provides a small, self-contained CGS-based
replacement covering the unit surface the framework needs:

* dimensional analysis over (length, mass, time, temperature),
* ``Quantity.to`` with the spectral equivalence (wavelength <-> frequency),
* arithmetic between quantities and scalars/arrays.

Internally every Unit is (scale-to-CGS, dimension-exponent tuple).
"""

from __future__ import annotations

import numpy as np

from .constants import C_CGS, EV_TO_ERG

# dimension exponents: (length, mass, time, temperature)
_DIMLESS = (0, 0, 0, 0)


class Unit:
    __slots__ = ("scale", "dims", "name")

    def __init__(self, scale, dims, name=""):
        self.scale = float(scale)
        self.dims = tuple(dims)
        self.name = name

    def __mul__(self, other):
        if isinstance(other, Unit):
            return Unit(
                self.scale * other.scale,
                tuple(a + b for a, b in zip(self.dims, other.dims)),
                f"{self.name} {other.name}".strip(),
            )
        return Quantity(other, self)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Unit(
                self.scale / other.scale,
                tuple(a - b for a, b in zip(self.dims, other.dims)),
                f"{self.name}/{other.name}",
            )
        return Quantity(1.0 / np.asarray(other), self)

    def __rtruediv__(self, other):
        inv = Unit(1.0 / self.scale, tuple(-d for d in self.dims), f"1/{self.name}")
        if isinstance(other, Unit):
            return other * inv
        return Quantity(np.asarray(other), inv)

    def __pow__(self, p):
        return Unit(
            self.scale**p, tuple(d * p for d in self.dims), f"{self.name}^{p}"
        )

    def __eq__(self, other):
        return (
            isinstance(other, Unit)
            and np.isclose(self.scale, other.scale)
            and self.dims == other.dims
        )

    def __hash__(self):
        return hash((round(np.log(self.scale), 12), self.dims))

    def __repr__(self):
        return f"Unit({self.name or self.dims}, scale={self.scale:g})"


def _u(scale, dims, name):
    return Unit(scale, dims, name)


# base CGS units
cm = _u(1.0, (1, 0, 0, 0), "cm")
g = _u(1.0, (0, 1, 0, 0), "g")
s = _u(1.0, (0, 0, 1, 0), "s")
K = _u(1.0, (0, 0, 0, 1), "K")
dimensionless = _u(1.0, _DIMLESS, "")

# derived length
m = _u(100.0, (1, 0, 0, 0), "m")
km = _u(1e5, (1, 0, 0, 0), "km")
AA = Angstrom = _u(1e-8, (1, 0, 0, 0), "AA")
nm = _u(1e-7, (1, 0, 0, 0), "nm")
micron = um = _u(1e-4, (1, 0, 0, 0), "um")

# mass
kg = _u(1000.0, (0, 1, 0, 0), "kg")

# time / frequency
Hz = _u(1.0, (0, 0, -1, 0), "Hz")
yr = _u(3.1557e7, (0, 0, 1, 0), "yr")

# energy
erg = _u(1.0, (2, 1, -2, 0), "erg")
eV = _u(EV_TO_ERG, (2, 1, -2, 0), "eV")
J = _u(1e7, (2, 1, -2, 0), "J")

# misc astronomy
M_sun = _u(1.98892e33, (0, 1, 0, 0), "Msun")
R_sun = _u(6.957e10, (1, 0, 0, 0), "Rsun")
L_sun = _u(3.828e33, (2, 1, -3, 0), "Lsun")

_NAMED = {
    "cm": cm,
    "m": m,
    "km": km,
    "AA": AA,
    "Angstrom": AA,
    "angstrom": AA,
    "A": AA,
    "nm": nm,
    "um": um,
    "g": g,
    "kg": kg,
    "s": s,
    "K": K,
    "Hz": Hz,
    "erg": erg,
    "eV": eV,
    "J": J,
    "yr": yr,
    "Msun": M_sun,
    "Lsun": L_sun,
    "Rsun": R_sun,
    "solar masses": M_sun,
    "": dimensionless,
}

_LENGTH = (1, 0, 0, 0)
_FREQ = (0, 0, -1, 0)
_ENERGY = (2, 1, -2, 0)


def parse_unit(text):
    """Parse simple unit strings like 'km/s', 'erg/cm2/s', 'cm/s2', 'K'."""
    text = text.strip()
    if text in _NAMED:
        return _NAMED[text]
    # split on '/' first; each token may carry an integer power suffix
    parts = text.replace("**", "").split("/")

    def tok(t):
        t = t.strip()
        power = 1
        while t and t[-1].isdigit():
            power = int(t[-1])
            t = t[:-1]
        if t not in _NAMED:
            raise ValueError(f"Unknown unit token {t!r} in {text!r}")
        return _NAMED[t] ** power

    out = tok(parts[0])
    for p in parts[1:]:
        out = out / tok(p)
    out.name = text
    return out


class _SpectralEquivalency:
    """Sentinel enabling wavelength <-> frequency <-> energy conversion."""


def spectral():
    return _SpectralEquivalency()


class Quantity:
    """Array with attached Unit. Supports the arithmetic surface the
    framework needs; values propagate as numpy arrays."""

    __slots__ = ("_value", "unit")
    __array_priority__ = 10000  # beat numpy ufunc dispatch

    def __init__(self, value, unit):
        if isinstance(value, Quantity):
            value = value.to(unit).value if isinstance(unit, Unit) else value.value
        self._value = np.asarray(value, dtype=float)
        self.unit = unit if isinstance(unit, Unit) else parse_unit(unit)

    # ---- conversion -------------------------------------------------
    @property
    def value(self):
        return self._value if self._value.ndim else self._value.item()

    @property
    def cgs(self):
        return Quantity(self._value * self.unit.scale, Unit(1.0, self.unit.dims))

    def to(self, unit, equivalencies=None):
        if isinstance(unit, str):
            unit = parse_unit(unit)
        if self.unit.dims == unit.dims:
            return Quantity(self._value * (self.unit.scale / unit.scale), unit)
        eq = equivalencies
        if eq is not None and not isinstance(eq, _SpectralEquivalency):
            # astropy passes a list of equivalencies
            eq = next(
                (e for e in np.atleast_1d(eq) if isinstance(e, _SpectralEquivalency)),
                None,
            )
        if eq is not None:
            cgs_val = self._value * self.unit.scale
            src, dst = self.unit.dims, unit.dims
            if src == _LENGTH and dst == _FREQ:
                return Quantity(C_CGS / cgs_val / unit.scale, unit)
            if src == _FREQ and dst == _LENGTH:
                return Quantity(C_CGS / cgs_val / unit.scale, unit)
            if src == _LENGTH and dst == _ENERGY:
                from .constants import H_CGS

                return Quantity(H_CGS * C_CGS / cgs_val / unit.scale, unit)
            if src == _ENERGY and dst == _FREQ:
                from .constants import H_CGS

                return Quantity(cgs_val / H_CGS / unit.scale, unit)
            if src == _FREQ and dst == _ENERGY:
                from .constants import H_CGS

                return Quantity(cgs_val * H_CGS / unit.scale, unit)
        raise ValueError(
            f"Cannot convert {self.unit!r} -> {unit!r} (no applicable equivalency)"
        )

    # ---- arithmetic -------------------------------------------------
    def _coerce(self, other):
        if isinstance(other, Quantity):
            return other
        if isinstance(other, Unit):
            return Quantity(1.0, other)
        return Quantity(other, dimensionless)

    def __add__(self, other):
        other = self._coerce(other)
        return Quantity(
            self._value + other.to(self.unit)._value
            if other.unit.dims == self.unit.dims
            else self._value + other._value,
            self.unit,
        )

    __radd__ = __add__

    def __sub__(self, other):
        other = self._coerce(other)
        return Quantity(self._value - other.to(self.unit)._value, self.unit)

    def __rsub__(self, other):
        other = self._coerce(other)
        return Quantity(other.to(self.unit)._value - self._value, self.unit)

    def __mul__(self, other):
        if isinstance(other, Unit):
            return Quantity(self._value, self.unit * other)
        other = self._coerce(other)
        return Quantity(self._value * other._value, self.unit * other.unit)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Quantity(self._value, self.unit / other)
        other = self._coerce(other)
        return Quantity(self._value / other._value, self.unit / other.unit)

    def __rtruediv__(self, other):
        other = self._coerce(other)
        return Quantity(other._value / self._value, other.unit / self.unit)

    def __pow__(self, p):
        return Quantity(self._value**p, self.unit**p)

    def __neg__(self):
        return Quantity(-self._value, self.unit)

    def __getitem__(self, idx):
        return Quantity(self._value[idx], self.unit)

    def __len__(self):
        return len(self._value)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._value, dtype=dtype)

    @property
    def shape(self):
        return self._value.shape

    @property
    def ndim(self):
        return self._value.ndim

    def reshape(self, *shape):
        return Quantity(self._value.reshape(*shape), self.unit)

    def min(self):
        return Quantity(self._value.min(), self.unit)

    def max(self):
        return Quantity(self._value.max(), self.unit)

    def __repr__(self):
        return f"<Quantity {self._value!r} {self.unit.name or self.unit.dims}>"

    def __eq__(self, other):
        other = self._coerce(other)
        return self.cgs._value == other.cgs._value

    def __lt__(self, other):
        return self.cgs._value < self._coerce(other).cgs._value

    def __gt__(self, other):
        return self.cgs._value > self._coerce(other).cgs._value
