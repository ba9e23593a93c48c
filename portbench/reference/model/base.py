# Frozen copy of stardis_tpu_torch/model/base.py at commit 9c7d618: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""Stellar model containers, NumPy only.

Counterparts of ``stardis_tpu/model/base.py``: the per-element tables are
arrays indexed by ``atomic_numbers`` instead of pandas frames.
"""

from __future__ import annotations

import numpy as np

from .. import units as u


class Radial1DGeometry:
    """Radial coordinates of the depth points, innermost -> surface.

    Parameters
    ----------
    r : Quantity [cm]
    reference_r : Quantity or None — photospheric radius for the spherical
        flux correction.
    """

    def __init__(self, r, reference_r=None):
        self.r = r
        self.reference_r = reference_r


class Composition:
    """Density + per-element mass fractions of the atmosphere.

    Parameters
    ----------
    density : Quantity [g/cm^3], shape (n_depth,)
    atomic_numbers : [E] atomic numbers of the rows of ``mass_fraction``.
    mass_fraction : [E, D] mass fractions, depth 0 innermost.
    element_masses : callable atomic numbers -> masses [g]
        (``AtomData.mass_of``).
    """

    def __init__(self, density, atomic_numbers, mass_fraction, element_masses):
        self.density = density
        self.atomic_numbers = np.asarray(atomic_numbers, dtype=np.int64)
        self.nuclide_mass_fraction = mass_fraction
        self.element_masses = element_masses

    @property
    def elemental_number_density(self):
        """[E, D] number densities in 1/cm^3, rows in ``atomic_numbers``
        order."""
        rho = np.asarray(self.density)  # g/cm^3 cgs
        masses = self.element_masses(self.atomic_numbers)
        return (
            np.asarray(self.nuclide_mass_fraction) * rho[np.newaxis, :]
            / masses[:, None]
        )


class StellarModel:
    """Temperatures + geometry + composition."""

    def __init__(self, temperatures, geometry, composition, spherical=False,
                 microturbulence=None):
        self.temperatures = temperatures
        self.geometry = geometry
        self.composition = composition
        self.spherical = spherical
        if microturbulence is None:
            microturbulence = u.Quantity(0.0, u.km / u.s)
        self.microturbulence = microturbulence

    @property
    def no_of_depth_points(self):
        return np.asarray(self.temperatures).shape[0]
