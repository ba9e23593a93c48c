# Frozen copy of stardis_tpu_torch/io/abundances.py at commit 9c7d618: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""Solar-abundance tables and composition utilities, NumPy only.

The Asplund 2009/2020 tables and the rescaling rules of
``stardis_tpu/io/abundances.py``, returning arrays instead of pandas frames.
"""

from __future__ import annotations

import logging

import numpy as np

from ..util.species import (
    atomic_number2element_symbol,
    element_symbol2atomic_number,
)

logger = logging.getLogger(__name__)

# Asplund et al. 2009 (ARA&A 47, 481) photospheric log eps (H = 12)
ASPLUND_2009 = {
    1: 12.0, 2: 10.93, 3: 1.05, 4: 1.38, 5: 2.7, 6: 8.43,
    7: 7.83, 8: 8.69, 9: 4.56, 10: 7.93, 11: 6.24, 12: 7.6,
    13: 6.45, 14: 7.51, 15: 5.41, 16: 7.12, 17: 5.5, 18: 6.4,
    19: 5.03, 20: 6.34, 21: 3.15, 22: 4.95, 23: 3.93, 24: 5.64,
    25: 5.43, 26: 7.5, 27: 4.99, 28: 6.22, 29: 4.19, 30: 4.56,
    31: 3.04, 32: 3.65, 33: 2.3, 34: 3.34, 35: 2.54, 36: 3.25,
    37: 2.52, 38: 2.87, 39: 2.21, 40: 2.58, 41: 1.46, 42: 1.88,
    44: 1.75, 45: 0.91, 46: 1.57, 47: 0.94, 48: 1.71, 49: 0.8,
    50: 2.04, 51: 1.01, 52: 2.18, 53: 1.55, 54: 2.24, 55: 1.08,
    56: 2.18, 57: 1.1, 58: 1.58, 59: 0.72, 60: 1.42, 62: 0.96,
    63: 0.52, 64: 1.07, 65: 0.3, 66: 1.1, 67: 0.48, 68: 0.92,
    69: 0.1, 70: 0.84, 71: 0.1, 72: 0.85, 73: -0.12, 74: 0.85,
    75: 0.26, 76: 1.4, 77: 1.38, 78: 1.62, 79: 0.92, 80: 1.17,
    81: 0.9, 82: 1.75, 83: 0.65, 90: 0.02, 92: -0.54,
}

# Asplund et al. 2020 (A&A 653, A141)
ASPLUND_2020 = {
    1: 12.0, 2: 10.914, 3: 0.96, 4: 1.38, 5: 2.7, 6: 8.46,
    7: 7.83, 8: 8.69, 9: 4.4, 10: 8.06, 11: 6.22, 12: 7.55,
    13: 6.43, 14: 7.51, 15: 5.41, 16: 7.12, 17: 5.31, 18: 6.38,
    19: 5.07, 20: 6.3, 21: 3.14, 22: 4.97, 23: 3.9, 24: 5.62,
    25: 5.42, 26: 7.46, 27: 4.94, 28: 6.2, 29: 4.18, 30: 4.56,
    31: 3.02, 32: 3.62, 33: 2.3, 34: 3.34, 35: 2.54, 36: 3.12,
    37: 2.32, 38: 2.83, 39: 2.21, 40: 2.59, 41: 1.47, 42: 1.88,
    44: 1.75, 45: 0.78, 46: 1.57, 47: 0.96, 48: 1.71, 49: 0.8,
    50: 2.02, 51: 1.01, 52: 2.18, 53: 1.55, 54: 2.22, 55: 1.08,
    56: 2.27, 57: 1.11, 58: 1.58, 59: 0.75, 60: 1.42, 62: 0.95,
    63: 0.52, 64: 1.08, 65: 0.31, 66: 1.1, 67: 0.48, 68: 0.93,
    69: 0.11, 70: 0.85, 71: 0.1, 72: 0.85, 73: -0.15, 74: 0.79,
    75: 0.26, 76: 1.35, 77: 1.32, 78: 1.61, 79: 0.91, 80: 1.17,
    81: 0.92, 82: 1.95, 83: 0.65, 90: 0.03, 92: -0.54,
}

# Reference mass fractions implied by each table (reference io/model/util.py:12-18)
ASPLUND_2009_HE_MASS_FRAC_Y = 0.2492280
ASPLUND_2009_HEAVY_MASS_FRAC_Z = 0.01337
ASPLUND_2020_HE_MASS_FRAC_Y = 0.2423
ASPLUND_2020_HEAVY_MASS_FRAC_Z = 0.0139


def create_scaled_solar_profile(
    atom_data,
    helium_mass_frac_Y=ASPLUND_2020_HE_MASS_FRAC_Y,
    heavy_metal_mass_frac_Z=ASPLUND_2020_HEAVY_MASS_FRAC_Z,
    final_atomic_number=None,
    composition_source="asplund_2020",
):
    """Solar mass fractions rescaled so the He and metal mass fractions hit
    the requested Y and Z (H absorbs the remainder).

    Returns (atomic_numbers [E], mass_fractions [E]) over every Z from the
    lowest to the highest tabulated element, zero where the table has none.
    """
    if composition_source == "asplund_2020":
        table, y_tot, z_tot = (
            ASPLUND_2020,
            ASPLUND_2020_HE_MASS_FRAC_Y,
            ASPLUND_2020_HEAVY_MASS_FRAC_Z,
        )
    elif composition_source == "asplund_2009":
        table, y_tot, z_tot = (
            ASPLUND_2009,
            ASPLUND_2009_HE_MASS_FRAC_Y,
            ASPLUND_2009_HEAVY_MASS_FRAC_Z,
        )
    else:
        raise ValueError(
            f"Unknown composition source: {composition_source}. "
            "Use 'asplund_2009' or 'asplund_2020'."
        )

    present = set(int(z) for z in atom_data.atom_data.atomic_number)
    zs = sorted(z for z in table if z in present)
    if final_atomic_number is not None:
        zs = [z for z in zs if z <= final_atomic_number]

    masses = atom_data.mass_of(zs)
    mass_weight = masses * 10.0 ** np.array([table[z] for z in zs])

    full_index = np.arange(min(zs), max(zs) + 1)
    frame = np.zeros(len(full_index))
    frame[np.asarray(zs) - full_index[0]] = mass_weight

    if helium_mass_frac_Y == -99.0:
        helium_mass_frac_Y = y_tot
    if heavy_metal_mass_frac_Z == -99.0:
        heavy_metal_mass_frac_Z = z_tot

    frame[full_index == 2] *= helium_mass_frac_Y / y_tot
    frame[full_index >= 3] *= heavy_metal_mass_frac_Z / z_tot

    frame = frame / frame.sum()
    logger.info(
        "Created composition with X=%.3f, Y=%.3f, Z=%.3f",
        frame[full_index == 1].sum(),
        frame[full_index == 2].sum(),
        frame[full_index >= 3].sum(),
    )
    return full_index, frame


def rescale_nuclide_mass_fractions(atomic_numbers, mass_fraction, nuclides,
                                   scale_factors):
    """Multiply selected elements' mass fractions [E, D] by scale factors,
    then renormalize each depth."""
    new = np.array(mass_fraction, dtype=float, copy=True)
    row = {int(z): i for i, z in enumerate(atomic_numbers)}
    for nuclide, scale in zip(nuclides, scale_factors):
        if not isinstance(nuclide, (int, np.integer)):
            nuclide = element_symbol2atomic_number(nuclide)
        if int(nuclide) not in row:
            raise ValueError(f"{nuclide} not available in the simulation")
        logger.info(
            "Rescaling %s by %s", atomic_number2element_symbol(nuclide), scale
        )
        new[row[int(nuclide)]] = new[row[int(nuclide)]] * scale
    return new / new.sum(axis=0)[None, :]
