# Frozen copy of stardis_tpu_torch/opacities/broadening.py at commit 9c7d618: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""Line-broadening parameters (PyTorch, vectorized over lines x depth).

The port of ``stardis_tpu/opacities/broadening.py``.  Conventions kept for
parity:
* gammas are summed then divided by 2 ("HWHM to FWHM") in the VALD path only;
* linear Stark applies to hydrogen lines only;
* the VALD van-der-Waals parameter is dispatched on its packed value
  (<0 scaled, ==0 none, (0,20) Unsoeld enhancement, >=20 ABO sigma.alpha).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    A0_CGS,
    AMU_CGS,
    C_CGS,
    E_ESU,
    H_CGS,
    K_B_CGS,
    M_P_CGS,
    RYDBERG_ENERGY,
    VACUUM_ELECTRIC_PERMITTIVITY,
)

PI = float(np.pi)


def calc_doppler_width(nu_line, temperature, atomic_mass, microturbulence=0.0):
    """Doppler width Delta nu_D = (nu0/c) sqrt(2kT/m + xi^2)
    (reference broadening.py:32-71)."""
    return (
        nu_line
        / C_CGS
        * torch.sqrt(2.0 * K_B_CGS * temperature / atomic_mass + microturbulence**2)
    )


def calc_n_effective(ion_number, ionization_energy, level_energy):
    """n_eff = Z sqrt(Ry / (chi - E)) (reference broadening.py:114-146)."""
    return ion_number * torch.sqrt(
        RYDBERG_ENERGY / (ionization_energy - level_energy)
    )


def calc_gamma_linear_stark(n_eff_upper, n_eff_lower, electron_density):
    """Sutton 1978 linear Stark for hydrogen (broadening.py:193-234)."""
    a1 = torch.ones_like(n_eff_upper).masked_fill(
        n_eff_upper - n_eff_lower < 1.5, 0.642
    )
    return (
        0.60 * a1 * (n_eff_upper**2 - n_eff_lower**2) * electron_density ** (2.0 / 3.0)
    )


def calc_gamma_quadratic_stark(
    ion_number, n_eff_upper, n_eff_lower, electron_density, temperature
):
    """Quadratic Stark (Traving 1960 via Transparency.jl;
    broadening.py:281-360)."""
    # the constants folded in float64 first: e^2 a0^3 (3.4e-44) lies below
    # float32's smallest normal number, where it keeps one or two digits
    c4_prefactor = float(
        E_ESU**2 * A0_CGS**3 / (36.0 * H_CGS * VACUUM_ELECTRIC_PERMITTIVITY)
    ) / ion_number**4
    c4_term_1 = n_eff_upper * (5.0 * n_eff_upper**2 + 1.0)
    c4_term_2 = n_eff_lower * (5.0 * n_eff_lower**2 + 1.0)
    c4 = c4_prefactor * (c4_term_1**2 - c4_term_2**2)
    return (
        1e19
        * K_B_CGS
        * electron_density
        * c4 ** (2.0 / 3.0)
        * temperature ** (1.0 / 6.0)
    )


def calc_gamma_van_der_waals(
    ion_number, n_eff_upper, n_eff_lower, temperature, h_density
):
    """van der Waals broadening (Unsoeld; broadening.py:420-490)."""
    c6 = (
        6.46e-34
        * ((5.0 * n_eff_upper**4 + n_eff_upper**2)
           - (5.0 * n_eff_lower**4 + n_eff_lower**2))
        / (2.0 * ion_number**2)
    )
    return (
        17.0
        * (8.0 * K_B_CGS * temperature / (PI * M_P_CGS)) ** 0.3
        * c6**0.4
        * h_density
    )


def calc_gamma(
    atomic_number,  # [L, 1]
    ion_number,  # [L, 1]  (charge + 1: interior charge seen by the electron)
    ionization_energy,  # [L, 1] erg
    upper_level_energy,  # [L, 1] erg
    lower_level_energy,  # [L, 1] erg
    A_ul,  # [L, 1]
    electron_density,  # [D]
    temperature,  # [D]
    h_density,  # [D]
    linear_stark=True,
    quadratic_stark=True,
    van_der_waals=True,
    radiation=True,
):
    """Total collisional gamma [L, D] (reference broadening.py:550-656)."""
    n_eff_upper = calc_n_effective(ion_number, ionization_energy, upper_level_energy)
    n_eff_lower = calc_n_effective(ion_number, ionization_energy, lower_level_energy)

    gamma = torch.zeros(
        (atomic_number.shape[0], electron_density.shape[0]),
        dtype=electron_density.dtype, device=electron_density.device,
    )
    if linear_stark:
        g_lin = calc_gamma_linear_stark(
            n_eff_upper, n_eff_lower, electron_density[None, :]
        )
        gamma = gamma + torch.where(atomic_number == 1, g_lin, 0.0)
    if quadratic_stark:
        gamma = gamma + calc_gamma_quadratic_stark(
            ion_number,
            n_eff_upper,
            n_eff_lower,
            electron_density[None, :],
            temperature[None, :],
        )
    if van_der_waals:
        gamma = gamma + calc_gamma_van_der_waals(
            ion_number, n_eff_upper, n_eff_lower, temperature[None, :],
            h_density[None, :],
        )
    if radiation:
        gamma = gamma + A_ul
    return gamma


# ----------------------------------------------------------------------
# VALD-parameter broadening (reference broadening.py:880-1085)
# ----------------------------------------------------------------------

def calc_vald_stark_gamma(electron_density, stark, temperature):
    """gamma = n_e 10^stark (T/1e4)^(1/6); only negative stark values are
    meaningful (reference broadening.py:880-890)."""
    g = electron_density * 10.0**stark * (temperature / 1e4) ** (1.0 / 6.0)
    return torch.where(electron_density * stark >= 0, 0.0, g)


def _vald_vdw_scaled(vdW, temperature):
    return 10.0**vdW * (temperature / 1e4) ** 0.38


def _vald_vdw_unsoeld(
    vdW, ion_number, ionization_energy, upper_level_energy, lower_level_energy,
    temperature,
):
    n_eff_upper = calc_n_effective(ion_number, ionization_energy, upper_level_energy)
    n_eff_lower = calc_n_effective(ion_number, ionization_energy, lower_level_energy)
    approx = calc_gamma_van_der_waals(
        ion_number, n_eff_upper, n_eff_lower, temperature, torch.ones_like(temperature)
    )
    return approx * vdW


def _vald_vdw_abo(vdW, temperature, atomic_mass):
    """ABO packed sigma.alpha theory (broadening.py:928-948): integer part is
    sigma in Bohr-radius^2 units, fractional part is the velocity exponent."""
    vdW_int = torch.floor(vdW)
    sigma = vdW_int * A0_CGS * A0_CGS
    alpha = vdW - vdW_int
    inv_reduced_mass = 1.0 / (1.008 * AMU_CGS) + 1.0 / atomic_mass
    vbar = torch.sqrt(8.0 * K_B_CGS * temperature / PI * inv_reduced_mass)
    gamma_43 = torch.exp(torch.lgamma((4.0 - alpha) / 2.0))
    return (
        2.0
        * (4.0 / PI) ** (alpha / 2.0)
        * gamma_43
        * 1e6
        * sigma
        * (vbar / 1e6) ** (1.0 - alpha)
    )


def calc_vald_vdW(
    vdW,  # [L, 1] packed parameter
    temperature,  # [D]
    atomic_mass,  # [L, 1]
    upper_level_energy,  # [L, 1]
    lower_level_energy,  # [L, 1]
    hydrogen_density,  # [D]
    ion_number,  # [L, 1] charge + 1
    ionization_energy,  # [L, 1]
):
    t = temperature[None, :]
    scaled = _vald_vdw_scaled(vdW, t)
    unsoeld = _vald_vdw_unsoeld(
        vdW, ion_number, ionization_energy, upper_level_energy,
        lower_level_energy, t,
    )
    abo = _vald_vdw_abo(vdW, t, atomic_mass)
    gamma = torch.where(
        vdW < 0,
        scaled,
        torch.where(
            vdW == 0.0,
            0.0,
            torch.where(vdW < 20.0, unsoeld, abo),
        ),
    )
    return gamma * hydrogen_density[None, :]
