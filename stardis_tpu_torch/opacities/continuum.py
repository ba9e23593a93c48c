"""Continuum opacity sources (PyTorch).

The port of ``stardis_tpu/opacities/continuum.py``: Thomson, Rayleigh,
hydrogenic bound-free (one masked (D,K)x(K,N) matmul) and free-free, with
the float32-safe constant folding of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import (
    BF_CONSTANT,
    FF_CONSTANT,
    RYDBERG_FREQUENCY,
    SIGMA_T_CGS,
)
from ..util.matmul import full_float32_matmul
from ..util.species import species_string_to_tuple

RAYLEIGH_COEFFS = {
    # species: (c4, c6, c8)  — reference base.py:111-125
    "H": (20.24, 239.2, 2256.0),
    "He": (1.913, 4.52, 7.90),
    "H2": (28.39, 215.0, 1303.0),
}
RAYLEIGH_NU_CUTOFF = 2.3e15  # Hz, reference base.py:98-99


def calc_alpha_electron(electron_densities, n_nu, disable=False):
    """Thomson scattering: sigma_T n_e broadcast over nu
    (reference base.py:139-174)."""
    if disable:
        return electron_densities.new_zeros((electron_densities.shape[0], n_nu))
    return (SIGMA_T_CGS * electron_densities)[:, None].expand(
        electron_densities.shape[0], n_nu
    )


def calc_alpha_rayleigh(tracing_nus, species_densities):
    """Rayleigh scattering (reference base.py:74-135).

    Parameters
    ----------
    tracing_nus : [N] Hz
    species_densities : dict name -> [D] number densities, names in
        RAYLEIGH_COEFFS.
    """
    nus = torch.where(tracing_nus > RAYLEIGH_NU_CUTOFF, 0.0, tracing_nus)
    rel = nus / (2.0 * RYDBERG_FREQUENCY)
    nu4, nu6, nu8 = rel**4, rel**6, rel**8

    first = next(iter(species_densities.values()))
    c4 = torch.zeros_like(first)
    c6 = torch.zeros_like(first)
    c8 = torch.zeros_like(first)
    for name, density in species_densities.items():
        k4, k6, k8 = RAYLEIGH_COEFFS[name]
        c4 = c4 + k4 * density
        c6 = c6 + k6 * density
        c8 = c8 + k8 * density

    alpha = c4[:, None] * nu4[None, :] + c6[:, None] * nu6[None, :] + c8[:, None] * nu8[None, :]
    return alpha * SIGMA_T_CGS


def bf_level_coefficients(cutoff_frequencies, ion_numbers):
    """Host-side (float64) per-level coefficient
    c_k = BF (Z_k+1)^4 / n_eff_k^5 / cutoff_k^3  (~1e-17, f32-safe).

    Folding cutoff^3 here keeps every device-side factor within float32
    normal range: BF_CONSTANT alone is 2.8e29 and nu^-3 is subnormal, so the
    reference's factorization (base.py:237) overflows/flushes in f32.
    """
    cutoff = np.asarray(cutoff_frequencies, dtype=np.float64)
    znum = np.asarray(ion_numbers, dtype=np.float64) + 1.0
    n_eff5 = (znum * np.sqrt(RYDBERG_FREQUENCY / cutoff)) ** 5
    return BF_CONSTANT * znum**4 / n_eff5 / cutoff**3


def calc_alpha_bf_hydrogenic(
    tracing_nus,  # [N]
    level_densities,  # [K, D] populations of the contributing levels
    cutoff_frequencies,  # [K] chi_ion - E_level in Hz (host-precomputed)
    coefficients,  # [K] from bf_level_coefficients (host, f64 -> dtype)
):
    """Hydrogenic bound-free (reference base.py:178-271).

    alpha[d, n] = sum_k 1[nu >= nu_k] c_k (nu/cutoff_k)^-3 n_k
    evaluated as a (D,K)x(K,N) matmul.  The matmul is torch.matmul, as the
    JAX package leaves it to XLA, in full float32 on CUDA (TF32 off),
    forward and backward (util.matmul.full_float32_matmul).
    """
    ratio = tracing_nus[None, :] / cutoff_frequencies[:, None]  # [K, N] O(1)
    mask = (ratio >= 1.0).to(level_densities.dtype)
    weighted = coefficients[:, None] * mask / ratio**3  # [K, N]
    return full_float32_matmul(level_densities.T, weighted)  # [D, N]


def calc_alpha_ff_hydrogenic(
    tracing_nus,  # [N]
    ion_densities,  # [M, D] densities of the target (one-higher) ions
    ion_numbers,  # [M] the charge used in the Z^2 factor
    electron_densities,  # [D]
    temperatures,  # [D]
):
    """Hydrogenic free-free (reference base.py:274-317):
    alpha = FF Z^2 n_ion n_e / sqrt(T) nu^-3.

    f32-safe factorization: FF*nu^-3 is computed as (FF^(1/3)/nu)^3 so no
    intermediate leaves float32 normal range (nu^-3 alone is subnormal and
    flushes to zero in float32)."""
    depth_term = (
        ion_densities
        * (electron_densities / torch.sqrt(temperatures))[None, :]
    )  # [M, D]
    z2 = ion_numbers**2  # [M]
    total = (z2[:, None] * depth_term).sum(dim=0)  # [D]
    ff_cbrt = float(FF_CONSTANT ** (1.0 / 3.0))
    nu_factor = (ff_cbrt / tracing_nus) ** 3  # [N], ~1e-36, normal f32
    return total[:, None] * nu_factor[None, :]


def calc_alpha_file(sigmas, species_density):
    """File opacity: host-interpolated sigma [D, N] x density [D]."""
    return sigmas * species_density[:, None]


def calc_alpha_file_rows(g, lo, w, scaled_density):
    """File opacity from a table's rows (``file_tables.FileSigmaRows``):
    scaled_density [D] x ((1 - w) g[lo] + w g[lo + 1]), with g [K, n] the
    table interpolated at the grid's wavelengths, lo [D] int64 and w [D]
    each depth's bracket and weight.  The per-depth factor of the format
    is already in the density: for H- ff it is subnormal in float32."""
    hi = (lo + 1).clamp_(max=g.shape[0] - 1)
    lerp = (torch.index_select(g, 0, lo) * (1.0 - w)[:, None]
            + torch.index_select(g, 0, hi) * w[:, None])
    return scaled_density[:, None] * lerp


# ----------------------------------------------------------------------
# species-density resolution (reference opacities_solvers/util.py:111-166)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class SpeciesDensityPlan:
    """Host-side plan describing how to read a species density from a
    PlasmaState (built once; applied on device)."""

    kind: str  # "slot" | "h_minus" | "hminus_ff" | "heminus_ff" |
    #            "h2minus_ff" | "h2plus_ff" | "h2plus_bf"
    slot: int = -1
    multiply_ne: bool = False
    atomic_number: int | None = None
    ion_number: int | None = None


def plan_species_density(opacity_source, tables):
    """Map an opacity-source string to a density-extraction plan."""
    if opacity_source in ("Hminus_bf", "Hminus_bf_john"):
        return SpeciesDensityPlan(kind="h_minus")
    if opacity_source in ("Hminus_ff", "Hminus_ff_john"):
        return SpeciesDensityPlan(kind="hminus_ff")
    if opacity_source == "Heminus_ff":
        return SpeciesDensityPlan(kind="heminus_ff")
    if opacity_source == "H2minus_ff":
        return SpeciesDensityPlan(kind="h2minus_ff")
    if opacity_source == "H2plus_ff":
        return SpeciesDensityPlan(kind="h2plus_ff")
    if opacity_source == "H2plus_bf":
        return SpeciesDensityPlan(kind="h2plus_bf")

    ion_str = opacity_source[:-3]
    z, ion = species_string_to_tuple(ion_str.replace("_", " "))
    multiply_ne = opacity_source.endswith("ff")
    if multiply_ne:
        ion += 1  # ff target: one ion stage up, times n_e (util.py:160-163)
    return SpeciesDensityPlan(
        kind="slot",
        slot=tables.slot_of(z, ion),
        multiply_ne=multiply_ne,
        atomic_number=z,
        ion_number=ion,
    )


def species_density(plan: SpeciesDensityPlan, state, tables):
    """[D] number density for the planned species from a PlasmaState."""
    h1 = state.ion_number_density[tables.slot_of(1, 0)]
    if plan.kind == "h_minus":
        return state.h_minus_density
    if plan.kind == "hminus_ff":
        return h1 * state.electron_densities
    if plan.kind == "heminus_ff":
        return (
            state.ion_number_density[tables.slot_of(2, 0)]
            * state.electron_densities
        )
    if plan.kind == "h2minus_ff":
        return state.h2_density * state.electron_densities
    if plan.kind == "h2plus_ff":
        return h1 * state.ion_number_density[tables.slot_of(1, 1)]
    if plan.kind == "h2plus_bf":
        return state.h2_plus_density
    density = state.ion_number_density[plan.slot]
    if plan.multiply_ne:
        density = density * state.electron_densities
    return density
