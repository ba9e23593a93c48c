"""Device-side LTE plasma solve (PyTorch).

The port of ``stardis_tpu/plasma/lte.py``:

    level Boltzmann factors g e^{-beta E}
    -> partition functions U (segment logsumexp over ion slots)
    -> Saha factors phi_j = 2 (U_{j+1}/U_j) g_e e^{-beta chi_j}
    -> charge-conservation solve for n_e (80-step log-space bisection, then
       one Newton step whose derivative comes from torch.func.jvp)
    -> ion and level number densities
    plus the H-, H2 and H2+ densities.

All Saha algebra runs in log space, so the solve is float32-safe.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import (
    EV_TO_ERG,
    H2_DISSOCIATION_ENERGY_EV,
    H_CGS,
    H_MINUS_CHI_EV,
    K_B_CGS,
    M_E_CGS,
    M_P_CGS,
    THERMAL_DE_BROGLIE_CONST,
)
from .tables import PlasmaTables

# Stancil 1994 H2+ equilibrium constants
H2_PLUS_K_EQUILIBRIUM_CONSTANT = np.array(
    [0.9600, 9.7683, 29.997, 59.599, 265.32, 845.01, 1685.3, 4289.5]
)
H2_PLUS_K_SAMPLE_TEMPS = np.array(
    [3150.0, 4200.0, 5040.0, 6300.0, 8400.0, 12600.0, 18600.0, 25200.0]
)

N_E_BISECTION_ITERS = 80


class DevicePlasmaTables(NamedTuple):
    """PlasmaTables payload as tensors on one device."""

    slot_element: torch.Tensor  # [S] int64
    slot_ion: torch.Tensor  # [S] int64
    slot_index: torch.Tensor  # [E, J] int64, -1 where absent
    chi: torch.Tensor  # [E, J-1]
    chi_mask: torch.Tensor  # [E, J-1] bool
    ion_charges: torch.Tensor  # [E, J] = 0..J-1 broadcast
    ion_mask: torch.Tensor  # [E, J] bool, charge state exists
    level_energy: torch.Tensor  # [L]
    level_g: torch.Tensor  # [L]
    level_slot: torch.Tensor  # [L] int64
    slot_levels: torch.Tensor  # [S, M] int64 levels of each slot, padded with L
    h_slots: tuple  # (slot of H I, slot of H II); (0, 0) when H absent
    has_hydrogen: bool


def device_tables(tables: PlasmaTables, dtype=torch.float64,
                  device="cpu") -> DevicePlasmaTables:
    """The plasma tables as tensors of ``dtype`` on ``device``."""
    j_max = tables.j_max
    charges = np.broadcast_to(np.arange(j_max), (tables.n_elements, j_max))
    ion_mask = charges < tables.n_ions[:, None]
    try:
        h_slots = (tables.slot_of(1, 0), tables.slot_of(1, 1))
        has_h = True
    except KeyError:
        h_slots = (0, 0)
        has_h = False

    def real(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device).to(dtype)

    def index(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)

    # each slot's levels in level order, padded with the index L of an
    # appended zero row, for the partition functions' segment sum
    level_slot = np.asarray(tables.level_slot, dtype=np.int64)
    n_slots, n_levels = len(tables.slot_element), len(level_slot)
    per_slot = [np.flatnonzero(level_slot == s) for s in range(n_slots)]
    slot_levels = np.full((n_slots, max([len(x) for x in per_slot] + [1])), n_levels)
    for s, levels in enumerate(per_slot):
        slot_levels[s, :len(levels)] = levels

    return DevicePlasmaTables(
        slot_element=index(tables.slot_element),
        slot_ion=index(tables.slot_ion),
        slot_index=index(tables.slot_index),
        chi=real(tables.chi),
        chi_mask=torch.as_tensor(np.asarray(tables.chi_mask), device=device),
        ion_charges=real(charges),
        ion_mask=torch.as_tensor(np.ascontiguousarray(ion_mask), device=device),
        level_energy=real(tables.level_energy),
        level_g=real(tables.level_g),
        level_slot=index(level_slot),
        slot_levels=index(slot_levels),
        h_slots=h_slots,
        has_hydrogen=bool(has_h),
    )


class PlasmaState(NamedTuple):
    """Dense LTE plasma state over (ion-slot/level, depth)."""

    t: torch.Tensor  # [D] temperatures
    beta: torch.Tensor  # [D] 1/(kT)
    log_g_electron: torch.Tensor  # [D]
    partition_function: torch.Tensor  # [S, D]
    electron_densities: torch.Tensor  # [D]
    ion_number_density: torch.Tensor  # [S, D]
    level_number_density: torch.Tensor  # [L, D]
    number_density: torch.Tensor  # [E, D] elemental
    h_neutral_density: torch.Tensor  # [D] n(H I); zeros when H absent
    h_minus_density: torch.Tensor  # [D]
    h2_density: torch.Tensor  # [D]
    h2_plus_density: torch.Tensor  # [D]


def _log_partition_functions(dt: DevicePlasmaTables, beta, n_slots):
    """log U[s, d] via a segment logsumexp over levels.  The segment sum
    gathers each slot's levels into a padded [S, M, D] block and sums it
    (``index_add`` on a CUDA device adds with atomics, in an order that
    changes from run to run, so float32 results would too)."""
    x = torch.log(dt.level_g)[:, None] - beta[None, :] * dt.level_energy[:, None]
    idx = dt.level_slot[:, None].expand_as(x)
    seg_max = torch.full(
        (n_slots, x.shape[1]), -torch.inf, dtype=x.dtype, device=x.device
    ).scatter_reduce(0, idx, x, reduce="amax", include_self=True)
    shifted = torch.exp(x - seg_max[dt.level_slot])
    padded = torch.cat([shifted, shifted.new_zeros((1, shifted.shape[1]))])
    seg_sum = padded[dt.slot_levels].sum(dim=1)
    return seg_max + torch.log(seg_sum)


def _log_phi(dt: DevicePlasmaTables, log_u, beta):
    """log Saha factor phi[e, j, d] for transitions j -> j+1."""
    s_lo = dt.slot_index[:, :-1].clamp(min=0)  # [E, J-1]
    s_hi = dt.slot_index[:, 1:].clamp(min=0)
    log_ratio = log_u[s_hi] - log_u[s_lo]  # [E, J-1, D]
    lp = float(np.log(2.0)) + log_ratio - beta[None, None, :] * dt.chi[..., None]
    return torch.where(dt.chi_mask[..., None], lp, -torch.inf)


def _ion_fractions(dt: DevicePlasmaTables, log_phi_tot, log_ne):
    """frac[e, j, d] of each element in charge state j, given log n_e[d]."""
    log_r = log_phi_tot - log_ne[None, None, :]  # [E, J-1, D]
    zeros = torch.zeros_like(log_r[:, :1, :])
    log_w = torch.cat([zeros, torch.cumsum(log_r, dim=1)], dim=1)  # [E, J, D]
    log_w = torch.where(dt.ion_mask[..., None], log_w, -torch.inf)
    return torch.softmax(log_w, dim=1)


def _interp(x, xp, fp):
    """numpy/jnp.interp: linear, constant beyond the ends."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, len(xp) - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    f = f0 + (x - x0) / (x1 - x0) * (f1 - f0)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def solve_lte(temperatures, elemental_number_density, dt: DevicePlasmaTables):
    """LTE solve, vectorized over depth.

    Parameters
    ----------
    temperatures : [D] K
    elemental_number_density : [E, D] 1/cm^3
    dt : DevicePlasmaTables on the same device and dtype
    """
    t = temperatures
    n_elem = elemental_number_density
    beta = 1.0 / (K_B_CGS * t)
    n_slots = dt.slot_element.shape[0]

    # fold constants in f64 Python first: 2 pi m_e k_B / h^2 ~ 1.8e10, while
    # the unfolded factors (7.9e-43, 4.4e-53) underflow float32
    g_e_const = 2.0 * np.pi * M_E_CGS * K_B_CGS / H_CGS**2
    log_g_electron = 1.5 * (torch.log(t) + float(np.log(g_e_const)))

    log_u = _log_partition_functions(dt, beta, n_slots)  # [S, D]
    log_phi = _log_phi(dt, log_u, beta)  # [E, J-1, D]
    log_phi_tot = log_phi + log_g_electron[None, None, :]

    # --- charge-conservation bisection on log n_e -----------------------
    # upper bound: every element fully stripped to its highest tracked stage
    elem_max_charge = dt.ion_mask.sum(dim=1).to(t.dtype) - 1.0  # [E]
    max_charge = (n_elem * elem_max_charge[:, None]).sum(dim=0)  # [D]
    log_hi = torch.log(max_charge * (1.0 + 1e-6) + 1e-30)
    log_lo = log_hi - 80.0  # n_e spans < 35 decades in any stellar atmosphere

    def total_charge(log_ne):
        frac = _ion_fractions(dt, log_phi_tot, log_ne)  # [E, J, D]
        charge = (frac * dt.ion_charges[..., None]).sum(dim=1)  # [E, D]
        return (n_elem * charge).sum(dim=0)  # [D]

    for _ in range(N_E_BISECTION_ITERS):
        mid = 0.5 * (log_lo + log_hi)
        up = total_charge(mid) - torch.exp(mid) > 0
        log_lo = torch.where(up, mid, log_lo)
        log_hi = torch.where(up, log_hi, mid)
    log_ne_star = (0.5 * (log_lo + log_hi)).detach()

    # One Newton step on the detached bisection root: below the bisection
    # tolerance in value, but it carries the implicit-function derivative
    # d n_e / d(T, N) that the piecewise-constant bisection lacks
    def resid(x):
        return torch.log(total_charge(x)) - x

    fx, dfx = torch.func.jvp(resid, (log_ne_star,), (torch.ones_like(log_ne_star),))
    log_ne = log_ne_star - fx / dfx
    n_e = torch.exp(log_ne)

    # --- populations ----------------------------------------------------
    frac = _ion_fractions(dt, log_phi_tot, log_ne)  # [E, J, D]
    n_ion = n_elem[dt.slot_element] * frac[dt.slot_element, dt.slot_ion]  # [S, D]

    lb = dt.level_g[:, None] * torch.exp(
        -beta[None, :] * dt.level_energy[:, None]
    )  # [L, D]
    u = torch.exp(log_u)
    n_level = n_ion[dt.level_slot] * lb / u[dt.level_slot]

    # --- hydrogen species ------------------------------------------------
    if dt.has_hydrogen:
        n_h_neutral = n_ion[dt.h_slots[0]]
        n_h_plus = n_ion[dt.h_slots[1]]
    else:
        n_h_neutral = torch.zeros_like(t)
        n_h_plus = torch.zeros_like(t)

    # constants folded in f64 Python before the division by t: the
    # unfolded m t (~1e-24 g K) would make the backward's 1/(m t)^2
    # overflow float32 (an inf, then a NaN gradient)
    lam3 = (float(THERMAL_DE_BROGLIE_CONST / M_E_CGS) / t) ** 1.5
    h_minus = n_h_neutral * n_e * (lam3 / 4.0) * torch.exp(
        H_MINUS_CHI_EV * EV_TO_ERG * beta
    )

    lam3_p = (float(2.0 * THERMAL_DE_BROGLIE_CONST / M_P_CGS) / t) ** 1.5
    h2 = n_h_neutral**2 * lam3_p * torch.exp(
        H2_DISSOCIATION_ENERGY_EV * EV_TO_ERG * beta
    )

    k_h2p = _interp(
        t,
        torch.as_tensor(H2_PLUS_K_SAMPLE_TEMPS, device=t.device).to(t.dtype),
        torch.as_tensor(H2_PLUS_K_EQUILIBRIUM_CONSTANT, device=t.device).to(t.dtype),
    )
    h2_plus = n_h_neutral * n_h_plus / k_h2p * 1e-19

    return PlasmaState(
        t=t,
        beta=beta,
        log_g_electron=log_g_electron,
        partition_function=u,
        electron_densities=n_e,
        ion_number_density=n_ion,
        level_number_density=n_level,
        number_density=n_elem,
        h_neutral_density=n_h_neutral,
        h_minus_density=h_minus,
        h2_density=h2,
        h2_plus_density=h2_plus,
    )
