# Frozen copy of stardis_tpu_torch/opacities/lines.py at commit 9c7d618: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""Line opacity: host-side line selection (NumPy) + device-side per-line
quantities (PyTorch).

The port of ``stardis_tpu/opacities/lines.py``: lines are selected, joined
and sorted once on the host; the device computes dense [lines x depth]
alpha, gamma and Doppler widths from the plasma state.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..atom_data.base import Table
from ..constants import (
    ALPHA_COEFFICIENT,
    C_CGS,
    EV_TO_ERG,
    H_CGS,
    K_B_CGS,
)
from .broadening import (
    calc_doppler_width,
    calc_gamma,
    calc_gamma_linear_stark,
    calc_n_effective,
    calc_vald_stark_gamma,
    calc_vald_vdW,
)
from ..plasma.tables import PlasmaTables


@dataclasses.dataclass
class LineData:
    """Host-prepared per-line arrays, sorted by frequency ascending and
    restricted to the tracing range."""

    nu: np.ndarray  # [L] Hz
    atomic_number: np.ndarray  # [L]
    ion_number: np.ndarray  # [L] charge
    ionization_energy: np.ndarray  # [L] erg (of ion_number+1 stage)
    level_energy_lower: np.ndarray  # [L] erg
    level_energy_upper: np.ndarray  # [L] erg
    A_ul: np.ndarray  # [L] 1/s
    mass: np.ndarray  # [L] g
    # TARDIS-path fields
    lower_level_flat: np.ndarray | None = None  # [L] index into level table
    f_lu: np.ndarray | None = None  # [L]
    # VALD-path fields
    vald_slot: np.ndarray | None = None  # [L] ion slot for N_ion/U
    vald_gf: np.ndarray | None = None  # [L] 10^log_gf
    vald_e_low_erg: np.ndarray | None = None  # [L]
    vald_stark: np.ndarray | None = None  # [L]
    vald_waals: np.ndarray | None = None  # [L]

    @property
    def n_lines(self):
        return len(self.nu)


def _next_stage_chi(atom_data, z, q):
    """chi of the ionization out of charge q (key (Z, q+1)); NaN where the
    atom data has none — the JAX package's left merge."""
    ion = atom_data.ionization_data
    chi = {
        (int(a), int(b) - 1): float(e)
        for a, b, e in zip(ion.atomic_number, ion.ion_number, ion.ionization_energy)
    }
    return np.array(
        [chi.get((int(a), int(b)), np.nan) for a, b in zip(z, q)], dtype=float
    )


def _slots(tables: PlasmaTables, z, q):
    """Vectorized ``tables.slot_of``."""
    z = np.asarray(z, dtype=np.int64)
    q = np.asarray(q, dtype=np.int64)
    e = np.searchsorted(tables.zs, z)
    ok = (e < len(tables.zs)) & (q >= 0) & (q < tables.j_max)
    ok[ok] &= tables.zs[e[ok]] == z[ok]
    slots = np.full(len(z), -1, dtype=np.int64)
    slots[ok] = tables.slot_index[e[ok], q[ok]]
    if (slots < 0).any():
        bad = int(np.nonzero(slots < 0)[0][0])
        raise KeyError(f"ion ({z[bad]}, {q[bad]}) not in plasma tables")
    return slots


def prepare_line_data(
    atom_data, tables: PlasmaTables, nu_min, nu_max, use_vald=False,
    drop_autoionization=True,
) -> LineData:
    """Select and annotate lines in [nu_min, nu_max].

    TARDIS path: lines from atom_data.lines joined with level energies and
    ionization energies.  VALD path: lines from atom_data.linelist_atoms;
    long-form lists always drop autoionizing lines (E_up >= chi), the TARDIS
    path and shortlists only when ``drop_autoionization`` (E_up > chi).
    """
    if use_vald:
        if atom_data.linelist_atoms is None:
            raise ValueError("atom data has no VALD linelist_atoms")
        ll = atom_data.linelist_atoms
        ll = ll.take(ll.atomic_number <= atom_data.selected_atomic_numbers.max())
        cols = dict(ll.columns)
        cols["ion_number"] = cols.pop("ion_charge")
        cols["nu"] = (C_CGS / (cols["wavelength"] * 1e-8)).astype(float)
        if "e_up" not in cols:  # shortlist: reconstruct E_up from lambda
            cols["e_up"] = cols["e_low"] + (
                H_CGS * C_CGS / (cols["wavelength"] * 1e-8)
            ) / EV_TO_ERG
        frame = Table(cols)
    else:
        frame = atom_data.lines.take(
            np.isin(atom_data.lines.atomic_number, atom_data.selected_atomic_numbers)
        )

    frame = frame.take(np.argsort(frame.nu, kind="quicksort"))
    frame = frame.take((frame.nu >= nu_min) & (frame.nu <= nu_max))
    frame["ionization_energy"] = _next_stage_chi(
        atom_data, frame.atomic_number, frame.ion_number
    )
    chi = frame.ionization_energy

    if use_vald:
        e_low = frame.e_low * EV_TO_ERG
        e_up = frame.e_up * EV_TO_ERG
        if "j_lo" in frame:
            keep = e_up < chi  # long form: always, strict <
        elif drop_autoionization:
            keep = ~(e_up > chi)  # shortlist: equality and NaN chi are kept
        else:
            keep = np.ones(len(frame), dtype=bool)
        frame = frame.take(keep)
        e_low, e_up = e_low[keep], e_up[keep]
        # gf = g_lo * f_lu as VALD tabulates it; the g_lo in n_lower and the
        # /g_lo in f_lu cancel, so both long and short forms use 10^log_gf
        return LineData(
            nu=frame.nu.astype(float),
            atomic_number=frame.atomic_number.astype(np.int64),
            ion_number=frame.ion_number.astype(np.int64),
            ionization_energy=frame.ionization_energy.astype(float),
            level_energy_lower=e_low,
            level_energy_upper=e_up,
            A_ul=10.0 ** frame.rad,
            mass=atom_data.mass_of(frame.atomic_number),
            vald_slot=_slots(tables, frame.atomic_number, frame.ion_number),
            vald_gf=(10.0 ** frame.log_gf).astype(float),
            vald_e_low_erg=e_low,
            vald_stark=frame.stark.astype(float),
            vald_waals=frame.waals.astype(float),
        )

    def flat(level_numbers):
        return np.array(
            [
                tables.level_flat_index[(int(z), int(q), int(n))]
                for z, q, n in zip(frame.atomic_number, frame.ion_number, level_numbers)
            ],
            dtype=np.int64,
        )

    lower_flat = flat(frame.level_number_lower)
    e_low = tables.level_energy[lower_flat]
    e_up = tables.level_energy[flat(frame.level_number_upper)]

    if drop_autoionization:
        keep = ~(e_up > chi)  # equality and NaN-chi rows are kept
        frame = frame.take(keep)
        lower_flat = lower_flat[keep]
        e_low, e_up = e_low[keep], e_up[keep]

    return LineData(
        nu=frame.nu.astype(float),
        atomic_number=frame.atomic_number.astype(np.int64),
        ion_number=frame.ion_number.astype(np.int64),
        ionization_energy=frame.ionization_energy.astype(float),
        level_energy_lower=e_low,
        level_energy_upper=e_up,
        A_ul=frame.A_ul.astype(float),
        mass=atom_data.mass_of(frame.atomic_number),
        lower_level_flat=lower_flat,
        f_lu=frame.f_lu.astype(float),
    )


def synth_linelist(atom_data, n_lines, lam_lo=6450.0, lam_hi=6650.0, seed=7):
    """Attach a synthetic VALD-style linelist of weak-to-strong metal lines
    (the same draws, in the same order, as ``bench_lines.synth_linelist``)."""
    rng = np.random.default_rng(seed)
    zs = rng.choice([11, 12, 14, 20, 22, 24, 26, 28], size=n_lines)
    ions = rng.choice([0, 1], size=n_lines, p=[0.7, 0.3])
    wavelength = rng.uniform(lam_lo, lam_hi, n_lines)
    log_gf = rng.uniform(-5.0, 0.5, n_lines)
    e_low = rng.uniform(0.0, 5.0, n_lines)
    e_up = e_low + 12398.42 / wavelength  # eV photon energy
    j_lo = rng.integers(0, 6, n_lines) + 0.5
    atom_data.linelist_atoms = Table(
        {
            "atomic_number": zs,
            "ion_charge": ions,
            "wavelength": wavelength,
            "log_gf": log_gf,
            "e_low": e_low,
            "e_up": e_up,
            "j_lo": j_lo,
            "j_up": j_lo + 1,
            "rad": rng.uniform(6.5, 8.5, n_lines),
            "stark": rng.uniform(-7.0, -5.0, n_lines),
            "waals": rng.uniform(-8.0, -7.0, n_lines),
        }
    )
    return atom_data


def synth_molecule_linelist(atom_data, n_lines, lam_lo=6450.0, lam_hi=6650.0, seed=11):
    """Attach a synthetic VALD-style molecular linelist over the molecules
    of ``atom_data.molecule_data``: seeded draws of wavelength, gf, lower
    energy and broadening, 70 % of them with a negative (scaled-law)
    packed van der Waals parameter and the rest 0."""
    rng = np.random.default_rng(seed)
    j_lo = rng.integers(0, 40, n_lines).astype(float)
    atom_data.linelist_molecules = Table(
        {
            "molecule": rng.choice(np.asarray(atom_data.molecule_data.names), n_lines),
            "wavelength": rng.uniform(lam_lo, lam_hi, n_lines),
            "log_gf": rng.uniform(-4.0, 0.0, n_lines),
            "e_low": rng.uniform(0.0, 2.0, n_lines),
            "j_lo": j_lo,
            "j_up": j_lo + 1.0,
            "rad": rng.uniform(6.0, 8.0, n_lines),
            "stark": rng.uniform(-6.5, -4.5, n_lines),
            "waals": np.where(rng.random(n_lines) < 0.7,
                              rng.uniform(-8.0, -7.0, n_lines), 0.0),
        }
    )
    return atom_data


class DeviceLineColumns(NamedTuple):
    """A LineData's per-line columns as [L, 1] tensors of one dtype and
    device (the indices [L], int64), uploaded once per plan
    (``device_line_columns``, kept in ``pipeline.DeviceConstants``) so that
    stage 1 uploads nothing."""

    nu: torch.Tensor
    ion_p1: torch.Tensor  # charge + 1, the interior charge the electron sees
    chi: torch.Tensor  # ionization energy of the next stage, erg
    e_up: torch.Tensor
    e_lo: torch.Tensor
    A_ul: torch.Tensor
    mass: torch.Tensor
    atomic_number: torch.Tensor  # [L, 1] int64
    lower: torch.Tensor | None  # [L] int64 flat lower levels (TARDIS path)
    f_lu: torch.Tensor | None
    vald_slot: torch.Tensor | None  # [L] int64 ion slots (VALD path)
    vald_gf: torch.Tensor | None
    vald_e_low_erg: torch.Tensor | None
    vald_stark: torch.Tensor | None
    vald_waals: torch.Tensor | None


def device_line_columns(ld: LineData, dtype, device) -> DeviceLineColumns:
    """Upload a LineData's per-line columns (float64 on the host, then
    cast to ``dtype``)."""

    def col(x):
        if x is None:
            return None
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device).to(dtype)[:, None]

    def index(x):
        return None if x is None else torch.as_tensor(np.asarray(x, dtype=np.int64),
                                                      device=device)

    return DeviceLineColumns(
        nu=col(ld.nu),
        ion_p1=col(np.asarray(ld.ion_number, dtype=np.float64) + 1.0),
        chi=col(ld.ionization_energy),
        e_up=col(ld.level_energy_upper),
        e_lo=col(ld.level_energy_lower),
        A_ul=col(ld.A_ul),
        mass=col(ld.mass),
        atomic_number=index(ld.atomic_number)[:, None],
        lower=index(ld.lower_level_flat),
        f_lu=col(ld.f_lu),
        vald_slot=index(ld.vald_slot),
        vald_gf=col(ld.vald_gf),
        vald_e_low_erg=col(ld.vald_e_low_erg),
        vald_stark=col(ld.vald_stark),
        vald_waals=col(ld.vald_waals),
    )


def _columns_on(line_data, like):
    """``line_data`` as DeviceLineColumns on ``like``'s dtype and device:
    as it is when it already is, else uploaded."""
    if isinstance(line_data, DeviceLineColumns):
        return line_data
    return device_line_columns(line_data, like.dtype, like.device)


def compute_vald_gamma(line_data, state, temperatures, broadening_flags):
    """VALD-parameter broadening: radiation from A_ul, stark/vdW from the
    per-line VALD columns (linear Stark still computed for hydrogen lines),
    summed then halved (HWHM -> FWHM).

    line_data : LineData, or its DeviceLineColumns"""
    ld = _columns_on(line_data, temperatures)
    t = temperatures
    n_e = state.electron_densities

    gamma = torch.zeros((ld.nu.shape[0], t.shape[0]), dtype=t.dtype, device=t.device)
    ion_p1, chi, e_up, e_lo = ld.ion_p1, ld.chi, ld.e_up, ld.e_lo
    if "radiation" in broadening_flags:
        gamma = gamma + ld.A_ul
    if "linear_stark" in broadening_flags:
        n_eff_up = calc_n_effective(ion_p1, chi, e_up)
        n_eff_lo = calc_n_effective(ion_p1, chi, e_lo)
        g_lin = calc_gamma_linear_stark(n_eff_up, n_eff_lo, n_e[None, :])
        gamma = gamma + torch.where(ld.atomic_number == 1, g_lin, 0.0)
    if "quadratic_stark" in broadening_flags and ld.vald_stark is not None:
        gamma = gamma + calc_vald_stark_gamma(n_e[None, :], ld.vald_stark, t[None, :])
    if "van_der_waals" in broadening_flags and ld.vald_waals is not None:
        gamma = gamma + calc_vald_vdW(
            ld.vald_waals,
            t,
            ld.mass,
            e_up,
            e_lo,
            state.h_neutral_density,
            ion_p1,
            chi,
        )
    return gamma / 2.0  # HWHM to FWHM


def compute_line_quantities(
    line_data,
    state,
    temperatures,
    microturbulence_cgs,
    broadening_flags,
    use_vald_broadening=False,
):
    """Per-line per-depth quantities on the device of ``temperatures``.

    line_data : LineData, or its DeviceLineColumns (stage 1 passes the
        plan's, so that it uploads nothing)
    Returns (alpha [L, D], gamma [L, D], doppler_width [L, D]).  The
    stimulated-emission factor is the LTE closed form 1 - e^{-h nu / k T}.
    """
    ld = _columns_on(line_data, temperatures)
    t = temperatures
    nu = ld.nu  # [L, 1]
    stim = 1.0 - torch.exp(-H_CGS * nu / (K_B_CGS * t[None, :]))

    if ld.lower is not None:
        n_lower = state.level_number_density[ld.lower]
        alpha = ALPHA_COEFFICIENT * ld.f_lu * n_lower * stim
    else:
        # VALD: n_lower/g_lo = (N_ion / U) e^{-beta E_low};
        # alpha = C * gf * (N_ion/U) e^{-beta E_low} * stim
        slot = ld.vald_slot
        n_over_u = state.ion_number_density[slot] / state.partition_function[slot]
        boltz = torch.exp(-ld.vald_e_low_erg * state.beta[None, :])
        alpha = ALPHA_COEFFICIENT * ld.vald_gf * n_over_u * boltz * stim

    doppler = calc_doppler_width(nu, t[None, :], ld.mass, microturbulence_cgs)
    if use_vald_broadening:
        gamma = compute_vald_gamma(ld, state, t, broadening_flags)
        return alpha, gamma, doppler
    gamma = calc_gamma(
        atomic_number=ld.atomic_number,
        ion_number=ld.ion_p1,
        ionization_energy=ld.chi,
        upper_level_energy=ld.e_up,
        lower_level_energy=ld.e_lo,
        A_ul=ld.A_ul,
        electron_density=state.electron_densities,
        temperature=t,
        h_density=state.h_neutral_density,
        linear_stark="linear_stark" in broadening_flags,
        quadratic_stark="quadratic_stark" in broadening_flags,
        van_der_waals="van_der_waals" in broadening_flags,
        radiation="radiation" in broadening_flags,
    )
    return alpha, gamma, doppler
