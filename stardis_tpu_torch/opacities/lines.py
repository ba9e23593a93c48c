"""Line opacity: host-side line selection (NumPy) + device-side per-line
quantities (PyTorch).

The port of ``stardis_tpu/opacities/lines.py``: lines are selected, joined
and sorted once on the host; the device computes dense [lines x depth]
alpha, gamma and Doppler widths from the plasma state.
"""

from __future__ import annotations

import dataclasses

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


def _column(x, like):
    """[L] host array -> [L, 1] tensor of ``like``'s dtype and device."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=like.device).to(
        like.dtype
    )[:, None]


def compute_vald_gamma(line_data: LineData, state, temperatures, broadening_flags):
    """VALD-parameter broadening: radiation from A_ul, stark/vdW from the
    per-line VALD columns (linear Stark still computed for hydrogen lines),
    summed then halved (HWHM -> FWHM)."""
    ld = line_data
    t = temperatures
    n_e = state.electron_densities

    gamma = torch.zeros((ld.n_lines, t.shape[0]), dtype=t.dtype, device=t.device)
    ion_p1 = _column(ld.ion_number, t) + 1.0
    chi = _column(ld.ionization_energy, t)
    e_up = _column(ld.level_energy_upper, t)
    e_lo = _column(ld.level_energy_lower, t)
    if "radiation" in broadening_flags:
        gamma = gamma + _column(ld.A_ul, t)
    if "linear_stark" in broadening_flags:
        n_eff_up = calc_n_effective(ion_p1, chi, e_up)
        n_eff_lo = calc_n_effective(ion_p1, chi, e_lo)
        g_lin = calc_gamma_linear_stark(n_eff_up, n_eff_lo, n_e[None, :])
        h_mask = torch.as_tensor(ld.atomic_number == 1, device=t.device)[:, None]
        gamma = gamma + torch.where(h_mask, g_lin, 0.0)
    if "quadratic_stark" in broadening_flags and ld.vald_stark is not None:
        gamma = gamma + calc_vald_stark_gamma(
            n_e[None, :], _column(ld.vald_stark, t), t[None, :]
        )
    if "van_der_waals" in broadening_flags and ld.vald_waals is not None:
        gamma = gamma + calc_vald_vdW(
            _column(ld.vald_waals, t),
            t,
            _column(ld.mass, t),
            e_up,
            e_lo,
            state.h_neutral_density,
            ion_p1,
            chi,
        )
    return gamma / 2.0  # HWHM to FWHM


def compute_line_quantities(
    line_data: LineData,
    state,
    temperatures,
    microturbulence_cgs,
    broadening_flags,
    use_vald_broadening=False,
):
    """Per-line per-depth quantities on the device of ``temperatures``.

    Returns (alpha [L, D], gamma [L, D], doppler_width [L, D]).  The
    stimulated-emission factor is the LTE closed form 1 - e^{-h nu / k T}.
    """
    ld = line_data
    t = temperatures
    nu = _column(ld.nu, t)  # [L, 1]
    stim = 1.0 - torch.exp(-H_CGS * nu / (K_B_CGS * t[None, :]))

    if ld.lower_level_flat is not None:
        lower = torch.as_tensor(ld.lower_level_flat, device=t.device)
        n_lower = state.level_number_density[lower]
        alpha = ALPHA_COEFFICIENT * _column(ld.f_lu, t) * n_lower * stim
    else:
        # VALD: n_lower/g_lo = (N_ion / U) e^{-beta E_low};
        # alpha = C * gf * (N_ion/U) e^{-beta E_low} * stim
        slot = torch.as_tensor(ld.vald_slot, device=t.device)
        n_over_u = state.ion_number_density[slot] / state.partition_function[slot]
        boltz = torch.exp(-_column(ld.vald_e_low_erg, t) * state.beta[None, :])
        alpha = ALPHA_COEFFICIENT * _column(ld.vald_gf, t) * n_over_u * boltz * stim

    mass = _column(ld.mass, t)
    doppler = calc_doppler_width(nu, t[None, :], mass, microturbulence_cgs)
    if use_vald_broadening:
        gamma = compute_vald_gamma(ld, state, t, broadening_flags)
        return alpha, gamma, doppler
    gamma = calc_gamma(
        atomic_number=torch.as_tensor(ld.atomic_number, device=t.device)[:, None],
        ion_number=_column(ld.ion_number, t) + 1.0,
        ionization_energy=_column(ld.ionization_energy, t),
        upper_level_energy=_column(ld.level_energy_upper, t),
        lower_level_energy=_column(ld.level_energy_lower, t),
        A_ul=_column(ld.A_ul, t),
        electron_density=state.electron_densities,
        temperature=t,
        h_density=state.h_neutral_density,
        linear_stark="linear_stark" in broadening_flags,
        quadratic_stark="quadratic_stark" in broadening_flags,
        van_der_waals="van_der_waals" in broadening_flags,
        radiation="radiation" in broadening_flags,
    )
    return alpha, gamma, doppler
