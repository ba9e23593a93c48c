# Frozen copy of stardis_tpu_torch/plasma/molecules.py at commit 9c7d618,
# trimmed to what the benchmark reaches: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""Diatomic molecular chemistry (PyTorch port of
``stardis_tpu/plasma/molecules.py``).

* The K(T) cubic-spline and U_mol(T) linear interpolations depend only on
  the model temperatures, so they run on the host (SciPy / NumPy), giving
  dense [molecule, depth] tables: at the plan model's temperatures when
  the plan is built, and at a batch member's or a served request's own
  temperatures from the samples the plan keeps (``MoleculeTables.rows_at``,
  one spline over every molecule, evaluated for all models at once).
* The equilibrium densities (closed-form quadratics, or the opt-in coupled
  network) and the molecular line quantities run on the device from the
  plasma state.
"""

from __future__ import annotations

import dataclasses
import logging
import re
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
from ..util.species import element_symbol2atomic_number

logger = logging.getLogger(__name__)

# ideal-gas conversion: K_n [cm^-3] = 10^K_p * Pa / (k_B T); 1 Pa = 10 dyn/cm^2
PA_TO_CGS = 10.0


def parse_molecular_ion(symbol: str):
    """'H2+' style constituent symbol -> (atomic_number, charge)."""
    m = re.match(r"([A-Z][a-z]?)(\+*)(\-*)$", symbol.strip())
    if not m:
        raise ValueError(f"cannot parse molecular constituent {symbol!r}")
    z = element_symbol2atomic_number(m.group(1))
    charge = len(m.group(2)) - len(m.group(3))
    return z, charge


class MoleculeRows(NamedTuple):
    """K(T) and U(T) at given temperatures: [..., M, D] each, one leading
    axis per axis of the temperatures before the depth axis ([M, D] for
    one model, [B, M, D] for a batch)."""

    k_density: np.ndarray  # number-density equilibrium constants [cm^-3]
    partition_function: np.ndarray


@dataclasses.dataclass
class MoleculeSamples:
    """The temperature-independent part of the molecular tables: one
    cubic spline of log10 K_p [Pa] over every molecule (built once) and
    the U(T) samples, evaluated at any temperatures by ``rows``."""

    log_kp: object  # scipy CubicSpline over the [M, K] samples (axis=1)
    partition_temperatures: np.ndarray  # [P] K, ascending
    partition_functions: np.ndarray  # [M, P]

    @classmethod
    def from_samples(cls, equilibrium_temperatures, log_equilibrium_constants,
                     partition_temperatures, partition_functions):
        from scipy.interpolate import CubicSpline

        return cls(
            log_kp=CubicSpline(np.asarray(equilibrium_temperatures, dtype=float),
                               np.asarray(log_equilibrium_constants, dtype=float),
                               axis=1, extrapolate=True),
            partition_temperatures=np.asarray(partition_temperatures, dtype=float),
            partition_functions=np.asarray(partition_functions, dtype=float),
        )

    def rows(self, temperatures) -> MoleculeRows:
        """K(T) and U(T) of every molecule at ``temperatures`` ([D], or
        [B, D] for a batch), in one evaluation: the spline, and the linear
        interpolation of U as ``np.interp`` computes it (its slope form,
        clamped to the end samples outside them), so a model's rows have
        the same bits in any batch and equal one ``np.interp`` per
        molecule."""
        temps = np.asarray(temperatures, dtype=float)
        t = temps.reshape(-1)
        k = (10.0 ** self.log_kp(t)) * PA_TO_CGS / (K_B_CGS * t)  # [M, n]
        xp, fp = self.partition_temperatures, self.partition_functions
        j = np.clip(np.searchsorted(xp, t, side="right") - 1, 0, len(xp) - 2)
        slopes = (fp[:, 1:] - fp[:, :-1]) / (xp[1:] - xp[:-1])
        u = slopes[:, j] * (t - xp[j]) + fp[:, j]
        u = np.where(t >= xp[-1], fp[:, -1:], np.where(t < xp[0], fp[:, :1], u))

        def lead(x):  # [M, ..., D] -> [..., M, D]
            return np.moveaxis(x.reshape(x.shape[:1] + temps.shape), 0, -2)

        return MoleculeRows(lead(k), lead(u))


@dataclasses.dataclass
class MoleculeTables:
    """Host-prepared molecular data for a fixed temperature grid."""

    names: list  # [M]
    ion1_slot: np.ndarray  # [M]
    ion2_slot: np.ndarray  # [M]
    homonuclear: np.ndarray  # [M] bool
    k_density: np.ndarray  # [M, D] number-density equilibrium constant
    partition_function: np.ndarray  # [M, D]
    mass: np.ndarray  # [M] g (sum of constituent masses)
    included: np.ndarray  # [M] bool (False -> zero density)
    # K(T) and U(T) at other temperatures (a batch member's, a served
    # request's); None for tables carried over without their samples
    samples: MoleculeSamples | None = None

    @property
    def n_molecules(self):
        return len(self.names)

    def index_of(self, name):
        return self.names.index(name)

    def rows_at(self, temperatures) -> MoleculeRows:
        """K(T) and U(T) at ``temperatures`` ([D] or [B, D]): at the tables'
        own temperatures, their k_density and partition_function bit for
        bit."""
        if self.samples is None:
            raise ValueError(
                "these molecular tables carry no K(T) / U(T) samples: build the plan "
                "with build_simulation_plan, or pass the atom data to "
                "pipeline.plan_from_reference"
            )
        return self.samples.rows(temperatures)


def build_molecule_tables(atom_data, tables, temperatures) -> MoleculeTables:
    """Interpolate the K(T) and U(T) tables onto the model temperatures;
    the tables keep their samples (``MoleculeTables.rows_at``)."""
    md = atom_data.molecule_data
    if md is None:
        raise ValueError(
            "No molecular data in atomic data. Provide Barklem & Collet 2016 "
            "tables (equilibrium constants, partition functions, "
            "dissociation energies)."
        )
    samples = MoleculeSamples.from_samples(
        md.equilibrium_temperatures, md.log_equilibrium_constants,
        md.partition_temperatures, md.partition_functions)
    rows = samples.rows(temperatures)

    names, i1, i2, homo, mass, included = [], [], [], [], [], []
    for m, molecule in enumerate(md.names):
        names.append(molecule)
        ok = True
        z1 = c1 = z2 = c2 = 0
        try:
            z1, c1 = parse_molecular_ion(md.ion1[m])
            z2, c2 = parse_molecular_ion(md.ion2[m])
        except ValueError:
            ok = False
        if ok and (c1 == -1 or c2 == -1):
            logger.warning(
                "Negative ionic molecules not supported. Assuming no %s.", molecule
            )
            ok = False
        slot1 = slot2 = 0
        if ok:
            try:
                slot1 = tables.slot_of(z1, c1)
                slot2 = tables.slot_of(z2, c2)
            except KeyError:
                logger.warning(
                    "Constituents of %s not in included elements; assuming "
                    "no %s.", molecule, molecule,
                )
                ok = False

        i1.append(slot1)
        i2.append(slot2)
        homo.append(ok and (z1 == z2 and c1 == c2))
        m1 = float(atom_data.mass_of([z1])[0]) if ok else 0.0
        m2 = float(atom_data.mass_of([z2])[0]) if ok else 0.0
        mass.append(m1 + m2)
        included.append(ok)

    return MoleculeTables(
        names=names,
        ion1_slot=np.asarray(i1, dtype=np.int64),
        ion2_slot=np.asarray(i2, dtype=np.int64),
        homonuclear=np.asarray(homo, dtype=bool),
        k_density=rows.k_density,
        partition_function=rows.partition_function,
        mass=np.asarray(mass),
        included=np.asarray(included, dtype=bool),
        samples=samples,
    )


class DeviceMoleculeTables(NamedTuple):
    """A MoleculeTables' arrays on one device, uploaded once per plan
    (``device_molecule_tables``, kept in ``pipeline.DeviceConstants``)."""

    i1: torch.Tensor  # [M] int64 constituent slots
    i2: torch.Tensor  # [M] int64
    k: torch.Tensor  # [M, D] number-density equilibrium constants
    homo: torch.Tensor  # [M, 1] bool
    included: torch.Tensor  # [M, 1] bool
    inc1: torch.Tensor  # [S, M] 0/1 incidence of i1 (``_incidence``)
    inc2: torch.Tensor  # [S, M] 0/1 incidence of i2
    u_mol: torch.Tensor  # [M, D] molecular partition functions


def _incidence(slots, n_slots, dtype, device):
    """[S, M] 0/1 matrix: column m has its 1 in row slots[m]."""
    inc = np.zeros((n_slots, len(slots)))
    inc[np.asarray(slots), np.arange(len(slots))] = 1.0
    return torch.as_tensor(inc, device=device).to(dtype)


def device_molecule_tables(mt: MoleculeTables, n_slots, dtype, device) -> DeviceMoleculeTables:
    """Upload ``mt`` for a plasma of ``n_slots`` ion slots."""
    def real(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device).to(dtype)

    return DeviceMoleculeTables(
        i1=torch.as_tensor(mt.ion1_slot, device=device),
        i2=torch.as_tensor(mt.ion2_slot, device=device),
        k=real(mt.k_density),
        homo=torch.as_tensor(mt.homonuclear, device=device)[:, None],
        included=torch.as_tensor(mt.included, device=device)[:, None],
        inc1=_incidence(mt.ion1_slot, n_slots, dtype, device),
        inc2=_incidence(mt.ion2_slot, n_slots, dtype, device),
        u_mol=real(mt.partition_function),
    )


def _tables_on(mt, like):
    """``mt`` as DeviceMoleculeTables on ``like``'s ([S, D] ion densities)
    dtype and device: as it is when it already is, else uploaded."""
    if isinstance(mt, DeviceMoleculeTables):
        return mt
    return device_molecule_tables(mt, like.shape[0], like.dtype, like.device)


def molecule_number_density(mt: MoleculeTables, state):
    """[M, D] molecular number densities, each molecule's quadratic solved
    independently against the full atomic reservoirs.

    Homonuclear AA: n_AA = 2 N^2 / (k + 4N + sqrt(k (k + 8N)));
    heteronuclear AB: n_AB = 2 N_A N_B / (k + N_A + N_B + sqrt(...)).
    The conjugate forms stay exact where n_mol << N (the textbook
    difference form cancels to 0 there), and the discriminants are scaled
    by s = k + (constituent sum), because k (k + 8N) and k^2 overflow
    float32 (k reaches ~1e22 at 10^4 K) while every scaled term is O(1).
    """
    i1, i2, k, homo, included, *_ = _tables_on(mt, state.ion_number_density)
    n1 = state.ion_number_density[i1]  # [M, D]
    n2 = state.ion_number_density[i2]

    s_aa = k + 4.0 * n1
    root_aa = torch.sqrt((k / s_aa) * ((k + 8.0 * n1) / s_aa))
    n_homo = 2.0 * (n1 / s_aa) * n1 / (root_aa + 1.0)

    s_ab = k + n1 + n2
    disc = (k / s_ab) ** 2 + 2.0 * (k / s_ab) * ((n1 + n2) / s_ab) + (
        (n1 - n2) / s_ab
    ) ** 2
    n_hetero = 2.0 * (n1 / s_ab) * n2 / (torch.sqrt(disc) + 1.0)

    n_mol = torch.where(homo, n_homo, n_hetero)
    n_mol = torch.clamp(n_mol, min=0.0)
    return torch.where(included, n_mol, torch.zeros_like(n_mol))


def _slot_sum(incidence, per_molecule):
    """[S, D] sums of [M, D] rows into their constituent slots: the
    product with a fixed 0/1 incidence matrix, as an elementwise product
    and a sum over M (deterministic, no atomics, never TF32)."""
    return (incidence[:, :, None] * per_molecule[None]).sum(dim=1)


def molecule_number_density_coupled(mt: MoleculeTables, state, n_iter: int = 400,
                                    damping: float = 0.5, return_aux: bool = False):
    """[M, D] molecular densities from the coupled network (opt-in).

    Find per-constituent-slot depletion factors x_s in (0, 1] with free
    densities n_s = x_s N_s such that N_s = n_s + sum_m nu_{s,m} n_m,
    n_m = n_A n_B / k_m (homonuclear n_A^2 / k_m, nu = 2), by a damped
    exact-per-slot Jacobi sweep: holding the other slots fixed, slot s
    solves N_s = n_s + 2 alpha_s n_s^2 + beta_s n_s with
    alpha_s = sum_{homo m} 1/k_m and beta_s = sum_{hetero m} n_other/k_m,
    x_s = 2 / (1 + beta_s + sqrt((1 + beta_s)^2 + 8 alpha_s N_s)).
    A fixed ``n_iter`` damped iterations; ionization stays at the LTE
    solution.  The per-slot sums are products with fixed host-built
    incidence matrices [S, M].
    """
    n_res = state.ion_number_density  # [S, D] undepleted reservoirs
    i1, i2, k, homo, included, inc1, inc2, _u = _tables_on(mt, n_res)
    zero = torch.zeros_like(k)
    homo_inv_k = torch.where(included & homo, 1.0 / k, zero)
    alpha = _slot_sum(inc1, homo_inv_k)  # fixed over the iterations
    hetero = included & ~homo

    x = torch.ones_like(n_res)
    for _ in range(n_iter):
        n1 = x[i1] * n_res[i1]
        n2 = x[i2] * n_res[i2]
        beta = _slot_sum(inc1, torch.where(hetero, n2 / k, zero)) + _slot_sum(
            inc2, torch.where(hetero, n1 / k, zero)
        )
        b1 = 1.0 + beta
        x_new = 2.0 / (b1 + torch.sqrt(b1 * b1 + 8.0 * alpha * n_res))
        x = (1.0 - damping) * x + damping * x_new

    n1 = x[i1] * n_res[i1]
    n2 = x[i2] * n_res[i2]
    # (n1/k)*n2 keeps intermediates at O(max): n1*n2 overflows float32
    n_m = torch.where(homo, (n1 / k) * n1, (n1 / k) * n2)
    n_m = torch.clamp(torch.where(included, n_m, zero), min=0.0)
    if return_aux:
        return n_m, x
    return n_m


@dataclasses.dataclass
class MoleculeLineData:
    """Host-prepared molecular lines in the tracing window (VALD-style)."""

    nu: np.ndarray  # [L]
    molecule_index: np.ndarray  # [L] row into MoleculeTables
    gf: np.ndarray  # [L] 10^log_gf
    e_low_erg: np.ndarray  # [L]
    e_up_erg: np.ndarray  # [L]
    A_ul: np.ndarray  # [L]
    stark: np.ndarray  # [L]
    waals: np.ndarray  # [L]
    mass: np.ndarray  # [L] molecule mass [g]

    @property
    def n_lines(self):
        return len(self.nu)


def prepare_molecule_line_data(atom_data, mt: MoleculeTables, nu_min,
                               nu_max) -> MoleculeLineData:
    """Molecular lines of ``atom_data.linelist_molecules`` in
    [nu_min, nu_max], sorted by frequency; lines of molecules the tables
    exclude are dropped."""
    ll = atom_data.linelist_molecules
    if ll is None:
        raise ValueError("atom data has no linelist_molecules")
    cols = dict(ll.columns)
    cols["nu"] = C_CGS / (np.asarray(cols["wavelength"], dtype=float) * 1e-8)
    if "e_up" not in cols:
        cols["e_up"] = cols["e_low"] + (
            H_CGS * C_CGS / (np.asarray(cols["wavelength"], dtype=float) * 1e-8)
        ) / EV_TO_ERG
    frame = Table(cols)
    frame = frame.take(np.argsort(frame.nu, kind="quicksort"))
    frame = frame.take((frame.nu >= nu_min) & (frame.nu <= nu_max))

    index_map = {name: i for i, name in enumerate(mt.names)}
    mol_index = np.array(
        [index_map.get(str(m), -1) for m in frame.molecule], dtype=np.int64
    )
    # lines of unknown or excluded molecules would get mass 0 -> inf Doppler
    keep = (mol_index >= 0) & mt.included[np.maximum(mol_index, 0)]
    if not keep.all():
        logger.warning(
            "Dropping %d molecular lines of excluded/unknown molecules",
            int((~keep).sum()),
        )
    frame = frame.take(keep)
    mol_index = mol_index[keep]
    return MoleculeLineData(
        nu=frame.nu.astype(float),
        molecule_index=mol_index,
        gf=(10.0 ** frame.log_gf).astype(float),
        e_low_erg=(frame.e_low * EV_TO_ERG).astype(float),
        e_up_erg=(frame.e_up * EV_TO_ERG).astype(float),
        A_ul=(10.0 ** frame.rad).astype(float),
        stark=frame.stark.astype(float),
        waals=frame.waals.astype(float),
        mass=mt.mass[mol_index],
    )


class DeviceMoleculeLines(NamedTuple):
    """A MoleculeLineData's columns as [L, 1] tensors (the molecule index
    [L], int64), uploaded once per plan (``device_molecule_lines``)."""

    molecule_index: torch.Tensor
    nu: torch.Tensor
    gf: torch.Tensor
    e_low_erg: torch.Tensor
    A_ul: torch.Tensor
    stark: torch.Tensor
    waals: torch.Tensor
    mass: torch.Tensor


def device_molecule_lines(mld: MoleculeLineData, dtype, device) -> DeviceMoleculeLines:
    def col(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device).to(dtype)[:, None]

    return DeviceMoleculeLines(
        molecule_index=torch.as_tensor(mld.molecule_index, device=device),
        nu=col(mld.nu), gf=col(mld.gf), e_low_erg=col(mld.e_low_erg), A_ul=col(mld.A_ul),
        stark=col(mld.stark), waals=col(mld.waals), mass=col(mld.mass),
    )


def compute_molecule_line_quantities(mld, mt, state, temperatures, microturbulence_cgs,
                                     broadening_flags, coupled: bool = False):
    """(alpha, gamma, doppler) [L, D] for molecular lines.

    mld, mt : MoleculeLineData and MoleculeTables, or their device forms
        (``device_molecule_lines``, ``device_molecule_tables``; stage 1
        passes the plan's, so that it uploads nothing)

    alpha = C gf (n_mol / U_mol) e^{-beta E_low} (1 - e^{-h nu / k T});
    gamma from the VALD columns: A_ul, the VALD Stark law, and van der
    Waals only by the scaled 10^vdW law where the packed value is negative
    (the Unsoeld path needs an atomic n_eff that molecular levels lack);
    Doppler widths from the molecule mass.
    """
    from ..opacities.broadening import calc_doppler_width, calc_vald_stark_gamma

    t = temperatures
    if not isinstance(mld, DeviceMoleculeLines):
        mld = device_molecule_lines(mld, t.dtype, t.device)
    mt = _tables_on(mt, state.ion_number_density)

    density_fn = molecule_number_density_coupled if coupled else molecule_number_density
    n_mol = density_fn(mt, state)  # [M, D]
    n_over_u = n_mol / mt.u_mol

    nu = mld.nu
    boltz = torch.exp(-mld.e_low_erg * state.beta[None, :])
    stim = 1.0 - torch.exp(-H_CGS * nu / (K_B_CGS * t[None, :]))
    alpha = ALPHA_COEFFICIENT * mld.gf * n_over_u[mld.molecule_index] * boltz * stim

    gamma = torch.zeros_like(alpha)
    if "radiation" in broadening_flags:
        gamma = gamma + mld.A_ul
    if "linear_stark" in broadening_flags or "quadratic_stark" in broadening_flags:
        gamma = gamma + calc_vald_stark_gamma(
            state.electron_densities[None, :], mld.stark, t[None, :]
        )
    if "van_der_waals" in broadening_flags:
        vdw = mld.waals
        h1 = state.h_neutral_density
        scaled = 10.0**vdw * (t[None, :] / 1e4) ** 0.38 * h1[None, :]
        gamma = gamma + torch.where(vdw < 0, scaled, torch.zeros_like(scaled))

    doppler = calc_doppler_width(nu, t[None, :], mld.mass, microturbulence_cgs)
    return alpha, gamma, doppler
