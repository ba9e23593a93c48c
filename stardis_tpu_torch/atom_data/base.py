"""Atomic data store, NumPy only.

The JAX package keeps its atomic data in pandas DataFrames
(``stardis_tpu/atom_data/base.py``).  This port keeps the same logical
tables, in the same row order, as ``Table`` objects: named NumPy columns of
equal length.

* ``atom_data``       : atomic_number, symbol, mass [g]
* ``ionization_data`` : atomic_number, ion_number, ionization_energy [erg];
                        ion_number is the charge state *produced* by the
                        ionization (H I -> H II is (1, 1))
* ``levels``          : atomic_number, ion_number, level_number, energy [erg],
                        g, metastable
* ``lines``           : atomic_number, ion_number, level_number_lower,
                        level_number_upper, nu [Hz], f_lu, A_ul [1/s],
                        wavelength_cm
* ``linelist_atoms``  : VALD-style linelist (wavelength [AA], log_gf,
                        e_low/e_up [eV], j_lo/j_up, rad/stark/waals)
* ``linelist_molecules`` : the same for molecular lines, with a
                        ``molecule`` name column instead of atomic_number /
                        ion_charge
* ``molecule_data``   : ``MoleculeData``, Barklem & Collet 2016-layout
                        molecular tables

HDF files and downloads ("other inputs", ROADMAP Queue 1) are not ported
yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import C_CGS, E_ESU, M_E_CGS


class Table:
    """Named NumPy columns of equal length, in row order."""

    def __init__(self, columns: dict):
        self.columns = {k: np.asarray(v) for k, v in columns.items()}

    def __getattr__(self, name):
        if name == "columns":
            raise AttributeError(name)
        try:
            return self.columns[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __getitem__(self, name):
        return self.columns[name]

    def __setitem__(self, name, value):
        self.columns[name] = np.asarray(value)

    def __contains__(self, name):
        return name in self.columns

    def __len__(self):
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def take(self, index) -> "Table":
        """Rows by integer index array or boolean mask."""
        return Table({k: v[index] for k, v in self.columns.items()})


def einstein_a_from_f_lu(nu, g_lower, g_upper, f_lu):
    """A_ul = (8 pi^2 e^2 nu^2) / (m_e c^3) * (g_l / g_u) * f_lu  [1/s]."""
    coeff = 8.0 * np.pi**2 * E_ESU**2 / (M_E_CGS * C_CGS**3)
    return coeff * nu**2 * (g_lower / g_upper) * f_lu


@dataclasses.dataclass
class MoleculeData:
    """Molecular tables in the Barklem & Collet 2016 layout; the JAX
    package's DataFrames as arrays, rows in ``names`` order.

    names : [M] molecule names
    equilibrium_temperatures : [Te] sample temperatures [K]
    log_equilibrium_constants : [M, Te] log10 of the pressure equilibrium
        constant in Pa
    partition_temperatures : [Tp] sample temperatures [K]
    partition_functions : [M, Tp] U(T)
    ion1, ion2 : [M] constituent symbols ('H', 'H+', ...)
    dissociation_energies : [M] eV
    """

    names: list
    equilibrium_temperatures: np.ndarray
    log_equilibrium_constants: np.ndarray
    partition_temperatures: np.ndarray
    partition_functions: np.ndarray
    ion1: list
    ion2: list
    dissociation_energies: np.ndarray


class AtomData:
    def __init__(self, atom_data: Table, ionization_data: Table,
                 levels: Table, lines: Table,
                 linelist_atoms: Table | None = None,
                 linelist_molecules: Table | None = None,
                 molecule_data: MoleculeData | None = None):
        self.atom_data = atom_data
        self.ionization_data = ionization_data
        self.levels = levels
        self.lines = lines
        self.linelist_atoms = linelist_atoms
        self.linelist_molecules = linelist_molecules
        self.molecule_data = molecule_data
        self.selected_atomic_numbers = np.asarray(
            atom_data.atomic_number, dtype=np.int64
        )

    def mass_of(self, atomic_numbers):
        """Element masses [g] for the given atomic numbers (KeyError if an
        element is absent), like ``atom_data.mass.loc[zs]``."""
        row = {int(z): i for i, z in enumerate(self.atom_data.atomic_number)}
        zs = np.asarray(atomic_numbers)
        idx = np.array([row[int(z)] for z in zs.ravel()], dtype=np.int64)
        return self.atom_data.mass[idx].reshape(zs.shape).astype(float)

    def ionization_energy(self, atomic_number, ion_number):
        """chi [erg] of the ionization that produces ``ion_number``."""
        ion = self.ionization_data
        hit = np.nonzero(
            (ion.atomic_number == atomic_number)
            & (ion.ion_number == ion_number)
        )[0]
        if len(hit) == 0:
            raise KeyError((atomic_number, ion_number))
        return float(ion.ionization_energy[hit[0]])

    def prepare_atom_data(self, selected_atomic_numbers):
        """Restrict tables to the selected elements (the JAX package's
        ``AtomData.prepare_atom_data``)."""
        sel = np.asarray(sorted(int(z) for z in selected_atomic_numbers))
        self.selected_atomic_numbers = sel

        def keep(table):
            return table.take(np.isin(table.atomic_number, sel))

        self.atom_data = keep(self.atom_data)
        self.ionization_data = keep(self.ionization_data)
        self.levels = keep(self.levels)
        self.lines = keep(self.lines)
        if self.linelist_atoms is not None:
            self.linelist_atoms = keep(self.linelist_atoms)
        return self
