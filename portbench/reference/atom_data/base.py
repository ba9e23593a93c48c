# Frozen copy of stardis_tpu_torch/atom_data/base.py at commit 9c7d618: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
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

``AtomData.to_hdf`` / ``from_hdf`` write and read the JAX package's
``stardis_tpu_atom_data_v1`` HDF5 layout (h5py, imported only by those
two calls).  carsus stores are converted to it by ``atom_data.convert``
(``convert_frames`` maps carsus-schema Tables in memory, without h5py) and
fetched by ``atom_data.download.download_atom_data``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import C_CGS, E_ESU, M_E_CGS


class Table:
    """Named NumPy columns of equal length, in row order.

    A table read from a carsus store also says which of its leading columns
    held the store's row index (``index_cols``: the level names of a
    MultiIndex, or the one named index; none for an unnamed 0..n-1 index),
    and whether the store held it as a pandas Series (``series``: one value
    column, named by the Series' name, "values" when it had none).  Column
    names are the store's column labels, so they may be numbers (the
    temperatures of the molecular tables)."""

    def __init__(self, columns: dict, index_cols=(), series=False):
        self.columns = {k: np.asarray(v) for k, v in columns.items()}
        self.index_cols = tuple(index_cols)
        self.series = bool(series)

    def __getattr__(self, name):
        if name in ("columns", "index_cols", "series"):
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
        return Table({k: v[index] for k, v in self.columns.items()}, self.index_cols,
                     self.series)

    def value_columns(self):
        """The names of the columns that are not index columns, in order."""
        return [k for k in self.columns if k not in self.index_cols]


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

    # ------------------------------------------------------------------
    # HDF5 (h5py), the JAX package's stardis_tpu_atom_data_v1 layout
    # ------------------------------------------------------------------
    def to_hdf(self, path):
        import h5py

        def put(grp, name, data):
            data = np.asarray(data)
            if data.dtype.kind in ("O", "U"):
                data = np.array(data, dtype="S16")
            grp.create_dataset(name, data=data)

        with h5py.File(path, "w") as f:
            f.attrs["format"] = HDF_FORMAT
            grp = f.create_group("atom_data")
            grp.create_dataset("atomic_number", data=self.atom_data.atomic_number)
            grp.create_dataset("symbol", data=np.array(self.atom_data.symbol, dtype="S8"))
            grp.create_dataset("mass", data=self.atom_data.mass)
            for name, table, cols in (
                ("ionization_data", self.ionization_data,
                 ("atomic_number", "ion_number", "ionization_energy")),
                ("levels", self.levels,
                 ("atomic_number", "ion_number", "level_number", "energy", "g")),
                ("lines", self.lines, LINE_COLUMNS),
            ):
                grp = f.create_group(name)
                for col in cols:
                    grp.create_dataset(col, data=table[col])
            f["levels"].create_dataset(
                "metastable", data=np.asarray(self.levels.metastable).astype(bool))

            for name, ll in (("linelist_atoms", self.linelist_atoms),
                             ("linelist_molecules", self.linelist_molecules)):
                if ll is not None:
                    grp = f.create_group(name)
                    for col, data in ll.columns.items():
                        put(grp, col, data)

            md = self.molecule_data
            if md is not None:
                grp = f.create_group("molecule_data")
                for name, temps, values in (
                    ("equilibrium_constants", md.equilibrium_temperatures,
                     md.log_equilibrium_constants),
                    ("partition_functions", md.partition_temperatures,
                     md.partition_functions),
                ):
                    sub = grp.create_group(name)
                    put(sub, "molecule", md.names)
                    sub.create_dataset("temperatures", data=np.asarray(temps, dtype=float))
                    sub.create_dataset("values", data=values)
                sub = grp.create_group("dissociation_energies")
                put(sub, "molecule", md.names)
                put(sub, "Ion1", md.ion1)
                put(sub, "Ion2", md.ion2)
                sub.create_dataset("dissociation_energy", data=md.dissociation_energies)

    @classmethod
    def from_hdf(cls, path):
        """Read a store in the stardis_tpu_atom_data_v1 layout: every table
        with the JAX package's ``from_hdf`` columns and row order, byte
        strings decoded; the molecular tables' rows follow the equilibrium
        constants' molecule order, as the JAX plasma looks them up."""
        import h5py

        def decoded(data):
            return np.array([s.decode() for s in data]) if data.dtype.kind == "S" else data

        def table(grp, cols=None):
            return Table({c: decoded(grp[c][:]) for c in (cols or grp)})

        with h5py.File(path, "r") as f:
            if f.attrs.get("format", "") != HDF_FORMAT:
                raise ValueError(
                    f"{path}: not a stardis_tpu atom-data file. carsus/pytables "
                    "files are not readable without the 'tables' package; "
                    "convert with stardis_tpu.atom_data.convert."
                )
            atom_data = table(f["atom_data"], ("atomic_number", "symbol", "mass"))
            ionization_data = table(
                f["ionization_data"], ("atomic_number", "ion_number", "ionization_energy"))
            levels = table(f["levels"], ("atomic_number", "ion_number", "level_number",
                                         "energy", "g", "metastable"))
            lines = table(f["lines"])
            linelists = [table(f[name]) if name in f else None
                         for name in ("linelist_atoms", "linelist_molecules")]
            molecule_data = None
            if "molecule_data" in f:
                molecule_data = _read_molecule_data(f["molecule_data"], decoded)
        return cls(atom_data, ionization_data, levels, lines, *linelists, molecule_data)


#: the ``format`` attribute of an atom-data store
HDF_FORMAT = "stardis_tpu_atom_data_v1"
#: the columns of the ``lines`` table that a store holds
LINE_COLUMNS = ("atomic_number", "ion_number", "level_number_lower",
                "level_number_upper", "nu", "f_lu", "A_ul", "wavelength_cm")


def _read_molecule_data(grp, decoded):
    """MoleculeData from a store's molecule_data group, rows in the
    equilibrium constants' molecule order."""
    eq, pf, de = (grp[k] for k in ("equilibrium_constants", "partition_functions",
                                   "dissociation_energies"))
    names = [str(m) for m in decoded(eq["molecule"][:])]

    def rows(sub):
        order = {m: i for i, m in enumerate(decoded(sub["molecule"][:]))}
        missing = [m for m in names if m not in order]
        if missing:
            raise KeyError(f"molecule_data/{sub.name}: no rows for {missing}")
        return np.array([order[m] for m in names], dtype=np.int64)

    pf_rows, de_rows = rows(pf), rows(de)
    energy_cols = [c for c in de if c not in ("molecule", "Ion1", "Ion2")]
    energies = (de[energy_cols[0]][:][de_rows].astype(float) if energy_cols
                else np.full(len(names), np.nan))
    return MoleculeData(
        names=names,
        equilibrium_temperatures=eq["temperatures"][:],
        log_equilibrium_constants=eq["values"][:],
        partition_temperatures=pf["temperatures"][:],
        partition_functions=pf["values"][:][pf_rows],
        ion1=[str(s) for s in decoded(de["Ion1"][:])[de_rows]],
        ion2=[str(s) for s in decoded(de["Ion2"][:])[de_rows]],
        dissociation_energies=energies,
    )

