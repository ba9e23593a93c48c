"""Kurucz-scale synthetic carsus-format atom data, NumPy only (the port of
``stardis_tpu/atom_data/synthetic_carsus.py``).

``build_carsus_frames`` makes the logical tables of a carsus store (10^5+
lines between actual level pairs, full level ladders for Z <= 30, a VALD
line list, Barklem & Collet-layout molecular tables) as ``Table``s in
carsus units (masses in u, energies in eV, wavelengths in AA).  It makes
the JAX package's random draws in the same order, so at the same arguments
its tables equal the JAX package's frames column by column.  They convert
in memory (``convert.convert_frames``), or are written as a store:

    python -m stardis_tpu_torch.atom_data.synthetic_carsus carsus_synth.h5
    python -m stardis_tpu_torch.atom_data.convert carsus_synth.h5 native.h5

Physical anchors are real where the package has them (NIST ionization
energies, ground-term statistical weights, atomic masses); excited-level
ladders and oscillator strengths are synthetic, drawn to kurucz-like
distributions (energies filling (0, 0.97 chi), log gf in [-7, 0.5]).

The pandas ``format="fixed"`` layout (axis0/axis1 index arrays,
block{i}_items/values, MultiIndex level and label arrays) is written and
read here with h5py, imported only by those calls; ``read_fixed_store``
also reads ``format="table"`` groups (``table_format``).
"""

from __future__ import annotations

import sys

import numpy as np

from ..util.species import ATOMIC_WEIGHTS_AMU, ELEMENT_SYMBOLS
from .base import Table
from .builtin import GROUND_G, NIST_IONIZATION_EV, build_molecule_data_hh
from .table_format import DEFAULT_KEYS, is_table_group, read_table_group, row_index

# ----------------------------------------------------------------------
# table generation (carsus units: u, eV, AA)
# ----------------------------------------------------------------------


def build_carsus_frames(
    z_max: int = 30,
    n_lines: int = 150_000,
    n_vald_lines: int = 120_000,
    levels_per_ion: int = 160,
    lam_lo_aa: float = 2500.0,
    lam_hi_aa: float = 12000.0,
    seed: int = 20240817,
    include_molecules: bool = True,
) -> dict:
    """Kurucz-scale logical tables in the carsus schema: the dict
    ``convert.convert_frames`` takes (atom_data, ionization_data, levels,
    lines, linelist_atoms, and molecule_eq / molecule_pf / molecule_de)."""
    rng = np.random.default_rng(seed)
    zs = [z for z in range(1, z_max + 1) if z in NIST_IONIZATION_EV]

    atom_data = Table(
        {
            "atomic_number": np.array(zs, dtype=np.int64),
            "symbol": np.array([ELEMENT_SYMBOLS[z - 1] for z in zs]),
            "name": np.array([ELEMENT_SYMBOLS[z - 1].lower() for z in zs]),
            "mass": np.array([ATOMIC_WEIGHTS_AMU[z] for z in zs], dtype=float),  # u
        },
        index_cols=("atomic_number",),
    )

    ion_rows = [(z, stage, chi) for z in zs
                for stage, chi in enumerate(NIST_IONIZATION_EV[z], start=1)]
    ionization_data = Table(
        {
            "atomic_number": np.array([r[0] for r in ion_rows], dtype=np.int64),
            "ion_number": np.array([r[1] for r in ion_rows], dtype=np.int64),
            "ionization_energy": np.array([r[2] for r in ion_rows], dtype=float),  # eV
        },
        index_cols=("atomic_number", "ion_number"),
        series=True,
    )

    # ---- levels: ground (real g) + synthetic ladder filling (0, 0.97chi)
    lev_rows = []
    level_bank = {}  # (z, ion) -> (energies_ev [K], gs [K])
    for z in zs:
        n_stages = len(NIST_IONIZATION_EV[z])
        gs = GROUND_G.get(z, [1, 1, 1])
        for ion in range(min(n_stages, 3)):
            chi = NIST_IONIZATION_EV[z][ion]
            count = max(8, int(levels_per_ion // (1 + ion)))
            e_exc = np.sort(rng.uniform(0.05 * chi, 0.97 * chi, count - 1))
            energies = np.concatenate([[0.0], e_exc])
            g_ground = gs[ion] if ion < len(gs) else 1
            g_exc = 2.0 * rng.integers(0, 7, count - 1) + rng.choice([1.0, 2.0], count - 1)
            g = np.concatenate([[float(g_ground)], g_exc])
            level_bank[(z, ion)] = (energies, g)
            for num, (e, gg) in enumerate(zip(energies, g)):
                lev_rows.append((z, ion, num, e, gg, num == 0))
        # ground level of the next (data-less) stage closes the Saha chain
        lev_rows.append((z, min(n_stages, 3), 0, 0.0, 1.0, True))
    lev_cols = list(zip(*lev_rows))
    levels = Table(
        {
            "atomic_number": np.array(lev_cols[0], dtype=np.int64),
            "ion_number": np.array(lev_cols[1], dtype=np.int64),
            "level_number": np.array(lev_cols[2], dtype=np.int64),
            "energy": np.array(lev_cols[3], dtype=float),
            "g": np.array(lev_cols[4], dtype=float),
            "metastable": np.array(lev_cols[5], dtype=bool),
        },
        index_cols=("atomic_number", "ion_number", "level_number"),
    )

    # ---- lines: transitions between actual level pairs, lambda in range
    hc_ev_aa = 12398.419843320025  # h*c [eV*AA]
    keys = list(level_bank.keys())
    # weight species by a kurucz-like line richness: Fe-group dominates
    richness = np.array(
        [10.0 if 21 <= z <= 28 else (3.0 if z >= 11 else 1.0) for z, _ion in keys]
    )
    weights = richness / richness.sum()

    names = ("atomic_number", "ion_number", "level_number_lower", "level_number_upper",
             "wavelength", "gf")
    parts = {name: [np.empty(0, np.float64 if name in ("wavelength", "gf") else np.int64)]
             for name in names}
    n_made = 0
    batch = max(4096, n_lines // 8)
    while n_made < n_lines:
        picks = rng.choice(len(keys), size=batch, p=weights)
        for k in np.unique(picks):
            z, ion = keys[k]
            energies, g = level_bank[(z, ion)]
            m = int((picks == k).sum())
            lo = rng.integers(0, max(1, len(energies) - 1), m)
            up = rng.integers(0, len(energies), m)
            de = energies[up] - energies[lo]
            lam = np.where(de > 0, hc_ev_aa / np.where(de > 0, de, 1.0), 0.0)
            ok = (de > 0) & (lam >= lam_lo_aa) & (lam <= lam_hi_aa)
            n_ok = int(ok.sum())
            if not n_ok:
                continue
            parts["atomic_number"].append(np.full(n_ok, z, dtype=np.int64))
            parts["ion_number"].append(np.full(n_ok, ion, dtype=np.int64))
            parts["level_number_lower"].append(lo[ok])
            parts["level_number_upper"].append(up[ok])
            parts["wavelength"].append(lam[ok])
            parts["gf"].append(g[lo[ok]] * 10.0 ** rng.uniform(-7.0, 0.5, n_ok))
            n_made += n_ok
    cut = {name: np.concatenate(parts[name])[:n_lines] for name in names}
    lines = Table({"line_id": np.arange(len(cut["gf"]), dtype=np.int64), **cut},
                  index_cols=("line_id",))

    # ---- VALD long-form linelist from a subset of the same transitions
    n_vald = min(n_vald_lines, len(lines))
    pick = rng.choice(len(lines), size=n_vald, replace=False)
    sub = {name: lines[name][pick] for name in names}
    e_low_ev = np.empty(n_vald)
    e_up_ev = np.empty(n_vald)
    g_lo = np.empty(n_vald)
    g_up = np.empty(n_vald)
    species = sub["atomic_number"] * 8 + sub["ion_number"]
    for key in np.unique(species):
        rows = np.nonzero(species == key)[0]
        energies, g = level_bank[(int(key) // 8, int(key) % 8)]
        lo, up = sub["level_number_lower"][rows], sub["level_number_upper"][rows]
        e_low_ev[rows], e_up_ev[rows] = energies[lo], energies[up]
        g_lo[rows], g_up[rows] = g[lo], g[up]
    # broadening parameters in VALD conventions: log10(gamma_rad),
    # log10(gamma_stark/n_e at 1e4 K), and the packed vdW column mixing the
    # three reference dispatch branches (scaled / Unsoeld / ABO)
    vdw_kind = rng.choice([0, 1, 2], size=n_vald, p=[0.6, 0.2, 0.2])
    waals = np.where(
        vdw_kind == 0,
        rng.uniform(-8.0, -7.0, n_vald),  # scaled 10^vdW branch
        np.where(
            vdw_kind == 1,
            np.where(rng.uniform(size=n_vald) < 0.5, 0.0,
                     rng.uniform(1.0, 3.0, n_vald)),  # zero / Unsoeld
            rng.integers(200, 1200, n_vald)
            + rng.uniform(0.2, 0.4, n_vald),  # ABO packed sigma.alpha
        ),
    )
    linelist_atoms = Table(
        {
            "atomic_number": sub["atomic_number"],
            "ion_charge": sub["ion_number"],
            "wavelength": sub["wavelength"],
            "log_gf": np.log10(sub["gf"]),
            "e_low": e_low_ev,
            "e_up": e_up_ev,
            "j_lo": (g_lo - 1.0) / 2.0,
            "j_up": (g_up - 1.0) / 2.0,
            "rad": rng.uniform(6.5, 9.0, n_vald),
            "stark": rng.uniform(-7.5, -4.5, n_vald),
            "waals": waals,
        }
    )

    frames = {
        "atom_data": atom_data,
        "ionization_data": ionization_data,
        "levels": levels,
        "lines": lines,
        "linelist_atoms": linelist_atoms,
    }
    if include_molecules:
        frames.update(molecule_frames(build_molecule_data_hh()))
    return frames


def molecule_frames(md) -> dict:
    """A ``MoleculeData`` as the three carsus molecular tables (molecule_eq,
    molecule_pf, molecule_de), each indexed by molecule; the two
    temperature tables' columns are their temperatures."""
    names = np.asarray(md.names)

    def by_temperature(temps, values):
        return Table({"molecule": names,
                      **{float(t): values[:, j] for j, t in enumerate(temps)}},
                     index_cols=("molecule",))

    return {
        "molecule_eq": by_temperature(md.equilibrium_temperatures,
                                      md.log_equilibrium_constants),
        "molecule_pf": by_temperature(md.partition_temperatures, md.partition_functions),
        "molecule_de": Table({"molecule": names, "Ion1": np.asarray(md.ion1),
                              "Ion2": np.asarray(md.ion2),
                              "dissociation_energy": md.dissociation_energies},
                             index_cols=("molecule",)),
    }


# ----------------------------------------------------------------------
# pandas fixed-format HDF5 writer/reader (h5py, no PyTables)
# ----------------------------------------------------------------------

def _to_bytes(x):
    return np.array([str(v).encode() for v in x], dtype="S32")


def _kind_of(values):
    return {"i": b"integer", "u": b"integer", "f": b"float", "b": b"bool", "S": b"string",
            "U": b"string", "O": b"string"}.get(np.asarray(values).dtype.kind, b"string")


def _encode(values):
    values = np.asarray(values)
    return _to_bytes(values) if values.dtype.kind in ("U", "O") else values


def _write_regular_index(grp, name, values, label=None):
    grp.attrs[f"{name}_variety"] = b"regular"
    ds = grp.create_dataset(name, data=_encode(values))
    ds.attrs["kind"] = _kind_of(values)
    if label is not None:
        ds.attrs["name"] = str(label).encode()


def _write_row_index(grp, name, table):
    """The row index under ``name`` (a frame's axis1, a Series' index): a
    MultiIndex as sorted levels and codes, one index column as itself,
    none as 0..n-1."""
    cols = table.index_cols
    if len(cols) > 1:
        grp.attrs[f"{name}_variety"] = b"multi"
        grp.attrs[f"{name}_nlevels"] = len(cols)
        for i, col in enumerate(cols):
            lev, codes = np.unique(table[col], return_inverse=True)
            ds = grp.create_dataset(f"{name}_level{i}", data=_encode(lev))
            ds.attrs["kind"] = _kind_of(lev)
            ds.attrs["name"] = str(col).encode()
            lab = grp.create_dataset(f"{name}_label{i}", data=codes.astype(np.int64))
            lab.attrs["kind"] = b"integer"
    elif cols:
        _write_regular_index(grp, name, table[cols[0]], None if cols[0] == "index" else cols[0])
    else:
        _write_regular_index(grp, name, np.arange(len(table)))


def _write_frame(f, key, table):
    grp = f.create_group(key)
    grp.attrs["pandas_type"] = b"frame"
    grp.attrs["pandas_version"] = b"0.15.2"
    grp.attrs["encoding"] = b"UTF-8"
    grp.attrs["errors"] = b"strict"
    grp.attrs["ndim"] = 2
    labels = table.value_columns()
    _write_regular_index(grp, "axis0", np.asarray(labels))
    _write_row_index(grp, "axis1", table)
    # one block per dtype family, mirroring the pandas block manager
    fams = {}
    for col in labels:
        fam = {"i": "int", "u": "int", "f": "float", "b": "bool"}.get(
            table[col].dtype.kind, "string")
        fams.setdefault(fam, []).append(col)
    grp.attrs["nblocks"] = len(fams)
    for i, (fam, cols) in enumerate(sorted(fams.items())):
        # the column labels keep their dtype (the molecular tables' are
        # float temperatures), so the reader's keys match axis0
        items = grp.create_dataset(f"block{i}_items", data=_encode(np.asarray(cols)))
        items.attrs["kind"] = _kind_of(np.asarray(cols))
        if fam == "string":
            arr = np.stack([_to_bytes(table[c]) for c in cols])
        else:
            arr = np.stack([table[c] for c in cols])
        vals = grp.create_dataset(f"block{i}_values", data=arr)
        vals.attrs["transposed"] = True


def _write_series(f, key, table):
    grp = f.create_group(key)
    grp.attrs["pandas_type"] = b"series"
    grp.attrs["pandas_version"] = b"0.15.2"
    grp.attrs["encoding"] = b"UTF-8"
    grp.attrs["errors"] = b"strict"
    (name,) = table.value_columns()
    _write_row_index(grp, "index", table)
    values = table[name]
    ds = grp.create_dataset("values", data=_encode(values))
    ds.attrs["kind"] = _kind_of(values)
    if name != "values":
        ds.attrs["name"] = str(name).encode()


def write_store(frames: dict, path, key_map=None):
    """Write logical Tables as a pandas fixed-format HDF5 store (h5py), at
    the carsus keys (``table_format.DEFAULT_KEYS``, molecules under
    ``molecules/``; ``key_map`` overrides a logical name's key)."""
    import h5py

    keys = dict(DEFAULT_KEYS, **(key_map or {}))
    with h5py.File(path, "w") as f:
        for logical, table in frames.items():
            key = keys.get(logical, logical)
            if table.series:
                _write_series(f, key, table)
            else:
                _write_frame(f, key, table)


def _attr_str(obj, name, default=None):
    v = obj.attrs.get(name, default)
    return v.decode() if isinstance(v, bytes) else v


def _decode(values):
    values = np.asarray(values)
    if values.dtype.kind == "S":
        return np.array([v.decode() for v in values])
    return values


def _label(value):
    """A column label as a Python scalar (str, int or float)."""
    return value.item() if isinstance(value, np.generic) else value


def _read_index(grp, name):
    """({column: values}, index_cols) of a stored index."""
    if _attr_str(grp, f"{name}_variety", "regular") == "multi":
        cols = {}
        for i in range(int(grp.attrs[f"{name}_nlevels"])):
            ds = grp[f"{name}_level{i}"]
            codes = np.asarray(grp[f"{name}_label{i}"][...], np.int64)
            cols[_attr_str(ds, "name")] = _decode(ds[...])[codes]
        return cols, tuple(cols)
    ds = grp[name]
    return row_index(_decode(ds[...]), _attr_str(ds, "name"))


def read_store_group(grp) -> Table:
    """The Table of one pandas fixed-format group."""
    ptype = _attr_str(grp, "pandas_type")
    if ptype == "series":
        index, cols = _read_index(grp, "index")
        ds = grp["values"]
        name = _attr_str(ds, "name")
        return Table({**index, "values" if name is None else name: _decode(ds[...])}, cols,
                     series=True)
    if ptype != "frame":
        raise ValueError(
            f"unsupported pandas_type {ptype!r} (fixed-format frames/series here; "
            "table-format groups route to atom_data.table_format)"
        )
    labels = [_label(c) for c in _decode(grp["axis0"][...])]
    index, cols = _read_index(grp, "axis1")
    data = {}
    for i in range(int(grp.attrs["nblocks"])):
        items = _decode(grp[f"block{i}_items"][...])
        vals = grp[f"block{i}_values"][...]
        if vals.ndim == 1:
            vals = vals.reshape(1, -1)
        for j, c in enumerate(items):
            data[_label(c)] = _decode(vals[j])
    return Table({**index, **{c: data[c] for c in labels}}, cols)


def read_fixed_store(path) -> dict:
    """Every pandas HDFStore group of the file, as Tables keyed by store
    path: ``fixed``-format groups by ``read_store_group``, ``table``-format
    (PyTables Table) groups by ``table_format.read_table_group``; a store
    may mix the two."""
    import h5py

    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Group) and "pandas_type" in obj.attrs:
            out[name] = (read_table_group(obj) if is_table_group(obj)
                         else read_store_group(obj))

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) not in (1, 2):
        print("usage: python -m stardis_tpu_torch.atom_data.synthetic_carsus "
              "<out.h5> [n_lines]", file=sys.stderr)
        return 2
    n_lines = int(argv[1]) if len(argv) == 2 else 150_000
    frames = build_carsus_frames(n_lines=n_lines)
    write_store(frames, argv[0])
    print(
        f"wrote carsus-format store {argv[0]}: {len(frames['atom_data'])} elements, "
        f"{len(frames['levels'])} levels, {len(frames['lines'])} lines, "
        f"{len(frames['linelist_atoms'])} VALD lines"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
