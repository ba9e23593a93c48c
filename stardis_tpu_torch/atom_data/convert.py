"""carsus/TARDIS atom data -> the stardis_tpu_atom_data_v1 HDF5 layout,
NumPy only (the port of ``stardis_tpu/atom_data/convert.py``).

The reference reads ``kurucz_cd23_chianti_H_He.h5``, a pandas HDFStore
written by carsus.  This package keeps atom data in a plain h5py layout
(``atom_data/base.py``), and this module bridges the two:

    python -m stardis_tpu_torch.atom_data.convert kurucz_cd23.h5 native.h5

Field mapping (carsus store key -> native table, with unit conversions):

    /atom_data            symbol, mass [u]      -> mass [g] (x AMU)
    /ionization_data      ionization_energy [eV]-> [erg]
    /levels               energy [eV], g,       -> energy [erg]
                          metastable
    /lines                wavelength [AA], f_lu -> nu [Hz], f_lu, A_ul [1/s],
                          (A_ul or gf variants)    wavelength_cm
    /linelist_atoms       VALD long/short form  -> passed through unchanged
    /linelist_molecules
    /molecules/equilibrium_constants  log10 Kp [Pa] vs T -> MoleculeData
    /molecules/partition_functions    U vs T
    /molecules/dissociation_energies  Ion1/Ion2 + D0 [eV]

``convert_frames`` maps the logical tables (``Table``s, as
``load_carsus_store`` reads them or ``synthetic_carsus.build_carsus_frames``
makes them) in memory and needs no h5py; reading and writing the files
does (imported by those calls).  The store is read by the h5py readers of
both pandas layouts (``synthetic_carsus.read_fixed_store``).
"""

from __future__ import annotations

import sys

import numpy as np

from ..constants import AMU_CGS, C_CGS, EV_TO_ERG
from .base import AtomData, MoleculeData, Table, einstein_a_from_f_lu

#: HDFStore keys probed for each logical table (first hit wins): carsus
#: has moved a few of these between versions
KEY_ALIASES = {
    "atom_data": ("atom_data", "atom_masses", "basic_atom_data"),
    "ionization_data": ("ionization_data",),
    "levels": ("levels", "levels_data"),
    "lines": ("lines", "lines_data"),
    "linelist_atoms": ("linelist_atoms",),
    "linelist_molecules": ("linelist_molecules",),
    "molecule_eq": ("molecules/equilibrium_constants", "molecule_data/equilibrium_constants"),
    "molecule_pf": ("molecules/partition_functions", "molecule_data/partition_functions"),
    "molecule_de": ("molecules/dissociation_energies", "molecule_data/dissociation_energies"),
}
LEVEL_INDEX = ("atomic_number", "ion_number", "level_number")
LINE_INTS = ("atomic_number", "ion_number", "level_number_lower", "level_number_upper")


def _index_level(table, i):
    """Level ``i`` of a table's row index (0..n-1 where it has none)."""
    if i < len(table.index_cols):
        return table[table.index_cols[i]]
    if i == 0 and not table.index_cols:
        return np.arange(len(table))
    raise ValueError(f"table has {len(table.index_cols)} index levels, needs {i + 1}")


def convert_frames(frames: dict) -> AtomData:
    """Map carsus-schema Tables to a native AtomData.

    ``frames`` keys follow KEY_ALIASES' logical names; only ``atom_data``,
    ``ionization_data`` and ``levels`` are required.  Units are detected
    as the JAX package's converter detects them (masses above 1e-10 are u,
    ionization energies above 1e-6 eV, level energies eV where the largest
    |energy| is above 1e-6); f_lu is taken, else gf / g_lower; A_ul taken,
    else derived from f_lu; a line whose level is missing gets g = NaN.
    """
    atoms = frames["atom_data"]
    for col in ("symbol", "mass"):
        if col not in atoms:
            raise ValueError(f"atom_data table lacks a '{col}' column")
    # carsus masses are in u; anything above ~1e-10 is clearly not grams
    mass = atoms["mass"].astype(float)
    if np.nanmax(mass) > 1e-10:
        mass = mass * AMU_CGS
    atom_data = Table({"atomic_number": _index_level(atoms, 0).astype(int),
                       "symbol": atoms["symbol"], "mass": mass})

    ion = frames["ionization_data"]
    if "ionization_energy" in ion:
        chi = ion["ionization_energy"]
    else:  # a Series under another name
        (name,) = ion.value_columns()
        chi = ion[name]
    chi = chi.astype(float)
    # carsus stores eV; erg values would be < 1e-9
    if np.nanmax(chi) > 1e-6:
        chi = chi * EV_TO_ERG
    ionization_data = Table({"atomic_number": _index_level(ion, 0),
                             "ion_number": _index_level(ion, 1), "ionization_energy": chi})

    levels = frames["levels"]
    for col in ("energy", "g"):
        if col not in levels:
            raise ValueError(f"levels table lacks a '{col}' column")
    energy = levels["energy"].astype(float)
    if np.nanmax(np.abs(energy)) > 1e-6:
        energy = energy * EV_TO_ERG
    metastable = (levels["metastable"] if "metastable" in levels
                  else np.zeros(len(levels), dtype=bool))
    levels = Table({**{name: _index_level(levels, i) for i, name in enumerate(LEVEL_INDEX)},
                    "energy": energy, "g": levels["g"].astype(float),
                    "metastable": metastable.astype(bool)})

    lines_src = frames.get("lines")
    if lines_src is not None and len(lines_src):
        lines = lines_src  # its index columns are columns already
        # wavelength: carsus 'wavelength' is AA (kurucz); wavelength_cm is
        # taken as it is when present
        if "wavelength_cm" in lines:
            wl_cm = lines["wavelength_cm"].astype(float)
        else:
            wl_cm = lines["wavelength"].astype(float) * 1e-8
        nu = lines["nu"] if "nu" in lines else C_CGS / wl_cm
        if "f_lu" in lines:
            f_lu = lines["f_lu"].astype(float)
        elif "gf" in lines:
            f_lu = lines["gf"].astype(float) / _level_g(levels, lines, "level_number_lower")
        else:
            raise ValueError("lines table lacks f_lu/gf columns")
        if "A_ul" in lines:
            a_ul = lines["A_ul"].astype(float)
        else:
            g_lo = _level_g(levels, lines, "level_number_lower")
            g_up = _level_g(levels, lines, "level_number_upper")
            a_ul = einstein_a_from_f_lu(np.asarray(nu), g_lo, g_up, f_lu)
        lines = Table({
            **{col: lines[col].astype(int) for col in LINE_INTS},
            "nu": np.asarray(nu, dtype=float),
            "f_lu": np.asarray(f_lu, dtype=float),
            "A_ul": np.asarray(a_ul, dtype=float),
            "wavelength_cm": np.asarray(wl_cm, dtype=float),
        })
    else:
        lines = Table({**{col: np.empty(0, dtype=int) for col in LINE_INTS},
                       **{col: np.empty(0) for col in ("nu", "f_lu", "A_ul", "wavelength_cm")}})

    def passthrough(name):
        ll = frames.get(name)
        if ll is None:
            return None
        return Table({c: ll[c] for c in ll.value_columns()})

    molecule_data = None
    if frames.get("molecule_eq") is not None:
        molecule_data = molecule_data_from_frames(
            frames["molecule_eq"], frames["molecule_pf"], frames["molecule_de"])

    return AtomData(atom_data, ionization_data, levels, lines,
                    linelist_atoms=passthrough("linelist_atoms"),
                    linelist_molecules=passthrough("linelist_molecules"),
                    molecule_data=molecule_data)


def _level_g(levels, lines, level_col):
    """g of each line's level (atomic_number, ion_number, ``level_col``);
    NaN where the levels table has no such level, as pandas' reindex."""
    def key(z, ion, level):
        return ((np.asarray(z).astype(np.int64) << 42) | (np.asarray(ion).astype(np.int64) << 21)
                | np.asarray(level).astype(np.int64))

    lev = key(*(levels[c] for c in LEVEL_INDEX))
    want = key(lines["atomic_number"], lines["ion_number"], lines[level_col])
    g = np.full(len(want), np.nan)
    if len(lev):
        order = np.argsort(lev, kind="stable")
        rows = order[np.searchsorted(lev, want, sorter=order).clip(max=len(lev) - 1)]
        hit = lev[rows] == want
        g[hit] = levels["g"][rows[hit]]
    return g


def molecule_data_from_frames(eq, pf, de) -> MoleculeData:
    """MoleculeData of the Barklem & Collet-layout tables, each indexed by
    molecule: the temperature tables' column labels are their
    temperatures; the partition functions' and dissociation energies' rows
    follow the equilibrium constants' molecule order."""
    names = [str(m) for m in _index_level(eq, 0)]

    def rows(table):
        order = {str(m): i for i, m in enumerate(_index_level(table, 0))}
        missing = [m for m in names if m not in order]
        if missing:
            raise KeyError(f"molecular table has no rows for {missing}")
        return np.array([order[m] for m in names], dtype=np.int64)

    def by_temperature(table, row):
        cols = table.value_columns()
        values = np.stack([np.asarray(table[c], dtype=float) for c in cols], axis=1)
        return np.array([float(c) for c in cols]), values[row]

    eq_t, eq_v = by_temperature(eq, np.arange(len(names)))
    pf_t, pf_v = by_temperature(pf, rows(pf))
    de_rows = rows(de)
    energy_cols = [c for c in de.value_columns() if c not in ("Ion1", "Ion2")]
    return MoleculeData(
        names=names,
        equilibrium_temperatures=eq_t,
        log_equilibrium_constants=eq_v,
        partition_temperatures=pf_t,
        partition_functions=pf_v,
        ion1=[str(s) for s in de["Ion1"][de_rows]],
        ion2=[str(s) for s in de["Ion2"][de_rows]],
        dissociation_energies=(de[energy_cols[0]][de_rows].astype(float) if energy_cols
                               else np.full(len(names), np.nan)),
    )


def load_carsus_store(path) -> dict:
    """A carsus store's logical Tables: both pandas HDFStore layouts
    (``format="fixed"`` and ``format="table"`` groups, mixed or not) read
    by the h5py readers of ``synthetic_carsus.read_fixed_store``."""
    from .synthetic_carsus import read_fixed_store

    raw = read_fixed_store(path)
    frames = {}
    for logical, aliases in KEY_ALIASES.items():
        for alias in aliases:
            if alias in raw:
                frames[logical] = raw[alias]
                break
    missing = [k for k in ("atom_data", "ionization_data", "levels") if k not in frames]
    if missing:
        raise ValueError(
            f"{path}: carsus store lacks required tables {missing}; found keys {sorted(raw)}"
        )
    return frames


def convert(src_path, dst_path) -> AtomData:
    """carsus store -> native h5py file; returns the AtomData."""
    adata = convert_frames(load_carsus_store(src_path))
    adata.to_hdf(dst_path)
    return adata


def _species_counts(z, ion):
    """{"Z_ion": count}, species in ascending (Z, ion) order."""
    if not len(z):
        return {}
    pairs, counts = np.unique(np.stack([np.asarray(z), np.asarray(ion)], axis=1), axis=0,
                              return_counts=True)
    return {f"{a}_{b}": int(n) for (a, b), n in zip(pairs, counts)}


def verify_report(adata: AtomData) -> dict:
    """Per-species inventory + value checksums of a converted store.

    The converter's auditable fingerprint: level/line counts per (Z, ion),
    float checksums over the physical columns (energies, f_lu, nu, which
    any unit-conversion mistake moves; NaN skipped), and headline
    ionization energies / masses in the original units (eV / u) to hold
    against published values.
    """
    levels, lines = adata.levels, adata.lines
    return {
        "n_elements": int(len(adata.atom_data)),
        "z_min": int(adata.atom_data.atomic_number.min()),
        "z_max": int(adata.atom_data.atomic_number.max()),
        "n_levels": int(len(levels)),
        "n_lines": int(len(lines)),
        "n_linelist_atoms": 0 if adata.linelist_atoms is None else int(len(adata.linelist_atoms)),
        "n_linelist_molecules": (0 if adata.linelist_molecules is None
                                 else int(len(adata.linelist_molecules))),
        "has_molecule_data": adata.molecule_data is not None,
        "levels_per_species": _species_counts(levels.atomic_number, levels.ion_number),
        "lines_per_species": _species_counts(lines.atomic_number, lines.ion_number),
        # unit-conversion-sensitive checksums (native cgs columns)
        "checksum_level_energy_erg": float(np.nansum(levels["energy"])) if len(levels) else 0.0,
        "checksum_level_g": float(np.nansum(levels["g"])) if len(levels) else 0.0,
        "checksum_f_lu": float(np.nansum(lines["f_lu"])) if len(lines) else 0.0,
        "checksum_nu_hz": float(np.nansum(lines["nu"])) if len(lines) else 0.0,
        # headline values in the original units for eyeball checks
        "ionization_ev": {
            f"{z}_{i}": round(float(chi) / EV_TO_ERG, 4)
            for z, i, chi in zip(adata.ionization_data.atomic_number,
                                 adata.ionization_data.ion_number,
                                 adata.ionization_data.ionization_energy)
            if (z, i) in ((1, 1), (2, 1), (2, 2), (26, 1), (26, 2))
        },
        "mass_u": {
            str(z): round(float(m) / AMU_CGS, 4)
            for z, m in zip(adata.atom_data.atomic_number, adata.atom_data.mass)
            if z in (1, 2, 26)
        },
    }


def verify_against_expected(report: dict, expected: dict) -> list:
    """Compare a verify_report against a committed expectation table.

    Returns a list of human-readable failure strings (empty = pass).  Two
    kinds of expectation:

    * structural pins that carsus documentation states outright
      (``z_range``, ``ionization_ev`` with ``tol_ev``, ``mass_u`` with
      ``tol_u``, ``totals`` {key: [lo, hi]} count ranges);
    * an optional ``exact`` block (full per-species counts + checksums)
      recorded by ``--record`` from the first verified conversion of a
      genuine store.
    """
    fails = []
    zr = expected.get("z_range")
    if zr and not (report["z_min"] == zr[0] and report["z_max"] == zr[1]):
        fails.append(f"element range {report['z_min']}..{report['z_max']} != "
                     f"expected {zr[0]}..{zr[1]}")
    tol_ev = float(expected.get("tol_ev", 0.01))
    for key, val in (expected.get("ionization_ev") or {}).items():
        got = report["ionization_ev"].get(key)
        if got is None or abs(got - val) > tol_ev:
            fails.append(f"ionization {key}: {got} eV != expected {val} +- {tol_ev}")
    tol_u = float(expected.get("tol_u", 0.001))
    for key, val in (expected.get("mass_u") or {}).items():
        got = report["mass_u"].get(key)
        if got is None or abs(got - val) > tol_u:
            fails.append(f"mass Z={key}: {got} u != expected {val} +- {tol_u}")
    for key, (lo, hi) in (expected.get("totals") or {}).items():
        got = report.get(key)
        if got is None or not (lo <= got <= hi):
            fails.append(f"{key}: {got} outside expected [{lo}, {hi}]")
    for key, val in (expected.get("exact") or {}).items():
        got = report.get(key)
        if isinstance(val, float):
            ok = got is not None and abs(got - val) <= 1e-9 * max(abs(val), 1.0)
        else:
            ok = got == val
        if not ok:
            fails.append(f"exact.{key}: {got!r} != recorded {val!r}")
    return fails


def _builtin_expected(src_path):
    """The bundled expectation table matching the source file's name
    (kurucz_cd23_chianti_H_He), or None."""
    import json
    from pathlib import Path

    stem = Path(src_path).name
    for name in ("kurucz_cd23_chianti_H_He",):
        if name in stem:
            p = Path(__file__).parent / "expected_counts" / f"{name}.json"
            if p.exists():
                return json.loads(p.read_text())
    return None


def main(argv=None):
    import argparse
    import json

    parser = argparse.ArgumentParser(
        prog="python -m stardis_tpu_torch.atom_data.convert",
        description="carsus/TARDIS atom data (pandas HDFStore) -> native HDF5",
    )
    parser.add_argument("src", help="carsus store (pandas HDFStore)")
    parser.add_argument("dst", help="native output path")
    parser.add_argument(
        "--verify", action="store_true",
        help="print the per-species verification report and, when an expectation "
        "table exists (bundled by store name, or --expected), fail on any mismatch",
    )
    parser.add_argument("--expected", metavar="JSON",
                        help="expectation table to verify against (overrides the bundled one)")
    parser.add_argument(
        "--record", metavar="JSON",
        help="write the full report as an 'exact' expectation table: run once against "
        "a genuine store to pin its counts/checksums",
    )
    args = parser.parse_args(argv)

    adata = convert(args.src, args.dst)
    print(
        f"converted: {len(adata.atom_data)} elements, {len(adata.levels)} levels, "
        f"{len(adata.lines)} lines, linelist_atoms="
        f"{0 if adata.linelist_atoms is None else len(adata.linelist_atoms)}"
    )
    if not (args.verify or args.record):
        return 0

    report = verify_report(adata)
    print(json.dumps(report, indent=1, sort_keys=True))
    if args.record:
        with open(args.record, "w") as fh:
            json.dump({"recorded_from": str(args.src), "exact": report}, fh, indent=1,
                      sort_keys=True)
        print(f"recorded expectation table -> {args.record}")
    if args.verify:
        if args.expected:
            with open(args.expected) as fh:
                expected = json.load(fh)
        else:
            expected = _builtin_expected(args.src)
        if expected is None:
            print("verify: no expectation table for this store (report printed above)")
            return 0
        fails = verify_against_expected(report, expected)
        if fails:
            for f in fails:
                print(f"VERIFY FAIL: {f}", file=sys.stderr)
            return 1
        print(f"verify: PASSED {expected.get('name', '(table)')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
