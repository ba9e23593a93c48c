"""MESA model reader, NumPy only (the port of ``stardis_tpu/io/mesa.py``).

Reads MESA ``.mod`` profile files: a metadata block matched by regular
expressions (Fortran D-exponent floats) and a shell table with lnR / lnT /
lnd columns; the composition is uniform scaled-solar (MESA models carry no
per-shell abundances in this format).  Where the JAX package keeps the
shell table in a DataFrame indexed by zone, this one keeps the zones and
one NumPy array per column, in file order (outermost shell first).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from .. import units as u
from ..model.base import Composition, Radial1DGeometry, StellarModel
from .abundances import (
    ASPLUND_2009_HE_MASS_FRAC_Y,
    ASPLUND_2009_HEAVY_MASS_FRAC_Z,
    create_scaled_solar_profile,
)

_METADATA_RE = [
    (r"version_number\s+(\S+)", "Version number", str),
    (r"M/Msun\s+(\S+)", "Mass", float),
    (r"model_number\s+(\S+)", "Model Number", int),
    (r"star_age\s+(\S+)", "Star Age", float),
    (r"initial_z\s+(\S+)", "Initial Z", float),
    (r"n_shells\s+(\S+)", "Number of Shells", int),
    (r"net_name\s+(\S+)", "Net Name", str),
    (r"species\s+(\S+)", "Number of Species", int),
    (r"Teff\s+(\S+)", "Effective Temperature", float),
]

#: lines before the shell table's header
ROWS_TO_SKIP = 23


@dataclass
class MESAModel:
    metadata: dict
    zone: np.ndarray  # [n] 1-based shell numbers, surface first
    data: dict  # column name -> [n] float array, surface first

    def __len__(self):
        return len(self.zone)

    def truncate_model(self, shell_number):
        """Keep only the outermost ``shell_number`` shells (MESA numbers
        shells from the surface inward)."""
        keep = self.zone <= shell_number
        self.zone = self.zone[keep]
        self.data = {k: v[keep] for k, v in self.data.items()}

    def to_geometry(self):
        r = np.exp(self.data["lnR"][::-1])  # innermost -> surface, cm
        return Radial1DGeometry(u.Quantity(r, u.cm))

    def to_uniform_composition_from_solar(
        self,
        atom_data,
        helium_mass_frac_Y=ASPLUND_2009_HE_MASS_FRAC_Y,
        heavy_metal_mass_frac_Z=ASPLUND_2009_HEAVY_MASS_FRAC_Z,
        final_atomic_number=138,
    ):
        density = np.exp(self.data["lnd"][::-1])
        zs, profile = create_scaled_solar_profile(
            atom_data,
            helium_mass_frac_Y,
            heavy_metal_mass_frac_Z,
            final_atomic_number=min(
                final_atomic_number, int(atom_data.atom_data.atomic_number.max())
            ),
            composition_source="asplund_2009",
        )
        mass_frac = np.repeat(profile[:, None], len(self), axis=1)
        return Composition(
            u.Quantity(density, u.g / u.cm**3), zs, mass_frac,
            element_masses=atom_data.mass_of,
        )

    def to_stellar_model(
        self,
        atom_data,
        truncate_to_shell_number=None,
        helium_mass_frac_Y=ASPLUND_2009_HE_MASS_FRAC_Y,
        heavy_metal_mass_frac_Z=ASPLUND_2009_HEAVY_MASS_FRAC_Z,
        final_atomic_number=138,
    ):
        if truncate_to_shell_number is not None:
            self.truncate_model(truncate_to_shell_number)
        geometry = self.to_geometry()
        composition = self.to_uniform_composition_from_solar(
            atom_data,
            helium_mass_frac_Y,
            heavy_metal_mass_frac_Z,
            final_atomic_number=final_atomic_number,
        )
        temperatures = u.Quantity(np.exp(self.data["lnT"][::-1]), u.K)
        return StellarModel(temperatures, geometry, composition)


def read_mesa_metadata(fpath):
    with open(fpath, "rt") as fh:
        lines = fh.readlines()

    metadata = {}
    start = next(
        (i for i, ln in enumerate(lines) if re.search(_METADATA_RE[0][0], ln)), None
    )
    if start is None:
        raise ValueError(f"{fpath}: no MESA metadata block found")
    block = lines[start : start + 40]
    for pattern, name, caster in _METADATA_RE:
        for ln in block:
            m = re.search(pattern, ln)
            if m:
                raw = m.group(1).replace("D", "e")
                metadata[name] = caster(raw) if caster is not str else raw
                break
    metadata["Mass"] = u.Quantity(metadata["Mass"], u.M_sun)
    metadata["Star Age"] = u.Quantity(metadata["Star Age"], u.yr)
    metadata["Effective Temperature"] = u.Quantity(
        metadata["Effective Temperature"], u.K
    )
    return metadata


def read_mesa_data(fpath, mesa_shells):
    """The shell table: skip ROWS_TO_SKIP lines, then a whitespace-separated
    header and ``mesa_shells`` rows; text after "!" is a comment and
    lines left empty are skipped.  The first field of a row is its zone;
    every other field is a float with D or E exponents.  A header that
    names the zone column (as many names as fields) or leaves it unnamed
    (one name fewer) both read.  Returns (zone [n] int64, {column: [n]})."""
    with open(fpath, "rt") as fh:
        lines = fh.readlines()[ROWS_TO_SKIP:]
    rows = (ln.split("!", 1)[0].split() for ln in lines)
    rows = [r for r in rows if r]
    if not rows:
        raise ValueError(f"{fpath}: no MESA shell table after line {ROWS_TO_SKIP}")
    header, body = rows[0], rows[1 : 1 + mesa_shells]
    names = header[1:] if body and len(body[0]) == len(header) else header
    for i, r in enumerate(body):
        if len(r) != len(names) + 1:
            raise ValueError(
                f"{fpath}: shell row {i + 1} has {len(r)} fields, expected "
                f"{len(names) + 1}"
            )
    zone = np.array([int(r[0]) for r in body], dtype=np.int64)
    data = {
        name: np.array([float(r[j + 1].replace("D", "E")) for r in body])
        for j, name in enumerate(names)
    }
    return zone, data


def read_mesa_model(fpath):
    metadata = read_mesa_metadata(fpath)
    zone, data = read_mesa_data(fpath, metadata["Number of Shells"])
    return MESAModel(metadata, zone, data)
