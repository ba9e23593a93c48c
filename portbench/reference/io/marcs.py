# Frozen copy of stardis_tpu_torch/io/marcs.py at commit 9c7d618: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""MARCS model-atmosphere reader, NumPy only.

The parser of ``stardis_tpu/io/marcs.py`` (metadata by content patterns,
table rows tokenized with a float regex so MARCS's glued exponents parse),
keeping the table as a dict of NumPy columns instead of a pandas frame.
"""

from __future__ import annotations

import gzip
import logging
import re
from dataclasses import dataclass

import numpy as np

from .. import units as u
from .abundances import create_scaled_solar_profile
from ..model.base import Composition, Radial1DGeometry, StellarModel

logger = logging.getLogger(__name__)

_FLOAT_RE = re.compile(r"[+-]?\d+\.?\d*(?:[eEdD][+-]?\d+)?")

_METADATA_PATTERNS = {
    "teff": (r"([\d.]+)\s+Teff \[(\S+)\]", True),
    "flux": (r"([\d.Ee+-]+)\s+Flux \[(\S+)\]", True),
    "surface_grav": (r"([\d.Ee+-]+)\s+Surface gravity \[(\S+)\]", True),
    "microturbulence": (r"([\d.]+)\s+Microturbulence parameter \[(\S+)\]", True),
    "mass": (r"([\d.Ee+-]+)\s+Mass \[(\S+)\]", True),
    "radius": (r"([\d.Ee+-]+)\s+Radius \[(\S+)\] at Tau", True),
    "luminosity": (r"([\d.Ee+-]+)\s+Luminosity \[(\S+)\]", True),
}


def _parse_unit(text):
    text = text.strip()
    aliases = {
        "K": u.K,
        "erg/cm2/s": u.erg / u.cm**2 / u.s,
        "cm/s2": u.cm / u.s**2,
        "km/s": u.km / u.s,
        "cm": u.cm,
        "Lsun": u.L_sun,
        "solar": u.M_sun,
        "solar masses": u.M_sun,
    }
    return aliases.get(text, u.dimensionless)


@dataclass
class MARCSModel:
    metadata: dict
    data: dict  # column name -> [n_depth] array, surface first
    spherical: bool

    @property
    def n_depth(self):
        return len(self.data["t"])

    def to_geometry(self):
        r = -self.data["depth"][::-1]  # innermost -> surface, cm
        reference_r = None
        if self.spherical:
            radius = self.metadata["radius"].to(u.cm).value
            r = r + radius
            reference_r = u.Quantity(radius, u.cm)
        return Radial1DGeometry(u.Quantity(r, u.cm), reference_r)

    def to_composition(
        self,
        atom_data,
        final_atomic_number,
        composition_source="from_model",
        helium_mass_frac_Y=-99.0,
        heavy_metal_mass_frac_Z=-99.0,
    ):
        density = self.data["density"][::-1]  # innermost -> surface

        if composition_source == "from_model":
            zs, mass_frac = self._marcs_abundances_to_mass_fractions(
                atom_data, final_atomic_number
            )
        elif composition_source in ("asplund_2009", "asplund_2020"):
            zs, profile = create_scaled_solar_profile(
                atom_data,
                helium_mass_frac_Y=helium_mass_frac_Y,
                heavy_metal_mass_frac_Z=heavy_metal_mass_frac_Z,
                final_atomic_number=min(
                    final_atomic_number,
                    int(atom_data.atom_data.atomic_number.max()),
                ),
                composition_source=composition_source,
            )
            mass_frac = np.repeat(profile[:, None], self.n_depth, axis=1)
        else:
            raise ValueError(
                f"Unknown composition {composition_source!r}; must be "
                "'from_model', 'asplund_2020' or 'asplund_2009'."
            )

        return Composition(
            u.Quantity(density, u.g / u.cm**3),
            zs,
            mass_frac,
            element_masses=atom_data.mass_of,
        )

    def _marcs_abundances_to_mass_fractions(self, atom_data, final_atomic_number):
        """log-number abundances -> normalized mass fractions [Z x depth].

        Only elements with atom-data masses contribute; normalization runs
        over those elements *before* truncating to final_atomic_number.
        """
        ab_cols = [c for c in self.data if c.startswith("scaled_log_number")]
        n_chem = len(ab_cols)
        log_ab = np.stack([self.data[c] for c in ab_cols], axis=1)  # [depth, 92]

        present = set(int(z) for z in atom_data.atom_data.atomic_number)
        available = [z for z in range(1, n_chem + 1) if z in present]
        masses = atom_data.mass_of(available)
        mass_weight = (10.0 ** log_ab[:, [z - 1 for z in available]]) * masses

        mass_frac = mass_weight / mass_weight.sum(axis=1, keepdims=True)

        keep = [z for z in available if z <= min(final_atomic_number, n_chem)]
        keep_idx = [available.index(z) for z in keep]
        mass_frac = mass_frac[:, keep_idx]

        # transpose to [element x depth], flip depth to innermost-first
        return np.asarray(keep, dtype=np.int64), mass_frac.T[:, ::-1]

    def to_stellar_model(
        self,
        atom_data,
        final_atomic_number=118,
        composition_source="from_model",
        helium_mass_frac_Y=-99.0,
        heavy_metal_mass_frac_Z=-99.0,
    ):
        geometry = self.to_geometry()
        composition = self.to_composition(
            atom_data,
            final_atomic_number=final_atomic_number,
            composition_source=composition_source,
            helium_mass_frac_Y=helium_mass_frac_Y,
            heavy_metal_mass_frac_Z=heavy_metal_mass_frac_Z,
        )
        temperatures = u.Quantity(self.data["t"][::-1].copy(), u.K)
        return StellarModel(
            temperatures,
            geometry,
            composition,
            spherical=self.spherical,
            microturbulence=self.metadata.get(
                "microturbulence", u.Quantity(0.0, u.km / u.s)
            ),
        )


def _read_lines(fpath, gzipped):
    opener = gzip.open if gzipped else open
    with opener(fpath, "rt") as fh:
        return fh.readlines()


def read_marcs_metadata(lines):
    head = lines[:12]
    spherical = not any("plane-parallel" in ln for ln in head)
    metadata = {"fname": lines[0].strip()}
    for key, (pattern, has_unit) in _METADATA_PATTERNS.items():
        for ln in head:
            m = re.search(pattern, ln)
            if m:
                val = float(m.group(1).replace("D", "E"))
                if has_unit and m.lastindex and m.lastindex >= 2:
                    metadata[key] = u.Quantity(val, _parse_unit(m.group(2)))
                else:
                    metadata[key] = val
                break
    for ln in head:
        m = re.search(
            r"([+-]?\d+\.\d+)\s+([+-]?\d+\.\d+)\s+Metallicity \[Fe/H\] and \[alpha/Fe\]",
            ln,
        )
        if m:
            metadata["feh"] = float(m.group(1))
            metadata["afe"] = float(m.group(2))
        m = re.search(
            r"([\d.]+)\s+([\d.]+)\s+([\d.]+)\s+([\d.]+)\s+are the convection parameters",
            ln,
        )
        if m:
            for i, name in enumerate(
                ("conv_alpha", "conv_nu", "conv_y", "conv_beta")
            ):
                metadata[name] = float(m.group(i + 1))
        m = re.search(
            r"([\d.]+)\s+([\d.]+)\s+([\d.Ee+-]+)\s+are X, Y and Z", ln
        )
        if m:
            metadata["x"] = float(m.group(1))
            metadata["y"] = float(m.group(2))
            metadata["z"] = float(m.group(3))
    return metadata, spherical


def read_marcs_data(lines):
    n_depth = None
    for ln in lines:
        m = re.search(r"(\d+)\s+Number of depth points", ln)
        if m:
            n_depth = int(m.group(1))
            break
    if n_depth is None:
        raise ValueError("MARCS file: could not find 'Number of depth points'")

    # abundance block: between the 'Logarithmic chemical number abundances'
    # banner and the depth-points line
    ab_start = next(
        i for i, ln in enumerate(lines) if "Logarithmic chemical number" in ln
    )
    ab_end = next(
        i for i, ln in enumerate(lines) if re.search(r"Number of depth points", ln)
    )
    abundances = []
    for ln in lines[ab_start + 1 : ab_end]:
        abundances.extend(float(tok) for tok in _FLOAT_RE.findall(ln))

    hdr1 = next(i for i, ln in enumerate(lines) if re.match(r"\s*k\s+lgTauR\s+lgTau5", ln))
    hdr2 = next(
        i for i, ln in enumerate(lines) if re.match(r"\s*k\s+lgTauR\s+KappaRoss", ln)
    )

    cols1 = ["k", "lgtaur", "lgtau5", "depth", "t", "pe", "pg", "prad", "pturb"]
    cols2 = ["k", "lgtaur", "kappaross", "density", "mu", "vconv", "fconv_over_f", "rhox"]

    def parse_table(start, cols):
        rows = []
        for ln in lines[start + 1 : start + 1 + n_depth]:
            toks = [float(t.replace("D", "E")) for t in _FLOAT_RE.findall(ln)]
            if len(toks) != len(cols):
                raise ValueError(
                    f"MARCS table row has {len(toks)} fields, expected {len(cols)}: {ln!r}"
                )
            rows.append(toks)
        table = np.asarray(rows, dtype=float).reshape(-1, len(cols))
        return {c: table[:, i] for i, c in enumerate(cols)}

    upper = parse_table(hdr1, cols1)
    lower = parse_table(hdr2, cols2)
    if not np.array_equal(upper["k"], lower["k"]):
        raise ValueError("MARCS file: the two structure tables disagree on k")
    data = {c: v for c, v in upper.items() if c != "k"}
    data.update({c: v for c, v in lower.items() if c not in ("k", "lgtaur")})
    for i, ab in enumerate(abundances):
        data[f"scaled_log_number_fraction_{i + 1}"] = np.full(n_depth, ab)
    # the JAX reader maps every -99.00 entry (absent elements) to 0.0
    return {c: np.where(v == -99.0, 0.0, v) for c, v in data.items()}


def read_marcs_model(fpath, gzipped=False):
    try:
        lines = _read_lines(fpath, gzipped)
        metadata, spherical = read_marcs_metadata(lines)
    except Exception as exc:
        raise ValueError(
            "Failed to read metadata from MARCS model file. Check the gzipped flag."
        ) from exc
    data = read_marcs_data(lines)
    return MARCSModel(metadata, data, spherical=spherical)
