"""The inputs a cell hands the program and the reference: the atomic data
with its line lists, MARCS model files and file-opacity tables, all made
by the frozen generators under ``reference/`` from the configuration and
the seed.  The program gets its own copy of the atomic data in its own
classes (``port_atom_data``); the reference builds a fresh one."""

from __future__ import annotations

import re

import numpy as np

from .reference.atom_data.builtin import build_builtin_atom_data
from .reference.io.synthetic import write_marcs_file, write_opacity_tables
from .reference.opacities.lines import synth_linelist, synth_molecule_linelist


def atom_data(config):
    """The configuration's atomic data (builtin, up to its Z), with its
    synthetic atomic and molecular line lists; the reference's classes."""
    spec = config["atom_data"]
    adata = build_builtin_atom_data(spec["max_atomic_number"], include_linelists=True,
                                    include_molecules=spec["include_molecules"])
    lines = config["lines"]
    synth_linelist(adata, lines["n"], lines["lam_lo"], lines["lam_hi"], lines["seed"])
    mol = config.get("molecular_lines")
    if mol:
        synth_molecule_linelist(adata, mol["n"], mol["lam_lo"], mol["lam_hi"], mol["seed"])
    return adata


def port_atom_data(adata):
    """``adata`` as the program's AtomData (its Table and MoleculeData
    classes), every array copied: the program restricts the tables it is
    given to the model's elements."""
    from stardis_tpu_torch.atom_data.base import AtomData, MoleculeData, Table

    def table(t):
        if t is None:
            return None
        return Table({k: np.array(v) for k, v in t.columns.items()}, t.index_cols, t.series)

    md = adata.molecule_data
    if md is not None:
        md = MoleculeData(list(md.names), np.array(md.equilibrium_temperatures),
                          np.array(md.log_equilibrium_constants),
                          np.array(md.partition_temperatures),
                          np.array(md.partition_functions), list(md.ion1), list(md.ion2),
                          np.array(md.dissociation_energies))
    return AtomData(table(adata.atom_data), table(adata.ionization_data),
                    table(adata.levels), table(adata.lines), table(adata.linelist_atoms),
                    table(adata.linelist_molecules), md)


def lambdas_aa(config):
    """The configuration's wavelength grid [AA]: np.arange(start, stop, step)."""
    return np.arange(*config["lambda_aa"])


def stardis_config(config, model_path, opacity_files=None):
    """The STARDIS config dict of ``config`` for the model in ``model_path``,
    with the paths of the written ``opacity.file`` tables."""
    out = {**config["stardis"]}
    out["input_model"] = {**out["input_model"], "fname": str(model_path)}
    if config.get("opacity_files"):
        out["opacity"] = {**out["opacity"], "file": dict(opacity_files)}
    return out


def write_tables(config, directory):
    """The configuration's file-opacity tables in ``directory``, or None."""
    return write_opacity_tables(directory) if config.get("opacity_files") else None


def write_model(config, path, t_scale=1.0, **override):
    """The configuration's MARCS model (``config["model"]``, with
    ``override``), its temperature column times ``t_scale``."""
    write_marcs_file(path, **{**config["model"], **override})
    if t_scale != 1.0:
        scale_temperatures(path, t_scale)
    return str(path)


def scale_temperatures(path, t_scale):
    """Multiply the T column of a MARCS file's model structure by
    ``t_scale``, keeping its width (%7.1f)."""
    with open(path) as fh:
        lines = fh.read().split("\n")
    start = next(i for i, ln in enumerate(lines) if ln.startswith("Model structure")) + 2
    n_depth = int(lines[start - 3].split()[0])
    for k in range(start, start + n_depth):
        end = list(re.finditer(r"\S+", lines[k]))[4].end()  # the T field, right-aligned
        t_new = float(lines[k][end - 7:end]) * t_scale
        lines[k] = lines[k][:end - 7] + f"{t_new:7.1f}" + lines[k][end:]
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
