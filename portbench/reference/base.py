# Frozen copy of stardis_tpu_torch/base.py at commit 9c7d618, cut to reading a MARCS
# model and the config: part of the benchmark's reference.  Keep it as it is.
"""Config and MARCS model reading, as the program's ``base.py`` did them at
commit 9c7d618."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .io.abundances import rescale_nuclide_mass_fractions
from .io.config import load_config
from .io.marcs import read_marcs_model


def read_stellar_model(config, adata, fname=None):
    """One stellar model by the config's ``input_model`` rules (MARCS)."""
    im = config.input_model
    path = Path(fname) if fname is not None else Path(im.fname)
    if im.type != "marcs":
        raise ValueError("the benchmark's reference reads MARCS models only")
    raw = read_marcs_model(path, gzipped=im.gzipped)
    stellar_model = raw.to_stellar_model(
        adata,
        final_atomic_number=int(im.final_atomic_number),
        composition_source=im.composition_source,
        helium_mass_frac_Y=im.composition_Y,
        heavy_metal_mass_frac_Z=im.composition_Z,
    )
    if config.opacity.line.disable_microturbulence:
        stellar_model.microturbulence = stellar_model.microturbulence * 0.0

    rescale = im.nuclide_rescaling_dict
    rescale = rescale.to_dict() if hasattr(rescale, "to_dict") else dict(rescale)
    if rescale:
        comp = stellar_model.composition
        comp.nuclide_mass_fraction = rescale_nuclide_mass_fractions(
            comp.atomic_numbers,
            comp.nuclide_mass_fraction,
            list(rescale.keys()),
            list(rescale.values()),
        )
    return stellar_model


def parse_config_to_model(config, atom_data):
    """Config + atom data (restricted to the model's elements, as the
    program restricts them) + stellar model."""
    config = load_config(config)
    stellar_model = read_stellar_model(config, atom_data)
    n_elements = len(stellar_model.composition.atomic_numbers)
    atom_data.prepare_atom_data(
        np.arange(1, min(n_elements, int(config.input_model.final_atomic_number)) + 1)
    )
    return config, atom_data, stellar_model
