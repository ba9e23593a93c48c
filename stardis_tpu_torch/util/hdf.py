"""HDF5 output of a simulation (the port of ``stardis_tpu/util/hdf.py``).

``output_to_hdf`` writes the file the JAX package's writer writes for the
same run: the same ``format`` attribute, groups, dataset names and shapes.
Tensors and Quantities become NumPy arrays; where the JAX writer stores a
pandas frame (the model's ``nuclide_mass_fraction``) as a group of
``values`` and ``index_0``, this one writes the same group from the
arrays.  h5py is imported only when a file is written.
"""

from __future__ import annotations

import numpy as np
import torch

#: the ``format`` attribute of an output file
OUTPUT_FORMAT = "stardis_tpu_output_v1"


class Frame:
    """[rows, columns] values with one index per row, written as the JAX
    writer writes a DataFrame."""

    def __init__(self, values, index):
        self.values = np.asarray(values)
        self.index = np.asarray(index)


def _write_item(grp, name, value):
    if value is None:
        return
    if isinstance(value, Frame):
        sub = grp.create_group(name)
        sub.attrs["pandas"] = "frame"
        sub.create_dataset("values", data=value.values)
        sub.create_dataset("index_0", data=value.index)
        return
    if isinstance(value, dict):
        sub = grp.create_group(name)
        for k, v in value.items():
            _write_item(sub, str(k), v)
        return
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    elif hasattr(value, "unit") and hasattr(value, "value"):  # Quantity
        value = value.value
    arr = np.asarray(value)
    if arr.dtype == object:
        arr = arr.astype("S")
    grp.create_dataset(name, data=arr)


def write_group(h5file, group_name, mapping):
    grp = h5file.require_group(group_name)
    for name, value in mapping.items():
        _write_item(grp, name, value)


def output_to_hdf(output, path):
    """Write a STARDISOutput: the spectra and, where the run returned them,
    the model, the plasma state and the radiation field."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["format"] = OUTPUT_FORMAT
        write_group(f, "spectrum", {
            "nus": output.nus,
            "lambdas": output.lambdas,
            "spectrum_nu": output.spectrum_nu,
            "spectrum_lambda": output.spectrum_lambda,
        })
        model = getattr(output, "stellar_model", None)
        if model is not None:
            comp = model.composition
            write_group(f, "stellar_model", {
                "temperatures": model.temperatures,
                "r": model.geometry.r,
                "density": comp.density,
                "nuclide_mass_fraction": Frame(comp.nuclide_mass_fraction,
                                               comp.atomic_numbers),
            })
        plasma = getattr(output, "stellar_plasma", None)
        if plasma is not None:
            write_group(f, "stellar_plasma", plasma._asdict())
        rf = getattr(output, "stellar_radiation_field", None)
        if rf is not None:
            write_group(f, "radiation_field", {
                "frequencies": rf.frequencies,
                "F_nu": rf.F_nu,
                "opacities": rf.opacities.opacities_dict,
                "total_alphas": rf.opacities.total_alphas,
            })
    return path
