"""LTE plasma: tables, the solve, and the reference's plasma entry point
(the port of ``stardis_tpu/plasma/__init__.py``)."""

import numpy as np
import torch

from .lte import DevicePlasmaTables, PlasmaState, device_tables, solve_lte
from .tables import PlasmaTables, build_plasma_tables


def create_stellar_plasma(stellar_model, atom_data, config=None, device="cuda",
                          dtype=torch.float32):
    """Reference-shaped convenience wrapper (reference plasma/base.py:491):
    builds the plasma tables for a stellar model's elements and solves the
    LTE state at its temperatures, returning (PlasmaState, PlasmaTables).

    ``config`` is accepted for the reference's signature and not read, as
    in the JAX package.  device, dtype : the card in float32 unless the
    caller asks otherwise (a CUDA device without a GPU raises).  The depth
    columns are solved in stage 1's layout (``pipeline.padded_columns``),
    so the state has the bits of the same model's stage 1 in
    ``run_stardis``."""
    from ..pipeline import elemental_densities, padded_columns, resolve_device

    device = resolve_device(device, "create_stellar_plasma")
    tables = build_plasma_tables(atom_data, stellar_model.composition.atomic_numbers)
    temps = torch.as_tensor(np.asarray(stellar_model.temperatures, dtype=np.float64),
                            device=device).to(dtype)
    n_elem = torch.as_tensor(elemental_densities(stellar_model, tables),
                             device=device).to(dtype)
    n_depth = temps.shape[0]
    cols = padded_columns(n_depth, device)
    state = solve_lte(temps[cols], n_elem[:, cols], device_tables(tables, dtype, device))
    return PlasmaState(*(x[..., :n_depth] for x in state)), tables


__all__ = [
    "DevicePlasmaTables",
    "PlasmaState",
    "PlasmaTables",
    "build_plasma_tables",
    "create_stellar_plasma",
    "device_tables",
    "solve_lte",
]
