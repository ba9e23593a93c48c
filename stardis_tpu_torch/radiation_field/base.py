"""Reference-shaped radiation-field module surface (the port of
``stardis_tpu/radiation_field/base.py``).

``RadiationField`` lives in ``stardis_tpu_torch.base`` beside
``STARDISOutput``; ``create_stellar_radiation_field`` is the reference's
convenience entry point on top of the plan and the device stages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import Opacities, RadiationField
from ..pipeline import build_simulation_plan, resolve_device, run_simulation
from .solver import gauss_legendre_thetas

__all__ = ["Opacities", "RadiationField", "create_stellar_radiation_field"]


def create_stellar_radiation_field(tracing_nus, stellar_model, atom_data, config,
                                   device="cuda", dtype=torch.float32):
    """Opacities and the formal solution for a prepared stellar model.

    Unlike the reference (which takes a solved plasma), this runs the whole
    device pipeline (plasma, opacities, transfer) on ``device`` (the card
    in float32 unless the caller asks otherwise; "cuda" raises without a
    GPU) and returns the RadiationField.  Its nu-axis outputs (F_nu, the
    total, each [D, N] opacity and I_nu) follow the order of
    ``tracing_nus``, re-aligned on the device by one index tensor.
    """
    device = resolve_device(device, "create_stellar_radiation_field")
    nus = np.atleast_1d(np.asarray(tracing_nus, dtype=np.float64))
    plan = build_simulation_plan(config, atom_data, stellar_model, nus)
    f_nu, total, opacities_dict, i_nus, _state = run_simulation(plan, device=device,
                                                                dtype=dtype)

    # the pipeline computes on a descending grid; the caller's i-th
    # frequency is the grid's order[i]-th
    n = len(nus)
    order = np.argsort(np.argsort(-nus, kind="stable"), kind="stable")
    index = torch.as_tensor(order, device=f_nu.device)
    f_nu = f_nu.index_select(1, index)
    total = total.index_select(1, index)
    opacities_dict = {k: (v.index_select(1, index) if v.dim() == 2 and v.shape[1] == n else v)
                      for k, v in opacities_dict.items()}
    if i_nus is not None:
        i_nus = i_nus.index_select(1, index)

    thetas, weights = gauss_legendre_thetas(int(config.no_of_thetas))
    return RadiationField(frequencies=nus, opacities=Opacities(opacities_dict, total),
                          f_nu=f_nu, thetas=thetas, weights=weights, i_nus=i_nus)
