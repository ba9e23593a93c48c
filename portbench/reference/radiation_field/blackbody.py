# Frozen copy of stardis_tpu_torch/radiation_field/blackbody.py at commit 9c7d618: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""Planck source function (PyTorch port of
``stardis_tpu/radiation_field/blackbody.py``)."""

from __future__ import annotations

import torch

from ..constants import C_CGS, H_CGS, K_B_CGS


def blackbody_flux_at_nu(tracing_nus, temps):
    """B_nu(T): [D, N] from nus [N] and temps [D] (or [D, 1])."""
    if temps.ndim == 1:
        temps = temps[:, None]
    nus = tracing_nus[None, :]
    # f32-safe: nu^3 alone overflows float32 at optical frequencies
    # (9.5e43 > 3.4e38), so fold the 2h/c^2 scale inside the cube
    scale_cbrt = float((2.0 * H_CGS / C_CGS**2) ** (1.0 / 3.0))
    prefactor = (scale_cbrt * nus) ** 3
    return prefactor / torch.expm1(H_CGS * nus / (K_B_CGS * temps))
