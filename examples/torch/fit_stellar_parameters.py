"""Gradient-based stellar-parameter fitting through the whole pipeline, on
the card.

The stardis_tpu_torch counterpart of ``examples/fit_stellar_parameters.py``:
a solar temperature structure scaled by 1.021 and rotating at v sin i = 11
km/s "observes" the continuum-normalised H-alpha spectrum; Adam, on the
autograd gradient of a mean-squared loss, recovers (scale, v sin i) from
(1.0, 5.0).  The gradient runs backward through the rotational convolution,
the formal solution (Kernel 2b), the line sum (Kernel 1b) and stage 1's LTE
solve, all on the GPU.  The JAX example runs in float64 on the CPU; here
the card runs float32, and the script reports whether the recovered values
are within the JAX example's tolerances rather than stopping on them.

Run:  python examples/torch/fit_stellar_parameters.py   (needs a GPU)

Small, on the CPU::

    cd examples/torch
    python -c "import fit_stellar_parameters as f, torch; f.main('cpu', torch.float64, steps=2)"
"""

import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stardis_tpu_torch import parse_config_to_model  # noqa: E402
from stardis_tpu_torch import units as u  # noqa: E402
from stardis_tpu_torch.constants import C_KMS  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu_torch.pipeline import (  # noqa: E402
    build_simulation_plan,
    device_constants,
    resolve_device,
    stage_plasma_and_lines,
    stage_spectrum,
)
from stardis_tpu_torch.postprocessing import rotation_broadening_torch  # noqa: E402

LAMBDA_RANGE = (6556.0, 6572.0, 0.05)  # AA
HALF = 24  # static kernel support: fits any v sin i < 24 * vel_pix
TRUE = (1.021, 11.0)  # "unknown" star: ~120 K hotter than the start; v sin i [km/s]
START = (1.0, 5.0)  # solar T, slow rotator
STEP_SCALE = (1.0, 300.0)  # per-parameter Adam step scaling
LR, B1, B2 = 3e-2, 0.9, 0.999


def example_config(model_path):
    return {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:5",
        "input_model": {
            "type": "marcs", "fname": str(model_path), "final_atomic_number": 5,
        },
        "opacity": {
            "bf": {"H_I": {}},
            "ff": {"H_I": {}},
            "rayleigh": ["H"],
            "line": {"disable": False, "broadening": ["radiation"]},
        },
        "no_of_thetas": 5,
        "result_options": {},
    }


def main(device="cuda", dtype=torch.float32, steps=60):
    """Fit; returns the loss before each step [steps], the gradient at the
    start (d loss / d (scale, v sin i)), and the parameters after the last
    step."""
    device = resolve_device(device, "fit_stellar_parameters")
    with tempfile.TemporaryDirectory(prefix="stardis_fit_") as tmp:
        model_path = f"{tmp}/sun.mod"
        write_marcs_file(model_path)
        cfg = f"{tmp}/c.json"
        with open(cfg, "w") as fh:
            json.dump(example_config(model_path), fh)
        config, adata, model = parse_config_to_model(cfg)
    lams = np.arange(*LAMBDA_RANGE)
    nus = np.asarray(u.Quantity(lams, u.AA).to(u.Hz, u.spectral()))
    plan = build_simulation_plan(config, adata, model, nus)
    consts = device_constants(plan, dtype, device)

    temps0 = torch.as_tensor(plan.temperatures, device=device).to(dtype)
    n_elem0 = torch.as_tensor(plan.n_elem, device=device).to(dtype)
    # constant velocity-per-pixel of the uniform-lambda grid (one value is
    # exact to ~0.1% over this 16 AA window)
    vel_pix = float(LAMBDA_RANGE[2] / lams.mean() * C_KMS)  # km/s per pixel

    def spectrum(scale, v_rot):
        # scaling T at fixed total gas density: n ~ P/(kT) -> n/scale
        state, lq = stage_plasma_and_lines(plan, temps0 * scale, n_elem0 / scale, consts)
        surface = stage_spectrum(plan, state, lq, consts)[0][-1]
        # the rotational convolution is differentiable in v sin i
        broadened = rotation_broadening_torch(vel_pix, surface, v_rot, half_width_pix=HALF)
        return broadened / broadened.mean()  # continuum-normalized shape

    with torch.no_grad():
        observed = spectrum(*TRUE)

    params = torch.tensor(START, dtype=dtype, device=device, requires_grad=True)
    pscale = torch.tensor(STEP_SCALE, dtype=dtype, device=device)
    m = v = 0.0
    losses, grad0 = [], None
    print(f"target scale {TRUE[0]:.4f} (Teff ~ {5777 * TRUE[0]:.0f} K), "
          f"v sin i {TRUE[1]:.1f} km/s; start ({START[0]:.4f}, {START[1]})")
    for i in range(steps):
        loss = torch.mean((spectrum(params[0], params[1]) - observed) ** 2)
        (g,) = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        if grad0 is None:
            grad0 = g.detach().cpu().numpy()
        with torch.no_grad():
            g = g * pscale
            m = B1 * m + (1 - B1) * g
            v = B2 * v + (1 - B2) * g * g
            mhat = m / (1 - B1 ** (i + 1))
            vhat = v / (1 - B2 ** (i + 1))
            lr_i = LR / (1.0 + 0.05 * i)  # decay damps the late oscillation
            params -= lr_i * pscale * mhat / (torch.sqrt(vhat) + 1e-12)
        if i % 5 == 0 or i == steps - 1:
            print(f"  iter {i:3d}: loss {losses[-1]:.3e} "
                  f"scale {float(params[0]):.5f} vsini {float(params[1]):.2f}")

    scale, vrot = (float(x) for x in params.detach().cpu())
    err, err_v = abs(scale - TRUE[0]), abs(vrot - TRUE[1])
    print(f"recovered scale {scale:.5f} (Teff ~ {5777 * scale:.0f} K), |error| = {err:.1e}; "
          f"v sin i {vrot:.2f} km/s, |error| = {err_v:.1e}")
    print(f"within the JAX example's tolerances (2e-3, 0.3 km/s): "
          f"{err < 2e-3 and err_v < 0.3}")
    return {"losses": np.asarray(losses), "grad0": grad0, "params": np.asarray([scale, vrot])}


if __name__ == "__main__":
    main()
