"""Post-processing: rotational and instrumental broadening of a spectrum
synthesized on the card.

The stardis_tpu_torch counterpart of ``examples/rotation_broadening.py``:
``run_stardis`` on the GPU, then Gray's rotational kernel for v sin i = 0,
15 and 80 km/s and Gaussian instrumental broadening at R = 45,000
(``postprocessing.rotation_broadening`` and ``instrumental_broadening``, on
the host).

Run:  python examples/torch/rotation_broadening.py   (needs a GPU)

Small, on the CPU::

    cd examples/torch
    python -c "import rotation_broadening as r, torch; r.main('cpu', torch.float64, step_aa=0.1)"
"""

import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stardis_tpu_torch import run_stardis  # noqa: E402
from stardis_tpu_torch import units as u  # noqa: E402
from stardis_tpu_torch.constants import C_KMS  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu_torch.postprocessing import (  # noqa: E402
    instrumental_broadening,
    rotation_broadening,
)

TEFF, LOGG = 6200.0, 4.3
LAMBDA_RANGE = (6550.0, 6580.0)  # AA
V_ROTS = (0.0, 15.0, 80.0)  # km/s
RESOLUTION = 45000


def example_config(model_path):
    return {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {
            "type": "marcs", "fname": str(model_path),
            "final_atomic_number": 30,
        },
        "opacity": {
            "bf": {"H_I": {}},
            "ff": {"H_I": {}},
            "line": {"disable": False, "broadening": ["radiation"]},
        },
        "no_of_thetas": 10,
        "result_options": {},
    }


def main(device="cuda", dtype=torch.float32, step_aa=0.02):
    """Synthesize and broaden; returns the wavelengths [AA], the surface
    F_nu and F_lambda, and the observed F_lambda [len(V_ROTS), N]."""
    with tempfile.TemporaryDirectory(prefix="stardis_rot_") as tmp:
        model_path = Path(tmp) / "star.mod"
        write_marcs_file(model_path, teff=TEFF, logg=LOGG)
        config_path = Path(tmp) / "config.json"
        config_path.write_text(json.dumps(example_config(model_path)))
        lambdas = u.Quantity(np.arange(*LAMBDA_RANGE, step_aa), u.AA)
        sim = run_stardis(config_path, lambdas, device=device, dtype=dtype)

    lam = np.asarray(sim.lambdas)
    vel_per_pix = u.Quantity(step_aa / np.mean(lam) * C_KMS, u.km / u.s)
    observed = []
    for v_rot_kms in V_ROTS:
        _, f_rot = rotation_broadening(
            vel_per_pix, sim.lambdas, sim.spectrum_lambda,
            v_rot=u.Quantity(v_rot_kms, u.km / u.s),
        )
        _, f_obs = instrumental_broadening(lam, np.asarray(f_rot), resolution=RESOLUTION)
        flux = np.asarray(f_obs)
        core = flux[np.abs(lam - 6564.6) < 0.3].min()
        cont = flux[np.abs(lam - 6564.6) > 12].mean()
        print(
            f"v sin i = {v_rot_kms:5.1f} km/s, R=45k: "
            f"H-alpha core {100 * core / cont:5.1f}% of continuum"
        )
        observed.append(flux)
    return {"lambdas": lam, "spectrum_nu": np.asarray(sim.spectrum_nu),
            "spectrum_lambda": np.asarray(sim.spectrum_lambda),
            "observed": np.asarray(observed)}


if __name__ == "__main__":
    main()
