"""Full-visible synthesis: 4000-7000 AA on a dense grid, on the card.

The stardis_tpu_torch counterpart of ``examples/full_visible.py``: the
whole visible band through ``run_stardis(nu_segments="auto")``, which asks
the device-memory model (``stardis_tpu_torch.util.memory``) for the
smallest number of serial wavelength segments that fits the card
(segmented == unsegmented bit for bit on the card).  The script's default
is 200,000 points; 1,000,000 points is the production resolution
(0.003 AA).

Run:  python examples/torch/full_visible.py [n_points]   (needs a GPU;
default 200,000)

Small, on the CPU::

    cd examples/torch
    python -c "import full_visible, torch; full_visible.main('cpu', torch.float64, n_points=4001)"
"""

import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stardis_tpu_torch import run_stardis  # noqa: E402
from stardis_tpu_torch import units as u  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_marcs_file  # noqa: E402


def example_config(model_path):
    return {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {
            "type": "marcs", "fname": str(model_path), "final_atomic_number": 30,
        },
        "opacity": {
            "bf": {"H_I": {}},
            "ff": {"H_I": {}},
            "rayleigh": ["H"],
            "disable_electron_scattering": False,
            "line": {
                "disable": False,
                "broadening": [
                    "radiation", "linear_stark", "quadratic_stark",
                    "van_der_waals",
                ],
            },
        },
        "no_of_thetas": 20,
        "result_options": {},
    }


def main(device="cuda", dtype=torch.float32, n_points=200_000):
    """Synthesize the band; returns the wavelengths [AA] and the surface
    F_lambda, and the wall [s] of the run (parse and plan included)."""
    with tempfile.TemporaryDirectory(prefix="stardis_fullvis_") as tmp:
        model = os.path.join(tmp, "sun.mod")
        write_marcs_file(model)
        cfg = os.path.join(tmp, "config.json")
        with open(cfg, "w") as fh:
            json.dump(example_config(model), fh)

        lambdas = u.Quantity(np.linspace(4000.0, 7000.0, n_points), u.AA)
        t0 = time.perf_counter()
        out = run_stardis(cfg, lambdas, nu_segments="auto", device=device, dtype=dtype)
        wall = time.perf_counter() - t0
    flux = np.asarray(out.spectrum_lambda)
    lam = np.asarray(out.lambdas)
    if not (np.isfinite(flux).all() and (flux > 0).all()):
        raise RuntimeError("F_lambda is not finite and positive")
    # H-alpha must be in absorption against the local continuum
    core = np.abs(lam - 6564.6) < 0.5
    near = (np.abs(lam - 6564.6) < 40.0) & ~core
    if not flux[core].min() < 0.9 * np.median(flux[near]):
        raise RuntimeError("H-alpha is not in absorption")
    print(
        f"{n_points} points, 4000-7000 AA: {wall:.1f} s "
        f"(incl. parse and plan); "
        f"flux range [{flux.min():.3e}, {flux.max():.3e}] erg/s/cm^2/AA; "
        f"H-alpha core depth "
        f"{flux[core].min() / np.median(flux[near]):.2f} of continuum"
    )
    print("OK")
    return {"lambdas": lam, "spectrum_lambda": flux, "wall": wall}


if __name__ == "__main__":
    main(n_points=int(sys.argv[1]) if len(sys.argv) > 1 else 200_000)
