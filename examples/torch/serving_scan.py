"""Serving example: a Teff scan through one SpectralService, on the card.

The stardis_tpu_torch counterpart of ``examples/serving_scan.py``.  The
service builds its plan and uploads its constants on the first request and
captures stage 1 in a CUDA graph; every later atmosphere (7 Teffs, 5200-6400
K, around the Na D lines with the built-in VALD line list) replays that
graph and runs the two kernels.  The port has no window tiers to freeze
(Kernel 1 reads each request's exact windows), so the JAX example's
``tier_margin`` has no counterpart.

Run:  python examples/torch/serving_scan.py   (needs a GPU)

Small, on the CPU::

    cd examples/torch
    python -c "import serving_scan, torch; serving_scan.main('cpu', torch.float64, n_teffs=2)"
"""

import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stardis_tpu_torch import parse_config_to_model, units as u  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu_torch.serving import SpectralService  # noqa: E402


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
            "line": {
                "disable": False,
                "broadening": ["radiation", "van_der_waals"],
                "vald_linelist": {
                    "use_linelist": True, "use_vald_broadening": True,
                },
            },
        },
        "no_of_thetas": 10,
        "result_options": {},
    }


def main(device="cuda", dtype=torch.float32, n_teffs=7):
    """Serve the scan; returns the Teffs, the surface F_nu of each request
    [n, N], each request's wall [s] and the service's stats."""
    teffs = np.linspace(5200.0, 6400.0, n_teffs)
    lams = u.Quantity(np.arange(5885.0, 5900.0, 0.02), u.AA)
    spectra, walls = [], []
    with tempfile.TemporaryDirectory(prefix="stardis_serving_") as tmp:
        paths = []
        for i, teff in enumerate(teffs):
            path = f"{tmp}/m{i}.mod"
            write_marcs_file(path, teff=float(teff))
            paths.append(path)
        cfg = f"{tmp}/config.json"
        with open(cfg, "w") as fh:
            json.dump(example_config(paths[0]), fh)
        svc = SpectralService(cfg, lams, device=device, dtype=dtype)

        for teff, path in zip(teffs, paths):
            _, _, model = parse_config_to_model(
                cfg, add_config_dict={"input_model.fname": path}
            )
            t0 = time.perf_counter()
            out = svc.synthesize(model)
            wall = time.perf_counter() - t0
            depth = 1.0 - out["spectrum_nu"].min() / np.median(out["spectrum_nu"])
            print(f"Teff {teff:6.0f} K: Na D depth {depth:.3f}  ({wall * 1e3:7.1f} ms)")
            spectra.append(out["spectrum_nu"])
            walls.append(wall)
    print(f"stats: {svc.stats}")
    return {"teffs": teffs, "spectrum_nu": np.asarray(spectra), "walls": np.asarray(walls),
            "stats": svc.stats}


if __name__ == "__main__":
    main()
