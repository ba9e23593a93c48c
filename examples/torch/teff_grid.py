"""Batched synthesis of a Teff grid of atmospheres, on the card.

The stardis_tpu_torch counterpart of ``examples/teff_grid.py``: 16
atmospheres (Teff 4000-9000 K) as one batch through
``parallel.batch.run_batch`` (stage 1 replayed from its CUDA graph, each
kernel once for the whole batch), then the same batch on a 'batch' mesh
over every visible card (``make_batch_mesh``; with one card, a mesh of
that card, which runs the sharded code on it) and the two compared.

Run:  python examples/torch/teff_grid.py   (needs a GPU)

Small, on the CPU::

    cd examples/torch
    python -c "import teff_grid, torch; teff_grid.main('cpu', torch.float64, n_models=2)"
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
from stardis_tpu_torch.io.marcs import read_marcs_model  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu_torch.parallel.batch import make_batch, make_batch_mesh, run_batch  # noqa: E402


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


def main(device="cuda", dtype=torch.float32, n_models=16):
    """Synthesize the grid; returns the Teffs, the wavelengths [AA], F_nu
    [B, D, N] of the unsharded batch, and whether the mesh's F_nu equals it
    bit for bit."""
    device = torch.device(device)
    teffs = np.linspace(4000.0, 9000.0, n_models)
    with tempfile.TemporaryDirectory(prefix="stardis_grid_") as tmp:
        paths = []
        for teff in teffs:
            p = Path(tmp) / f"t{int(teff)}.mod"
            write_marcs_file(p, teff=float(teff))
            paths.append(p)
        config_path = Path(tmp) / "config.json"
        config_path.write_text(json.dumps(example_config(paths[0])))
        config, adata, model0 = parse_config_to_model(config_path)
        models = [model0] + [
            read_marcs_model(p).to_stellar_model(adata, final_atomic_number=30)
            for p in paths[1:]
        ]

    lams = np.arange(6540.0, 6590.0, 0.05)
    nus = np.asarray(u.Quantity(lams, u.AA).to(u.Hz, u.spectral()))
    plan, batch = make_batch(config, adata, models, nus)
    f_nu = run_batch(plan, batch, device=device, dtype=dtype).cpu().numpy()
    # every visible card (or the CPU); the mesh puts a chunk of models on each
    mesh = make_batch_mesh() if device.type == "cuda" else make_batch_mesh(devices=[device])
    f_mesh = run_batch(plan, batch, mesh=mesh, dtype=dtype).cpu().numpy()
    same = bool(np.array_equal(f_mesh, f_nu))
    emergent = f_nu[:, -1, :]

    print(f"{len(models)} atmospheres x {len(lams)} wavelengths on {device}; "
          f"on a 'batch' mesh of {mesh.devices.size} device(s): equal bit for bit {same}")
    for teff, spec in zip(teffs, emergent):
        print(f"Teff {teff:6.0f} K: mean F_nu {spec.mean():.3e} erg/s/cm^2/Hz")
    return {"teffs": teffs, "lambdas": lams, "F_nu": f_nu, "mesh_equal": same}


if __name__ == "__main__":
    main()
