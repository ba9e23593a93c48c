"""Quickstart: synthesize a solar spectrum around H-alpha on the card.

The stardis_tpu_torch counterpart of ``examples/quickstart.py``: the same
configuration (built-in atomic data, a synthetic gray solar atmosphere,
6540-6590 AA at 0.01 AA, 20 angles), written as a JSON file and run
through ``run_stardis`` on the GPU in float32.  It needs torch, numpy and
scipy only (no jax, PyYAML or pandas).

Run:  python examples/torch/quickstart.py [--plot out.png]   (needs a GPU;
``--plot`` needs matplotlib)

Small, on the CPU::

    cd examples/torch
    python -c "import quickstart, torch; quickstart.main('cpu', torch.float64, step_aa=0.5)"
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

# allow `python examples/torch/<name>.py` from a repo checkout
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stardis_tpu_torch import run_stardis  # noqa: E402
from stardis_tpu_torch import units as u  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_marcs_file  # noqa: E402

TEFF, LOGG = 5777.0, 4.44
LAMBDA_RANGE = (6540.0, 6590.0)  # AA


def example_config(model_path):
    """The example's configuration for a MARCS file at ``model_path``."""
    return {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {
            "type": "marcs",
            "fname": str(model_path),
            "final_atomic_number": 30,
        },
        "opacity": {
            "bf": {"H_I": {}},
            "ff": {"H_I": {}},
            "rayleigh": ["H"],
            "disable_electron_scattering": False,
            "line": {
                "disable": False,
                "broadening": [
                    "radiation",
                    "linear_stark",
                    "quadratic_stark",
                    "van_der_waals",
                ],
            },
        },
        "no_of_thetas": 20,
        "result_options": {},
    }


def plot_spectrum(lam, flux, path):
    """Write the spectrum to a PNG at ``path`` (imports matplotlib here)."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            "quickstart --plot needs matplotlib, which is not installed; run "
            "without --plot, or install matplotlib"
        ) from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(9, 4))
    plt.plot(lam, flux, lw=0.7)
    plt.xlabel(r"wavelength [$\AA$]")
    plt.ylabel(r"$F_\lambda$ [erg/s/cm$^2$/$\AA$]")
    plt.title("stardis_tpu_torch quickstart: solar H$\\alpha$")
    plt.tight_layout()
    plt.savefig(path, dpi=140)
    print(f"wrote {path}")


def main(device="cuda", dtype=torch.float32, step_aa=0.01, plot=None):
    """Run the quickstart; returns the wavelengths [AA] and F_nu and
    F_lambda at the surface."""
    with tempfile.TemporaryDirectory(prefix="stardis_quickstart_") as tmp:
        model_path = Path(tmp) / "sun.mod"
        write_marcs_file(model_path, teff=TEFF, logg=LOGG)
        config_path = Path(tmp) / "stardis_example.json"
        config_path.write_text(json.dumps(example_config(model_path)))
        tracing_lambdas = u.Quantity(np.arange(*LAMBDA_RANGE, step_aa), u.AA)
        sim = run_stardis(config_path, tracing_lambdas, device=device, dtype=dtype)

    lam = np.asarray(sim.lambdas)
    flux = np.asarray(sim.spectrum_lambda)
    core = flux[np.abs(lam - 6564.6) < 0.3].min()
    continuum = flux[np.abs(lam - 6564.6) > 15].mean()
    print(f"spectrum: {len(lam)} points, {lam.min():.1f}-{lam.max():.1f} AA")
    print(f"continuum F_lambda ~ {continuum:.3e} erg/s/cm^2/AA")
    print(f"H-alpha core depth: {100 * core / continuum:.1f}% of continuum")
    if plot:
        plot_spectrum(lam, flux, plot)
    return {"lambdas": lam, "spectrum_nu": np.asarray(sim.spectrum_nu),
            "spectrum_lambda": flux}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--plot", default=None, help="write a PNG here")
    main(plot=parser.parse_args().plot)
