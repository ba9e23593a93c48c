"""Fit stellar parameters through a checkpointed spectral library, on the
card.

The stardis_tpu_torch counterpart of ``examples/fit_with_emulator.py``: a
six-point Teff library (5000-6000 K) is synthesized once with checkpoints
(``grid.synthesize_grid``, chunks in a temporary directory), and Adam
descends on (Teff, v sin i) through the differentiable multilinear
emulator (``grid.GridInterpolator``, log flux) composed with the
differentiable rotational convolution, so each step costs an interpolation
instead of a pipeline run.  The "observed" star (5640 K, off the nodes,
v sin i 9 km/s) is synthesized directly through ``run_batch``.  As in the
other fit, the script reports whether the recovered values are within the
JAX example's tolerances rather than stopping on them.

Run:  python examples/torch/fit_with_emulator.py   (needs a GPU)

Small, on the CPU::

    cd examples/torch
    python -c "import fit_with_emulator as f, torch; f.main('cpu', torch.float64, steps=3)"
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
from stardis_tpu_torch.base import read_stellar_model  # noqa: E402
from stardis_tpu_torch.constants import C_KMS  # noqa: E402
from stardis_tpu_torch.grid import GridInterpolator, load_grid, synthesize_grid  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu_torch.parallel.batch import make_batch, run_batch  # noqa: E402
from stardis_tpu_torch.pipeline import resolve_device  # noqa: E402
from stardis_tpu_torch.postprocessing import rotation_broadening_torch  # noqa: E402

TEFFS = (5000.0, 5200.0, 5400.0, 5600.0, 5800.0, 6000.0)
LAMBDA_RANGE = (6556.0, 6572.0, 0.05)  # AA
HALF = 24
TRUE = (5640.0, 9.0)  # Teff [K], v sin i [km/s]
START = (5300.0, 3.0)
STEP_SCALE = (2000.0, 60.0)
LR, B1, B2 = 5e-2, 0.9, 0.999


def example_config(model_path):
    return {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:5",
        "input_model": {
            "type": "marcs", "fname": str(model_path),
            "final_atomic_number": 5,
        },
        "opacity": {
            "bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
            "line": {"disable": False, "broadening": ["radiation"]},
        },
        "no_of_thetas": 5,
        "result_options": {},
    }


def main(device="cuda", dtype=torch.float32, steps=120):
    """Build the library and fit; returns the library's spectra [6, N], the
    observed surface F_nu, the loss before each step [steps], the gradient
    at the start (d loss / d (Teff, v sin i)) and the final parameters."""
    device = resolve_device(device, "fit_with_emulator")
    lams = np.arange(*LAMBDA_RANGE)
    nus = np.asarray(u.Quantity(lams, u.AA).to(u.Hz, u.spectral()))
    with tempfile.TemporaryDirectory(prefix="stardis_emul_") as tmp:
        tmp = Path(tmp)
        model_paths = []
        for teff in TEFFS:
            p = tmp / f"t{int(teff)}.mod"
            write_marcs_file(p, teff=teff)
            model_paths.append(p)
        cfg = tmp / "c.json"
        cfg.write_text(json.dumps(example_config(model_paths[0])))
        config, adata, _m0 = parse_config_to_model(cfg)
        models = [read_stellar_model(config, adata, p) for p in model_paths]

        # one checkpointed scan; a rerun into the same directory resumes it
        print(f"synthesizing the {len(TEFFS)}-point Teff library ...")
        res = synthesize_grid(
            config, adata, models, nus, tmp / "library", batch_size=3,
            labels=[{"teff": t} for t in TEFFS], device=device, dtype=dtype,
        )
        print(f"  scan: {res['computed']} chunk(s) computed, {res['skipped']} resumed")
        # log_flux: spectra vary near-exponentially in Teff, so interpolating
        # log F roughly halves the mid-cell emulator error
        emul = GridInterpolator.from_scan(tmp / "library", keys=("teff",), log_flux=True,
                                          device=device, dtype=dtype)
        library = load_grid(tmp / "library")[0]

        # "observed" star: direct synthesis off the grid nodes + rotation
        p_obs = tmp / "obs.mod"
        write_marcs_file(p_obs, teff=TRUE[0])
        m_obs = read_stellar_model(config, adata, p_obs)
    plan_b, batch = make_batch(config, adata, [m_obs, m_obs], nus)
    surface = run_batch(plan_b, batch, device=device, dtype=dtype)[0, -1, :]

    vel_pix = float(LAMBDA_RANGE[2] / lams.mean() * C_KMS)  # km/s per pixel

    def forward(teff, vrot, spec=None):
        s = emul(teff) if spec is None else spec
        b = rotation_broadening_torch(vel_pix, s, vrot, half_width_pix=HALF)
        return b / b.mean()

    with torch.no_grad():
        observed = forward(None, TRUE[1], spec=surface)

    params = torch.tensor(START, dtype=dtype, device=device, requires_grad=True)
    pscale = torch.tensor(STEP_SCALE, dtype=dtype, device=device)
    m = v = 0.0
    losses, grad0 = [], None
    print(f"target: Teff {TRUE[0]:.0f} K, v sin i {TRUE[1]:.1f} km/s; "
          f"start ({START[0]:.0f}, {START[1]:.1f})")
    for i in range(steps):
        loss = torch.mean((forward(params[0], params[1]) - observed) ** 2)
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
            params -= LR / (1 + 0.02 * i) * pscale * mhat / (torch.sqrt(vhat) + 1e-12)
        if i % 15 == 0 or i == steps - 1:
            print(f"  iter {i:3d}: loss {losses[-1]:.3e} "
                  f"Teff {float(params[0]):7.1f} vsini {float(params[1]):.2f}")

    teff, vrot = (float(x) for x in params.detach().cpu())
    err_t, err_v = abs(teff - TRUE[0]), abs(vrot - TRUE[1])
    print(f"recovered Teff {teff:.1f} K (|err| {err_t:.1f}), "
          f"v sin i {vrot:.2f} km/s (|err| {err_v:.2f})")
    # the Teff bias budget is the emulator's linear-interpolation error over
    # the 200 K node spacing, not the optimizer
    print(f"within the JAX example's tolerances (40 K, 0.5 km/s): "
          f"{err_t < 40.0 and err_v < 0.5}")
    return {"library": library, "observed": surface.cpu().numpy(),
            "losses": np.asarray(losses), "grad0": grad0, "params": np.asarray([teff, vrot])}


if __name__ == "__main__":
    main()
