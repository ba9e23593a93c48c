"""Golden-store regression data, NumPy only (the port of
``stardis_tpu/util/regression.py``).

Each ``sync_*`` call either records the value (generate mode) or loads the
stored value and compares (test mode).  A store is one ``<key>.npz`` in
``base_dir``.  The port reads the JAX package's committed stores in
``tests/golden/``; generate mode writes a new store, and belongs in a
scratch directory.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class RegressionData:
    def __init__(self, base_dir, key, generate=False, rtol=1e-7, atol=0.0):
        self.base_dir = Path(base_dir)
        self.key = key
        self.generate = generate
        self.rtol = rtol
        self.atol = atol
        self.fpath = self.base_dir / f"{key}.npz"
        self._store = {}
        if not generate:
            if not self.fpath.exists():
                raise FileNotFoundError(
                    f"regression data {self.fpath} missing; run with "
                    "generate=True first"
                )
            with np.load(self.fpath, allow_pickle=False) as store:
                self._store = dict(store)

    def keys(self):
        return list(self._store)

    def __getitem__(self, name):
        return self._store[name]

    def sync_ndarray(self, name, value):
        value = np.asarray(value)
        if self.generate:
            self._store[name] = value
            return value
        expected = self._store[name]
        np.testing.assert_allclose(
            value, expected, rtol=self.rtol, atol=self.atol,
            err_msg=f"regression mismatch for {self.key}/{name}",
        )
        return expected

    def sync_scalar(self, name, value):
        return self.sync_ndarray(name, np.asarray(value))

    def flush(self):
        if self.generate:
            self.base_dir.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(self.fpath, **self._store)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.flush()
        return False


# ----------------------------------------------------------------------
# the JAX package's committed golden stores (tests/golden/), as the port
# runs them: the configurations of tests/test_golden_regression.py
# (solar_halpha), tests/test_golden_plasma.py (solar_nad_plasma) and
# tests/test_carsus_scale.py (carsus_scale), the arrays each store pins,
# and the float32 bars a float32 run is held to
# ----------------------------------------------------------------------

#: each store's wavelength grid (start, stop, step) in AA
GOLDEN_LAMBDAS = {"solar_halpha": (6555.0, 6575.0, 0.1),
                  "solar_nad_plasma": (5885.0, 5900.0, 0.1),
                  "carsus_scale": (5150.0, 5170.0, 0.02)}
#: the stores' own tolerance (float64)
GOLDEN_RTOL = 1e-6


def golden_config(key, model_path, atom_data="builtin:30"):
    """The configuration of golden store ``key`` on a MARCS model file
    (``io.synthetic.write_marcs_file``'s sun).  carsus_scale's atom data
    is the kurucz-scale store (``carsus_scale_atom_data``): pass its
    converted file as ``atom_data``, or hand the AtomData to the run."""
    line = {"disable": False,
            "broadening": ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"]}
    if key in ("solar_nad_plasma", "carsus_scale"):
        line["vald_linelist"] = {"use_linelist": True, "use_vald_broadening": True}
    return {
        "stardis_config_version": 1.0,
        "atom_data": str(atom_data),
        "input_model": {"type": "marcs", "fname": str(model_path), "final_atomic_number": 30},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
                    "disable_electron_scattering": False, "line": line},
        "no_of_thetas": 10,
        "result_options": ({} if key == "solar_nad_plasma" else {"return_plasma": True}),
    }


def carsus_scale_atom_data():
    """carsus_scale's atom data, built in memory (no h5py): the kurucz-scale
    carsus tables of ``atom_data.synthetic_carsus.build_carsus_frames`` at
    their defaults (150,000 lines, 120,000 VALD lines, Z <= 30, molecules),
    converted by ``atom_data.convert.convert_frames``."""
    from ..atom_data.convert import convert_frames
    from ..atom_data.synthetic_carsus import build_carsus_frames

    return convert_frames(build_carsus_frames())


def golden_arrays(key, model_path, device, dtype, atom_data=None):
    """{name: host array} of every array golden store ``key`` pins, from the
    port's run of its configuration on ``device`` in ``dtype``: solar_halpha
    and carsus_scale through ``run_stardis`` (carsus_scale on ``atom_data``,
    by default ``carsus_scale_atom_data()``; the run restricts it to the
    model's elements), solar_nad_plasma through the plan and
    ``pipeline.run_simulation`` (the plasma surface, the static tables, the
    line quantities, every opacity and F_nu)."""
    import torch

    from .. import units as u
    from ..base import parse_config_to_model, run_stardis
    from ..pipeline import build_simulation_plan, run_simulation
    from ..plasma.lte import device_tables, level_boltzmann_factor, saha_phi

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    cfg = golden_config(key, model_path)
    lams = u.Quantity(np.arange(*GOLDEN_LAMBDAS[key]), u.AA)
    if key == "carsus_scale":
        adata = carsus_scale_atom_data() if atom_data is None else atom_data
        out = run_stardis(cfg, lams, device=device, dtype=dtype, atom_data=adata)
        lo, hi = GOLDEN_LAMBDAS[key][:2]
        wl = adata.linelist_atoms.wavelength
        return {
            "nus": np.asarray(out.nus),
            "spectrum_nu": np.asarray(out.spectrum_nu),
            "n_lines_in_window": np.asarray(int(((wl >= lo) & (wl <= hi)).sum())),
            "electron_densities": host(out.stellar_plasma.electron_densities),
        }
    if key == "solar_halpha":
        out = run_stardis(cfg, lams, device=device, dtype=dtype)
        plasma = out.stellar_plasma
        return {
            "lambdas": np.asarray(out.lambdas),
            "spectrum_nu": np.asarray(out.spectrum_nu),
            "spectrum_lambda": np.asarray(out.spectrum_lambda),
            "electron_densities": host(plasma.electron_densities),
            "h_minus_density": host(plasma.h_minus_density),
            "partition_function_h1": host(plasma.partition_function[0]),
        }
    config, adata, model = parse_config_to_model(cfg)
    plan = build_simulation_plan(config, adata, model,
                                 np.asarray(lams.to(u.Hz, u.spectral())))
    f_nu, total, opac, _, state = run_simulation(plan, device=device, dtype=dtype)
    dt = device_tables(plan.tables, dtype=dtype, device=device)
    arrays = {
        "zs": plan.tables.zs, "chi": plan.tables.chi,
        "level_energy": plan.tables.level_energy, "level_g": plan.tables.level_g,
        "metastability": plan.tables.level_meta, "line_nu": plan.line_data.nu,
        "t_electrons": state.t, "beta_rad": state.beta,
        "g_electron": torch.exp(state.log_g_electron),
        "partition_function": state.partition_function,
        "phi": saha_phi(state, dt), "level_boltzmann_factor": level_boltzmann_factor(state, dt),
        "electron_densities": state.electron_densities,
        "ion_number_density": state.ion_number_density,
        "level_number_density": state.level_number_density,
        "number_density": state.number_density, "h_minus_density": state.h_minus_density,
        "h2_density": state.h2_density, "h2_plus_density": state.h2_plus_density,
        "alpha_line_gammas": opac["alpha_line_at_nu_gammas"],
        "alpha_line_doppler": opac["alpha_line_at_nu_doppler_widths"],
        "alpha_line_at_nu": opac["alpha_line_at_nu"],
        "alpha_bf": opac["alpha_bf"], "alpha_ff": opac["alpha_ff"],
        "alpha_rayleigh": opac["alpha_rayleigh"], "alpha_electron": opac["alpha_electron"],
        "total_alphas": total, "F_nu": f_nu,
    }
    return {k: host(v) for k, v in arrays.items()}


#: float32 against a float64 golden store, by kind of array:
#: "grid" ([D, N] opacities, F_nu and the surface spectra): the mixed bound
#:     of tests/test_f32_consistency.py, |err| <= 5e-4 |ref| + 1e-5 of the
#:     row's (depth's) largest |ref|;
#: "partition": partition functions, 1e-4 relative (tests/test_torch_f32.py);
#: "depth" (per-depth densities, Saha and Boltzmann factors, temperatures,
#:     line widths): |err| <= 5e-5 |ref| + 1e-30 of the depth's largest |ref|
#:     over the other axes (float32 loses what lies ~1e-38 below it);
#:     the CPU float32 run needs 2.3e-5 relative (Saha phi) above that floor;
#: "table": host tables the dtype does not touch, at the store's rtol.
F32_KINDS = {
    "lambdas": "table", "nus": "table", "n_lines_in_window": "table", "zs": "table", "chi": "table", "level_energy": "table",
    "level_g": "table", "metastability": "table", "line_nu": "table",
    "spectrum_nu": "grid", "spectrum_lambda": "grid", "F_nu": "grid",
    "total_alphas": "grid", "alpha_line_at_nu": "grid", "alpha_bf": "grid",
    "alpha_ff": "grid", "alpha_rayleigh": "grid", "alpha_electron": "grid",
    "partition_function": "partition", "partition_function_h1": "partition",
}
F32_GRID_REL, F32_GRID_ROW = 5e-4, 1e-5
F32_PARTITION_REL = 1e-4
F32_DEPTH_REL, F32_DEPTH_FLOOR = 5e-5, 1e-30


def f32_kind(name):
    return F32_KINDS.get(name, "depth")


def golden_ratio(value, expected, rtol=GOLDEN_RTOL):
    """max |value - expected| / (rtol |expected|), numpy's
    ``assert_allclose(rtol=rtol)`` as a number: at most 1 passes; inf where
    ``expected`` is 0 and ``value`` is not, or the shapes differ."""
    value = np.asarray(value, dtype=np.float64)
    ref = np.asarray(expected, dtype=np.float64)
    if value.shape != ref.shape:
        return np.inf
    err, nz = np.abs(value - ref), ref != 0
    if (err[~nz] > 0).any():
        return np.inf
    return float((err[nz] / (rtol * np.abs(ref[nz]))).max()) if nz.any() else 0.0


def f32_ratio(name, value, expected):
    """max |value - expected| / bound for a float32 array against a float64
    golden one, the bound by ``f32_kind(name)``: at most 1 passes."""
    kind = f32_kind(name)
    if kind == "table":
        return golden_ratio(value, expected)
    value = np.asarray(value, dtype=np.float64)
    ref = np.asarray(expected, dtype=np.float64)
    if value.shape != ref.shape:
        return np.inf
    err, mag = np.abs(value - ref), np.abs(ref)
    if kind == "grid":
        bound = F32_GRID_REL * mag + F32_GRID_ROW * mag.max(axis=-1, keepdims=True)
    elif kind == "partition":
        bound = F32_PARTITION_REL * mag
    else:
        depth_max = mag.max(axis=tuple(range(mag.ndim - 1)), keepdims=True)
        bound = F32_DEPTH_REL * mag + F32_DEPTH_FLOOR * depth_max
    if (err[bound == 0] > 0).any():
        return np.inf
    nz = bound > 0
    return float((err[nz] / bound[nz]).max()) if nz.any() else 0.0
