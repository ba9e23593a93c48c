"""The eight examples of ``examples/torch/`` at a small size on the CPU
(float64), in one subprocess in which ``jax``, ``yaml`` and ``pandas``
cannot be imported, and nothing of the JAX package is imported.  Where an
example computes what the JAX package computes, it is held to the JAX
package on the same inputs at the repo's bars:

* quickstart's and rotation_broadening's F_nu against the JAX package's
  ``run_stardis`` at 1e-9 (and the broadened spectra through its host
  functions);
* flexible_plasma's molecular densities, independent and coupled, against
  ``molecule_number_density_frame`` at 1e-9;
* the first fit step's gradient against ``jax.grad``: the whole pipeline's
  for fit_stellar_parameters (the JAX example's static window), the
  emulator's on the same library for fit_with_emulator, at 1e-8.

The others are checked for what they print and return.  The subprocess
starts with the first test and the JAX references are computed while it
runs.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
pd = pytest.importorskip("pandas")
import jax.numpy as jnp  # noqa: E402

from stardis_tpu import parse_config_to_model as j_parse  # noqa: E402
from stardis_tpu import run_stardis as j_run_stardis  # noqa: E402
from stardis_tpu import units as ju  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_marcs_file  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"
# each example's small size: main("cpu", torch.float64, **SIZES[name])
SIZES = {
    "fit_stellar_parameters": {"steps": 2},
    "quickstart": {"step_aa": 0.5},
    "rotation_broadening": {"step_aa": 0.1},
    "flexible_plasma": {},
    "fit_with_emulator": {"steps": 3},
    "teff_grid": {"n_models": 2},
    "serving_scan": {"n_teffs": 2},
    "full_visible": {"n_points": 4001},
}
BLOCKED = ("jax", "yaml", "pandas")
RUNNER = textwrap.dedent("""
    import contextlib, importlib.util, io, json, sys
    for name in {blocked!r}:
        sys.modules[name] = None  # `import name` raises ImportError
    for name in {blocked!r}:
        try:
            __import__(name)
        except ImportError:
            pass
        else:
            raise SystemExit(f"{{name}} could be imported")
    import numpy as np
    import torch

    torch.set_num_threads(1)
    examples, out_dir, sizes = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    for name, kwargs in sizes.items():
        spec = importlib.util.spec_from_file_location(name, f"{{examples}}/{{name}}.py")
        module = importlib.util.module_from_spec(spec)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            spec.loader.exec_module(module)
            result = module.main("cpu", torch.float64, **kwargs)
        np.savez(f"{{out_dir}}/{{name}}.npz", **{{
            key: np.asarray(v) for key, v in result.items()
            if isinstance(v, (np.ndarray, float, bool, list))}})
        with open(f"{{out_dir}}/{{name}}.txt", "w") as fh:
            fh.write(text.getvalue())
    loaded = [m for m in sys.modules
              if m.split(".")[0] in {blocked!r} + ("stardis_tpu",) and sys.modules[m] is not None]
    print(json.dumps({{"loaded": sorted(loaded)}}))
""").format(blocked=BLOCKED)


@pytest.fixture(scope="module")
def examples_run(tmp_path_factory):
    """Starts the subprocess; returns results(name) -> (arrays, printed
    text), which waits for it the first time."""
    out = tmp_path_factory.mktemp("examples")
    # an empty working directory: the examples write only to their own
    # temporary directories (test_examples_write_nothing_around_them)
    cwd = tmp_path_factory.mktemp("examples_cwd")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-c", RUNNER, str(EXAMPLES), str(out), json.dumps(SIZES)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=cwd)
    done = {}

    def results(name=None):
        if not done:
            stdout, stderr = proc.communicate(timeout=900)
            done.update(rc=proc.returncode, stdout=stdout, stderr=stderr)
        assert done["rc"] == 0, done["stderr"][-4000:]
        if name is None:
            return json.loads(done["stdout"].strip().splitlines()[-1]), cwd
        with np.load(out / f"{name}.npz") as z:
            arrays = {key: z[key] for key in z.files}
        return arrays, (out / f"{name}.txt").read_text()

    yield results
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=60)


def _example(name):
    """The example module, imported here for its configuration and
    constants."""
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_config(module, tmp_path, **model_kw):
    """A YAML config of the example's configuration on a MARCS model written
    as the example writes it."""
    model = tmp_path / "model.mod"
    write_marcs_file(str(model), **model_kw)
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(module.example_config(model)))
    return path


def test_fit_stellar_parameters_first_gradient_matches_jax(examples_run, tmp_path):
    """The first step's gradient d loss / d (scale, v sin i) against
    jax.grad of the JAX example's loss (static window 512) at 1e-8, and
    the loss falls over the steps."""
    from stardis_tpu.constants import C_KMS
    from stardis_tpu.pipeline import (
        build_simulation_plan,
        stage_plasma_and_lines,
        stage_spectrum,
    )
    from stardis_tpu.postprocessing import rotation_broadening_jax

    fit = _example("fit_stellar_parameters")
    config, adata, model = j_parse(str(_jax_config(fit, tmp_path)))
    lams = np.arange(*fit.LAMBDA_RANGE)
    nus = np.asarray(ju.Quantity(lams, ju.AA).to(ju.Hz, ju.spectral()))
    plan = build_simulation_plan(config, adata, model, nus)
    temps, n_elem = jnp.asarray(plan.temperatures), jnp.asarray(plan.n_elem)
    vel_pix = float(fit.LAMBDA_RANGE[2] / lams.mean() * C_KMS)

    def spectrum(p):
        state, lq = stage_plasma_and_lines(plan, temps * p[0], n_elem / p[0])
        surface = stage_spectrum(plan, state, lq, window=512, chunk=256)[0][-1]
        b = rotation_broadening_jax(vel_pix, surface, p[1], half_width_pix=fit.HALF)
        return b / b.mean()

    @jax.jit
    def first_step(p, true):
        observed = jax.lax.stop_gradient(spectrum(true))
        return jax.value_and_grad(lambda q: jnp.mean((spectrum(q) - observed) ** 2))(p)

    value, grad = first_step(jnp.asarray(fit.START), jnp.asarray(fit.TRUE))
    ours, text = examples_run("fit_stellar_parameters")
    np.testing.assert_allclose(ours["losses"][0], float(value), rtol=1e-8)
    np.testing.assert_allclose(ours["grad0"], np.asarray(grad), rtol=1e-8)
    assert len(ours["losses"]) == SIZES["fit_stellar_parameters"]["steps"]
    assert ours["losses"][-1] < ours["losses"][0]
    assert "recovered scale" in text


def test_quickstart_matches_jax_run_stardis(examples_run, tmp_path):
    qs = _example("quickstart")
    path = _jax_config(qs, tmp_path, teff=qs.TEFF, logg=qs.LOGG)
    lam = np.arange(*qs.LAMBDA_RANGE, SIZES["quickstart"]["step_aa"])
    ref = j_run_stardis(str(path), ju.Quantity(lam, ju.AA))
    ours, text = examples_run("quickstart")
    np.testing.assert_array_equal(ours["lambdas"], np.asarray(ref.lambdas))
    np.testing.assert_allclose(ours["spectrum_nu"], np.asarray(ref.spectrum_nu), rtol=1e-9)
    np.testing.assert_allclose(ours["spectrum_lambda"], np.asarray(ref.spectrum_lambda),
                               rtol=1e-9)
    assert "H-alpha core depth" in text


def test_quickstart_plot_needs_matplotlib(monkeypatch):
    """--plot imports matplotlib only when asked, and says so when it is
    missing."""
    qs = _example("quickstart")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="needs matplotlib"):
        qs.plot_spectrum(np.arange(3.0), np.ones(3), "unused.png")


def test_rotation_broadening_matches_jax(examples_run, tmp_path):
    from stardis_tpu.constants import C_KMS
    from stardis_tpu.postprocessing import instrumental_broadening, rotation_broadening

    rb = _example("rotation_broadening")
    step = SIZES["rotation_broadening"]["step_aa"]
    path = _jax_config(rb, tmp_path, teff=rb.TEFF, logg=rb.LOGG)
    ref = j_run_stardis(str(path), ju.Quantity(np.arange(*rb.LAMBDA_RANGE, step), ju.AA))
    lam = np.asarray(ref.lambdas)
    vel_per_pix = ju.Quantity(step / np.mean(lam) * C_KMS, ju.km / ju.s)
    observed = []
    for v_rot in rb.V_ROTS:
        _, f_rot = rotation_broadening(vel_per_pix, ref.lambdas, ref.spectrum_lambda,
                                       v_rot=ju.Quantity(v_rot, ju.km / ju.s))
        observed.append(np.asarray(instrumental_broadening(
            lam, np.asarray(f_rot), resolution=rb.RESOLUTION)[1]))
    ours, text = examples_run("rotation_broadening")
    np.testing.assert_allclose(ours["spectrum_nu"], np.asarray(ref.spectrum_nu), rtol=1e-9)
    np.testing.assert_allclose(ours["observed"], np.asarray(observed), rtol=1e-9)
    assert text.count("H-alpha core") == len(rb.V_ROTS)


def test_flexible_plasma_matches_jax(examples_run):
    """The JAX example's computation (pandas and all) against the port's
    example: every molecule's density, independent and coupled, at 1e-9."""
    from stardis_tpu.atom_data import build_builtin_atom_data
    from stardis_tpu.io.abundances import create_scaled_solar_profile
    from stardis_tpu.plasma import build_plasma_tables, device_tables, solve_lte
    from stardis_tpu.plasma.molecules import (
        build_molecule_tables,
        molecule_number_density_frame,
    )

    fp = _example("flexible_plasma")
    atom_data = build_builtin_atom_data(max_atomic_number=30, include_molecules=True)
    mass_frac = create_scaled_solar_profile(atom_data, final_atomic_number=30,
                                            composition_source="asplund_2020")
    temperatures = np.linspace(3000.0, 10000.0, fp.N_DEPTH)
    masses = atom_data.atom_data.mass
    n_elem = pd.DataFrame(
        (fp.RHO * mass_frac.values / masses.loc[mass_frac.index].values[:, None])
        * np.ones((1, temperatures.size)),
        index=mass_frac.index,
    )
    tables = build_plasma_tables(atom_data, n_elem.index.values)
    state = solve_lte(jnp.asarray(temperatures), jnp.asarray(n_elem.loc[tables.zs].values),
                      device_tables(tables))
    mol_tables = build_molecule_tables(atom_data, tables, temperatures)
    independent = molecule_number_density_frame(mol_tables, state)
    coupled = molecule_number_density_frame(mol_tables, state, coupled=True)

    ours, text = examples_run("flexible_plasma")
    np.testing.assert_array_equal(ours["temperatures"], temperatures)
    assert list(ours["names"]) == list(independent.index)
    np.testing.assert_allclose(ours["independent"], independent.values, rtol=1e-9)
    np.testing.assert_allclose(ours["coupled"], coupled.values, rtol=1e-9)
    # the NumPy read is correctly rounded, as pandas' round-trip parser is
    korg = pd.read_csv(fp.KORG_CSV, float_precision="round_trip")
    np.testing.assert_array_equal(np.stack([fp.read_korg()[c] for c in korg.columns]),
                                  korg.values.T)
    assert "vs Korg.jl" in text and all(name in text for name in independent.index)


def test_fit_with_emulator_first_gradient_matches_jax(examples_run):
    """The first step's gradient d loss / d (Teff, v sin i) through the JAX
    package's GridInterpolator and rotation_broadening_jax on the port's
    library and observed spectrum, at 1e-8; the loss falls."""
    from stardis_tpu.constants import C_KMS
    from stardis_tpu.grid import GridInterpolator
    from stardis_tpu.postprocessing import rotation_broadening_jax

    emu = _example("fit_with_emulator")
    ours, text = examples_run("fit_with_emulator")
    library, surface = ours["library"], ours["observed"]
    assert library.shape == (len(emu.TEFFS), surface.shape[0])
    emul = GridInterpolator(np.asarray(emu.TEFFS), library, log_flux=True)
    lams = np.arange(*emu.LAMBDA_RANGE)
    vel_pix = float(emu.LAMBDA_RANGE[2] / lams.mean() * C_KMS)

    def forward(teff, vrot, spec=None):
        s = emul(teff) if spec is None else spec
        b = rotation_broadening_jax(vel_pix, s, vrot, half_width_pix=emu.HALF)
        return b / b.mean()

    observed = forward(None, emu.TRUE[1], spec=jnp.asarray(surface))
    value, grad = jax.value_and_grad(
        lambda p: jnp.mean((forward(p[0], p[1]) - observed) ** 2))(jnp.asarray(emu.START))
    np.testing.assert_allclose(ours["losses"][0], float(value), rtol=1e-8)
    np.testing.assert_allclose(ours["grad0"], np.asarray(grad), rtol=1e-8)
    assert ours["losses"][-1] < ours["losses"][0]
    assert "scan: 2 chunk(s) computed, 0 resumed" in text


def test_teff_grid_runs_and_its_mesh_equals_the_batch(examples_run):
    ours, text = examples_run("teff_grid")
    n = SIZES["teff_grid"]["n_models"]
    assert ours["F_nu"].shape == (n, 56, len(ours["lambdas"]))
    assert np.isfinite(ours["F_nu"]).all() and (ours["F_nu"][:, -1] > 0).all()
    assert bool(ours["mesh_equal"])
    assert text.count("mean F_nu") == n


def test_serving_scan_answers_every_request(examples_run):
    ours, text = examples_run("serving_scan")
    n = SIZES["serving_scan"]["n_teffs"]
    assert ours["spectrum_nu"].shape[0] == n == len(ours["walls"])
    assert np.isfinite(ours["spectrum_nu"]).all() and (ours["spectrum_nu"] > 0).all()
    assert text.count("Na D depth") == n and "requests=2, compiles=1" in text


def test_full_visible_runs(examples_run):
    ours, text = examples_run("full_visible")
    assert ours["spectrum_lambda"].shape == (SIZES["full_visible"]["n_points"],)
    assert np.isfinite(ours["spectrum_lambda"]).all() and "OK" in text


def test_examples_import_no_jax_yaml_pandas(examples_run):
    """The subprocess refused jax, yaml and pandas and loaded nothing of the
    JAX package; every example wrote its results."""
    assert examples_run()[0]["loaded"] == []
    for name in SIZES:
        assert examples_run(name)[0], name


def test_examples_write_nothing_around_them(examples_run):
    """Models, configs and fit_with_emulator's library chunks go to each
    example's temporary directory: the working directory stays empty and
    nothing is left beside the examples."""
    _, cwd = examples_run()
    assert list(cwd.iterdir()) == []
    assert sorted(p.name for p in EXAMPLES.iterdir() if p.suffix != ".py"
                  and p.name != "__pycache__") == []
