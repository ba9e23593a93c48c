"""The rest of the JAX package's public surface in the port, against the
JAX package on the same inputs (float64, CPU):

* ``base.set_num_threads``: the same values raise in both packages, and
  ``run_stardis`` refuses ``n_threads: -2`` before it builds a plan, in both;
* ``plasma.create_stellar_plasma`` on the MARCS sun with the builtin atom
  data at the stage-1 bar (1e-9), equal bit for bit to the port's own
  stage 1 of that model, and refusing a missing GPU by default;
* the John 1988 H- fits (``opacities.file_tables``) at 1e-12, zero regions
  included;
* ``opacities.voigt.faddeeva`` at 1e-12 over all four Humlicek regions,
  with an imaginary part of exactly 0;
* ``atom_data.builtin.build_demo_molecule_data`` exactly;
* every top-level public function and class of the JAX package has its
  counterpart, but for the names ROADMAP.md leaves out on purpose.
"""

import logging

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import stardis_tpu  # noqa: E402
import stardis_tpu_torch  # noqa: E402
from stardis_tpu import base as jbase  # noqa: E402
from stardis_tpu import units as ju  # noqa: E402
from stardis_tpu.atom_data.builtin import build_demo_molecule_data as j_demo  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.opacities import file_tables as jft  # noqa: E402
from stardis_tpu.opacities import voigt as jvoigt  # noqa: E402
from stardis_tpu.plasma import create_stellar_plasma as j_create  # noqa: E402
from stardis_tpu_torch import base as tbase  # noqa: E402
from stardis_tpu_torch import pipeline as tpipe  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.atom_data.builtin import build_demo_molecule_data as t_demo  # noqa: E402
from stardis_tpu_torch.opacities import file_tables as tft  # noqa: E402
from stardis_tpu_torch.opacities import voigt as tvoigt  # noqa: E402
from stardis_tpu_torch.plasma import create_stellar_plasma as t_create  # noqa: E402

STAGE1_BAR = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(model_path, n_threads=None):
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": str(model_path),
                        "final_atomic_number": 30},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
                    "line": {"disable": False, "broadening": ["radiation"]}},
        "no_of_thetas": 3,
        "result_options": {},
    }
    if n_threads is not None:
        cfg["n_threads"] = n_threads
    return cfg


@pytest.fixture(scope="module")
def sun(tmp_path_factory):
    """The MARCS sun: (path of its model file, YAML config path)."""
    tmp = tmp_path_factory.mktemp("sun")
    model = tmp / "sun.mod"
    write_marcs_file(str(model))
    path = tmp / "config.yml"
    path.write_text(yaml.safe_dump(_config(model)))
    return model, path


# ----------------------------------------------------------------------
# set_num_threads and n_threads
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_threads", [-2, -1, -98, -100, 0])
def test_set_num_threads_raises_where_jax_does(n_threads):
    with pytest.raises(ValueError) as jax_exc:
        jbase.set_num_threads(n_threads)
    with pytest.raises(ValueError) as ours:
        tbase.set_num_threads(n_threads)
    assert str(ours.value) == str(jax_exc.value)


@pytest.mark.parametrize("n_threads", [1, 4, -99])
def test_set_num_threads_accepts_what_jax_does(n_threads, caplog):
    assert jbase.set_num_threads(n_threads) is None
    with caplog.at_level(logging.INFO, logger="stardis_tpu_torch.base"):
        assert tbase.set_num_threads(n_threads) is None
    (record,) = [r for r in caplog.records if r.name == "stardis_tpu_torch.base"]
    text = record.getMessage()
    assert "card" in text and "TPU" not in text and "XLA" not in text
    # no state changes: torch's CPU thread count stays as it was
    assert torch.get_num_threads() == 1


def test_run_stardis_refuses_n_threads_before_the_plan(sun, tmp_path, monkeypatch):
    """n_threads: -2 raises in both packages' run_stardis before a plan is
    built (build_simulation_plan is replaced by a function that fails the
    test)."""
    model, _ = sun
    bad = tmp_path / "bad.yml"
    bad.write_text(yaml.safe_dump(_config(model, n_threads=-2)))

    def no_plan(*args, **kwargs):
        raise AssertionError("a plan was built for a refused n_threads")

    monkeypatch.setattr(jbase, "build_simulation_plan", no_plan)
    monkeypatch.setattr(tbase, "build_simulation_plan", no_plan)
    lam_j = ju.Quantity(np.arange(6560.0, 6570.0, 1.0), ju.AA)
    lam_t = tu.Quantity(np.arange(6560.0, 6570.0, 1.0), tu.AA)
    with pytest.raises(ValueError, match="n_threads"):
        stardis_tpu.run_stardis(str(bad), lam_j)
    with pytest.raises(ValueError, match="n_threads"):
        stardis_tpu_torch.run_stardis(str(bad), lam_t, device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="n_threads"):
        stardis_tpu_torch.run_stardis(_config(model, n_threads=-2), lam_t, device="cpu",
                                      dtype=torch.float64)


def test_run_stardis_runs_with_n_threads_0(sun):
    """0 means 'max' (-99) in both packages, and the run goes through."""
    model, _ = sun
    lam = tu.Quantity(np.arange(6560.0, 6570.0, 1.0), tu.AA)
    out = stardis_tpu_torch.run_stardis(_config(model, n_threads=0), lam, device="cpu",
                                        dtype=torch.float64)
    spec = np.asarray(out.spectrum_nu)
    assert spec.shape == (10,) and np.isfinite(spec).all() and (spec > 0).all()


# ----------------------------------------------------------------------
# create_stellar_plasma
# ----------------------------------------------------------------------

def test_create_stellar_plasma_matches_jax(sun):
    """Every PlasmaState field at 1e-9 on the MARCS sun, and the same
    species tables."""
    _, path = sun
    _, j_adata, j_model = stardis_tpu.parse_config_to_model(str(path))
    _, t_adata, t_model = stardis_tpu_torch.parse_config_to_model(str(path))
    j_state, j_tables = j_create(j_model, j_adata)
    t_state, t_tables = t_create(t_model, t_adata, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(t_tables.zs, j_tables.zs)
    assert t_state._fields == j_state._fields
    for name in j_state._fields:
        ours, ref = getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name))
        assert ours.shape == ref.shape, name
        np.testing.assert_allclose(ours, ref, rtol=STAGE1_BAR, atol=0, err_msg=name)


def test_create_stellar_plasma_is_the_models_stage1(sun):
    """The state has the bits of the same model's stage 1 as run_stardis
    runs it (one torch thread)."""
    _, path = sun
    config, adata, model = stardis_tpu_torch.parse_config_to_model(str(path))
    nus = tu.Quantity(np.arange(6560.0, 6570.0, 1.0), tu.AA).to(tu.Hz, tu.spectral()).value
    plan = tpipe.build_simulation_plan(config, adata, model, nus)
    consts = tpipe.device_constants(plan, torch.float64, "cpu")
    stage1, _ = tpipe.stage_plasma_and_lines(
        plan, torch.as_tensor(plan.temperatures), torch.as_tensor(plan.n_elem), consts)
    state, tables = t_create(model, adata, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(tables.zs, plan.tables.zs)
    for name in state._fields:
        assert torch.equal(getattr(state, name), getattr(stage1, name)), name


def test_create_stellar_plasma_needs_a_gpu_by_default(sun, monkeypatch):
    _, path = sun
    _, adata, model = stardis_tpu_torch.parse_config_to_model(str(path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_create(model, adata)


# ----------------------------------------------------------------------
# John 1988 H- fits, faddeeva, build_demo_molecule_data
# ----------------------------------------------------------------------

def test_john88_fits_match_jax():
    lam = np.linspace(1000.0, 20000.0, 3801)  # AA
    temps = np.linspace(1000.0, 12000.0, 45)  # K
    bf_j, bf_t = jft.john88_hminus_bf_sigma(lam), tft.john88_hminus_bf_sigma(lam)
    # zero below 1250 AA and above the 16419 AA threshold, in both
    outside = (lam <= 1250.0) | (lam >= 16419.0)
    assert outside.any() and (bf_t[outside] == 0).all() and (bf_j[outside] == 0).all()
    assert (bf_t[~outside] > 0).all()
    np.testing.assert_allclose(bf_t, bf_j, rtol=1e-12, atol=0)
    ff_j, ff_t = jft.john88_hminus_ff_sigma(lam, temps), tft.john88_hminus_ff_sigma(lam, temps)
    assert ff_t.shape == (len(temps), len(lam))
    assert (ff_t == 0).any() and (ff_t > 0).any()  # the clipped region is covered
    np.testing.assert_array_equal(ff_t == 0, ff_j == 0)
    np.testing.assert_allclose(ff_t, ff_j, rtol=1e-12, atol=0)
    # scalars take the same path
    np.testing.assert_allclose(tft.john88_hminus_ff_sigma(8000.0, 5000.0),
                               jft.john88_hminus_ff_sigma(8000.0, 5000.0), rtol=1e-12)


def _humlicek_region(x, y):
    s = np.abs(x) + y
    return np.where(s >= 15.0, 1, np.where(s >= 5.5, 2,
                    np.where(y >= 0.195 * np.abs(x) - 0.176, 3, 4)))


def test_faddeeva_matches_jax_in_all_regions():
    x = np.linspace(-25.0, 25.0, 201)
    y = np.concatenate([[0.0], np.logspace(-6, 1.5, 60)])
    xx, yy = np.meshgrid(x, y)
    regions = _humlicek_region(xx, yy)
    assert set(np.unique(regions)) == {1, 2, 3, 4}
    z = xx + 1j * yy
    ref = np.asarray(jvoigt.faddeeva(jnp.asarray(z)))
    ours = tvoigt.faddeeva(torch.as_tensor(z))
    assert ours.dtype == torch.complex128 and ours.shape == z.shape
    assert (ours.imag == 0).all()
    np.testing.assert_allclose(ours.real.numpy(), ref.real, rtol=1e-12, atol=0)
    # anything torch.as_tensor takes: a NumPy array, a real tensor (y = 0)
    np.testing.assert_array_equal(tvoigt.faddeeva(z).numpy(), ours.numpy())
    real = tvoigt.faddeeva(torch.as_tensor(x))
    np.testing.assert_allclose(real.real.numpy(),
                               np.asarray(jvoigt.faddeeva(jnp.asarray(x))).real,
                               rtol=1e-12, atol=0)
    assert (real.imag == 0).all()


def test_build_demo_molecule_data_matches_jax_exactly():
    ref, ours = j_demo(), t_demo()
    assert ours.names == list(ref.equilibrium_constants.index)
    np.testing.assert_array_equal(ours.equilibrium_temperatures,
                                  ref.equilibrium_constants.columns.values.astype(float))
    np.testing.assert_array_equal(ours.log_equilibrium_constants,
                                  ref.equilibrium_constants.values)
    np.testing.assert_array_equal(ours.partition_temperatures,
                                  ref.partition_functions.columns.values.astype(float))
    np.testing.assert_array_equal(ours.partition_functions, ref.partition_functions.values)
    assert ours.ion1 == list(ref.dissociation_energies.Ion1)
    assert ours.ion2 == list(ref.dissociation_energies.Ion2)
    np.testing.assert_array_equal(ours.dissociation_energies,
                                  ref.dissociation_energies.dissociation_energy.values)


# ----------------------------------------------------------------------
# the public surface as a whole
# ----------------------------------------------------------------------

# names of the JAX package the port leaves out on purpose (ROADMAP.md):
# the TPU schedules, and names the port carries under names of its own
LEFT_OUT = {
    "opacities/line_kernel.py": {
        "BlockedTiers", "accumulate_line_opacity", "accumulate_line_opacity_blocked",
        "accumulate_line_opacity_reference", "accumulate_line_opacity_tiered",
        "accumulate_pairs_blocked", "assign_window_tiers", "assign_window_tiers_blocked",
        "assign_window_tiers_from_block_max", "auto_chunk", "block_max_windows",
        "blocked_tiers_on_device", "choose_window", "grid_center_gap_px", "is_dense_tier",
        "panel_schedule", "split_core_half", "split_enabled", "split_panel",
        "use_panelized", "window_overshoot_stats"},
    "parallel/batch.py": {"batch_window_tiers"},
    "parallel/sharding.py": {"bucket_pair_programs_per_shard", "bucket_pairs_per_shard"},
    "pipeline.py": {"line_window_tiers", "max_window_pixels"},
    "plasma/molecules.py": {"molecule_number_density_frame"},  # -> _table
    "postprocessing.py": {"gaussian_kernel_jax", "instrumental_broadening_jax",
                          "rotation_broadening_jax", "rotation_kernel_jax"},  # -> _torch
}


def _public_names(path):
    import ast

    tree = ast.parse(path.read_text())
    return {node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_")}


def test_every_public_name_of_the_jax_package_is_ported():
    """Every module of the JAX package has its counterpart file, holding
    each of its top-level public functions and classes but the ones left
    out on purpose; the renamed ones exist under their port names."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    missing = {}
    for path in sorted((root / "stardis_tpu").rglob("*.py")):
        rel = path.relative_to(root / "stardis_tpu").as_posix()
        ours = root / "stardis_tpu_torch" / rel
        assert ours.exists(), rel
        gap = _public_names(path) - _public_names(ours) - LEFT_OUT.get(rel, set())
        if gap:
            missing[rel] = sorted(gap)
    assert missing == {}
    port = root / "stardis_tpu_torch"
    assert "molecule_number_density_table" in _public_names(port / "plasma/molecules.py")
    assert {"rotation_broadening_torch", "instrumental_broadening_torch",
            "rotation_kernel_torch", "gaussian_kernel_torch"} <= _public_names(
                port / "postprocessing.py")
