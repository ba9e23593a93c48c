"""Wavelength segments: ``run_stardis(nu_segments=K)`` and
``parallel.sharding.segmented_spectrum`` on the CPU in float64.

* the plain range sum equals the columns of the full plain sum exactly,
  through the same prepared inputs the segments share;
* segmented == the port's unsegmented run at 1e-12 and == the JAX
  package's ``segmented_spectrum`` at 1e-9, on grids whose size K does not
  divide: the Sim100AA configuration cut to 500 lambda and 300 synthetic
  lines with return_radiation_field (F_nu, I_nu, every opacity key and its
  values, the total), in reference and in accuracy windows (the epsilon
  of a pass over the ranges against the whole grid's at 1e-15), and the spherical giant
  with three file tables, molecules and molecular lines;
* segment_walls, and the return forms without collect_opacities.
"""

import copy
import dataclasses

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import stardis_tpu  # noqa: E402
import stardis_tpu_torch  # noqa: E402
from bench_lines import synth_linelist as jax_synth_linelist  # noqa: E402
from stardis_tpu import units as ju  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.parallel.sharding import segmented_spectrum as jax_segmented  # noqa: E402
from stardis_tpu.pipeline import (  # noqa: E402
    build_simulation_plan,
    line_window_tiers,
    stage_plasma_and_lines,
)
from stardis_tpu_torch import pipeline as tpipe  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.atom_data import build_builtin_atom_data  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_opacity_tables  # noqa: E402
from stardis_tpu_torch.opacities import line_kernel as tlk  # noqa: E402
from stardis_tpu_torch.opacities.lines import synth_linelist, synth_molecule_linelist  # noqa: E402
from stardis_tpu_torch.parallel import sharding as tshard  # noqa: E402

K = 3
N_LINES, N_MOL_LINES = 300, 200
LINE_RANGE = (6499.0, 6506.0)
LAMS = np.arange(6500.0, 6505.0, 0.01)  # 500 points: K = 3 does not divide
CPU = {"device": "cpu", "dtype": torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sim100aa_config(model, window_mode="reference"):
    return {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": model, "final_atomic_number": 30},
        "opacity": {
            "bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
            "disable_electron_scattering": False,
            "line": {
                "disable": False,
                "broadening": ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"],
                "vald_linelist": {"use_linelist": True, "use_vald_broadening": True},
                "window_mode": window_mode,
            },
        },
        "no_of_thetas": 4,
        "result_options": {"return_radiation_field": True},
    }


def _giant_config(tmp_path, model):
    cfg = _sim100aa_config(model)
    cfg["opacity"]["file"] = write_opacity_tables(tmp_path)
    cfg["opacity"]["rayleigh"] = ["H", "H2"]
    cfg["opacity"]["line"]["include_molecules"] = True
    return cfg


def _jax_segmented(tmp_path, cfg, molecules=None):
    """The JAX package's segmented_spectrum (K segments, opacities
    collected) on the same config and synthetic lines."""
    path = tmp_path / "c.yml"
    path.write_text(yaml.safe_dump(cfg))
    config, adata, model = stardis_tpu.parse_config_to_model(str(path))
    jax_synth_linelist(adata, N_LINES, *LINE_RANGE)
    if molecules is not None:
        adata.linelist_molecules = pd.DataFrame(dict(molecules.columns))
    nus = np.asarray(ju.Quantity(LAMS, ju.AA).to(ju.Hz, ju.spectral()))
    plan = build_simulation_plan(config, adata, model, nus)
    state, lq = jax.jit(lambda t, n: stage_plasma_and_lines(plan, t, n))(
        jnp.asarray(plan.temperatures), jnp.asarray(plan.n_elem))
    window = line_window_tiers(plan, lq, state)
    f_nu, i_nus, opac, total = jax_segmented(plan, state, lq, window, n_segments=K,
                                             chunk=None, collect_opacities=True)
    return np.asarray(f_nu), np.asarray(i_nus), opac, np.asarray(total)


def _port_runs(cfg, atom_data):
    lam = tu.Quantity(LAMS, tu.AA)
    whole = stardis_tpu_torch.run_stardis(copy.deepcopy(cfg), lam, atom_data=atom_data, **CPU)
    parts = stardis_tpu_torch.run_stardis(copy.deepcopy(cfg), lam, atom_data=atom_data,
                                          nu_segments=K, **CPU)
    return whole.stellar_radiation_field, parts.stellar_radiation_field


def _check(whole, parts, ref):
    f_ref, i_ref, opac_ref, total_ref = ref
    np.testing.assert_allclose(parts.F_nu.numpy(), whole.F_nu.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(parts.I_nus.numpy(), whole.I_nus.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(parts.F_nu.numpy(), f_ref, rtol=1e-9, atol=1e-300)
    np.testing.assert_allclose(parts.I_nus.numpy(), i_ref, rtol=1e-9, atol=1e-300)
    opac, opac_whole = parts.opacities.opacities_dict, whole.opacities.opacities_dict
    assert set(opac) == set(opac_whole) == set(opac_ref)
    for key, val in opac.items():
        assert isinstance(val, np.ndarray)
        np.testing.assert_allclose(val, opac_whole[key].numpy(), rtol=1e-12, atol=0,
                                   err_msg=key)
        np.testing.assert_allclose(val, np.asarray(opac_ref[key]), rtol=1e-9, atol=1e-300,
                                   err_msg=key)
    np.testing.assert_allclose(parts.opacities.total_alphas,
                               whole.opacities.total_alphas.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(parts.opacities.total_alphas, total_ref, rtol=1e-9, atol=1e-300)


@pytest.mark.parametrize("window_mode", ["reference", "accuracy"])
def test_segmented_run_stardis_matches_unsegmented_and_jax(tmp_path, window_mode):
    model = str(tmp_path / "sun.mod")
    write_marcs_file(model)
    cfg = _sim100aa_config(model, window_mode)
    atom_data = synth_linelist(build_builtin_atom_data(30, include_linelists=True), N_LINES,
                               *LINE_RANGE)
    whole, parts = _port_runs(cfg, atom_data)
    _check(whole, parts, _jax_segmented(tmp_path, cfg))


def test_segmented_giant_with_files_and_molecules(tmp_path):
    model = str(tmp_path / "giant.mod")
    write_marcs_file(model, teff=4000.0, logg=2.0, spherical=True, radius_cm=2e12)
    cfg = _giant_config(tmp_path, model)
    atom_data = build_builtin_atom_data(30, include_linelists=True, include_molecules=True)
    synth_linelist(atom_data, N_LINES, *LINE_RANGE)
    synth_molecule_linelist(atom_data, N_MOL_LINES, *LINE_RANGE)
    whole, parts = _port_runs(cfg, atom_data)
    assert "molecule_alpha_line_at_nu" in parts.opacities.opacities_dict
    assert "alpha_file_Hminus_bf" in parts.opacities.opacities_dict
    _check(whole, parts, _jax_segmented(tmp_path, cfg, atom_data.linelist_molecules))


def _plan(tmp_path, window_mode="reference", track=True):
    model = str(tmp_path / "sun.mod")
    write_marcs_file(model)
    cfg = _sim100aa_config(model, window_mode)
    cfg["result_options"]["return_radiation_field"] = track
    atom_data = synth_linelist(build_builtin_atom_data(30, include_linelists=True), N_LINES,
                               *LINE_RANGE)
    config, adata, stellar_model = stardis_tpu_torch.parse_config_to_model(
        cfg, atom_data=atom_data)
    nus = tu.Quantity(LAMS, tu.AA).to(tu.Hz, tu.spectral()).value
    plan = tpipe.build_simulation_plan(config, adata, stellar_model, nus)
    temps = torch.as_tensor(plan.temperatures)
    consts = tpipe.device_constants(plan, torch.float64, "cpu")
    state, lq = tpipe.stage_plasma_and_lines(plan, temps, torch.as_tensor(plan.n_elem), consts)
    return plan, state, lq, consts


def test_segments_epsilon_equals_accuracy_epsilon(tmp_path):
    plan, state, _, consts = _plan(tmp_path, "accuracy")
    ranges = tshard.segment_ranges(len(plan.tracing_nus), K)
    ours = tpipe.accuracy_epsilon(plan, [state], consts, ranges=ranges)
    whole = tpipe.accuracy_epsilon(plan, [state], consts)
    assert ours.shape == whole.shape == (1, len(plan.temperatures))
    np.testing.assert_allclose(ours.numpy(), whole.numpy(), rtol=1e-15, atol=0)


def test_segment_walls_and_return_forms(tmp_path):
    plan, state, lq, consts = _plan(tmp_path, track=False)
    whole = tpipe.stage_spectrum(plan, state, lq, consts)[0]
    walls = []
    f_nu = tshard.segmented_spectrum(plan, state, lq, K, consts, segment_walls=walls)
    assert torch.is_tensor(f_nu) and len(walls) == K and all(w > 0 for w in walls)
    np.testing.assert_allclose(f_nu.numpy(), whole.numpy(), rtol=1e-12, atol=0)
    tracked = dataclasses.replace(plan, track_individual_intensities=True)
    f_t, i_t = tshard.segmented_spectrum(tracked, state, lq, 7, consts)
    assert i_t.shape == (56, len(LAMS), 4)
    np.testing.assert_allclose(f_t.numpy(), whole.numpy(), rtol=1e-12, atol=0)
    assert tshard.segment_ranges(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    with pytest.raises(ValueError, match="n_segments"):
        tshard.segment_ranges(10, 0)


def _random_lines(seed, n_lines=120, n_depth=6, n_nu=700):
    rng = np.random.default_rng(seed)
    nus = np.linspace(4.6e14, 4.59e14, n_nu)
    line_nu = np.sort(rng.uniform(nus.min() - 2e10, nus.max() + 2e10, n_lines))
    doppler = rng.uniform(1e9, 5e9, (n_lines, n_depth))
    gamma = rng.uniform(1e8, 2e10, (n_lines, n_depth))
    alpha = rng.uniform(0.1, 1.0, (n_lines, n_depth)) * 10 ** rng.uniform(-8, 2, (n_lines, 1))
    nu_ref = float(nus[n_nu // 2])
    t = torch.from_numpy
    iw = tlk.window_half_widths(t(alpha), t(gamma), t(doppler), tlk.grid_min_step(nus), n_nu)
    return (t(nus - nu_ref), t(line_nu - nu_ref),
            t(tlk.line_center_indices(nus, line_nu)), t(alpha), t(gamma), t(doppler), iw)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_range_equals_columns_of_full_sum(seed):
    """Lines centred outside a range still reach into it: each range must
    equal the full sum's columns exactly, and the ranges' launch through
    the shared prepared inputs gives the same."""
    args = _random_lines(seed)
    n_nu = args[0].shape[0]
    full = tlk.accumulate_line_opacity_plain(*args, budget=1 << 14)
    prepared = tlk.prepare_line_opacity(*args)
    for k in (2, K, 7):
        for a, b in tshard.segment_ranges(n_nu, k):
            part = tlk.accumulate_line_opacity_plain(*args, budget=1 << 14, p_begin=a,
                                                     n_out=b - a)
            np.testing.assert_array_equal(part.numpy(), full[:, a:b].numpy())
            np.testing.assert_array_equal(
                tlk.line_opacity_range(prepared, a, b - a).numpy(),
                tlk.line_opacity_range(prepared)[:, a:b].numpy())
    assert full.abs().max() > 0
    with pytest.raises(ValueError, match="outside"):
        tlk.line_opacity_range(prepared, n_nu - 5, 10)
