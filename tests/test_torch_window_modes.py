"""Accuracy window mode: the port against the JAX package, float64.

* the accuracy half-windows equal floor(JAX window_pixels_accuracy)
  exactly, with a per-depth epsilon (and batched, per model);
* ``accuracy_epsilon`` (epsilon_rel times the per-depth minimum of the
  total continuum) at 1e-12 from the same plan and plasma state;
* the sun with 300 synthetic VALD lines in accuracy mode end to end,
  F_nu at 1e-9.
"""

import copy

import numpy as np
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
from stardis_tpu.opacities import line_kernel as jlk  # noqa: E402
from stardis_tpu.pipeline import (  # noqa: E402
    accuracy_epsilon as j_accuracy_epsilon,
    build_simulation_plan,
    run_simulation,
    stage_plasma_and_lines,
)
from stardis_tpu_torch import pipeline as tpipe  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.atom_data import build_builtin_atom_data  # noqa: E402
from stardis_tpu_torch.opacities import line_kernel as tlk  # noqa: E402
from stardis_tpu_torch.opacities.lines import synth_linelist  # noqa: E402
from stardis_tpu_torch.plasma import lte as tlte  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("batched", [False, True])
def test_accuracy_half_windows_match_jax(batched):
    rng = np.random.default_rng(9)
    n_models, n_lines, n_depth, n_nu = 3, 80, 11, 120
    d_nu = 1.7e9
    shape = (n_models, n_lines, n_depth)
    alpha = 10 ** rng.uniform(-14, 2, shape)
    gamma = 10 ** rng.uniform(7, 11, shape)
    doppler = 10 ** rng.uniform(8.5, 10, shape)
    eps = 10 ** rng.uniform(-12, -6, (n_models, n_depth))
    if not batched:
        alpha, gamma, doppler, eps = alpha[0], gamma[0], doppler[0], eps[0]
    win = np.asarray(jlk.window_pixels_accuracy(
        jnp.asarray(alpha), jnp.asarray(gamma), jnp.asarray(doppler), d_nu,
        epsilon=jnp.asarray(eps)[..., None, :],
    ))
    t = torch.from_numpy
    iw = tlk.window_half_widths(t(alpha), t(gamma), t(doppler), d_nu, n_nu, "accuracy", t(eps))
    assert iw.dtype == torch.int32 and iw.shape == alpha.shape
    np.testing.assert_array_equal(iw.numpy(), np.minimum(np.floor(win), n_nu + 1))
    assert (iw.numpy() < n_nu + 1).any() and (iw.numpy() == n_nu + 1).any()
    with pytest.raises(ValueError, match="epsilon"):
        tlk.window_half_widths(t(alpha), t(gamma), t(doppler), d_nu, n_nu, "accuracy")
    with pytest.raises(ValueError, match="window_mode"):
        tlk.window_half_widths(t(alpha), t(gamma), t(doppler), d_nu, n_nu, "fast")


def _config(model_path):
    return {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": model_path, "final_atomic_number": 30},
        "opacity": {
            "bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
            "line": {
                "disable": False,
                "broadening": ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"],
                "vald_linelist": {"use_linelist": True, "use_vald_broadening": True},
                "window_mode": "accuracy",
                "window_epsilon": 1e-4,
            },
        },
        "no_of_thetas": 4,
        "result_options": {"return_radiation_field": True},
    }


@pytest.fixture(scope="module")
def accuracy_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("accuracy")
    model = str(tmp / "sun.mod")
    write_marcs_file(model)
    cfg = _config(model)
    path = tmp / "c.yml"
    path.write_text(yaml.safe_dump(cfg))
    config, adata, model_j = stardis_tpu.parse_config_to_model(str(path))
    jax_synth_linelist(adata, 300, lam_lo=6499.0, lam_hi=6506.0)
    lams = np.arange(6500.0, 6505.0, 0.05)
    nus = np.asarray(ju.Quantity(lams, ju.AA).to(ju.Hz, ju.spectral()))
    plan = build_simulation_plan(config, adata, model_j, nus)
    assert plan.window_mode == "accuracy"
    return cfg, lams, plan


def test_accuracy_epsilon_matches_jax(accuracy_run):
    _, _, plan = accuracy_run
    state, _ = jax.jit(lambda t, n: stage_plasma_and_lines(plan, t, n))(
        jnp.asarray(plan.temperatures), jnp.asarray(plan.n_elem)
    )
    ref = np.asarray(j_accuracy_epsilon(plan, state))
    t_state = tlte.PlasmaState(*[
        torch.from_numpy(np.array(getattr(state, f))) for f in tlte.PlasmaState._fields
    ])
    ours = tpipe.accuracy_epsilon(tpipe.plan_from_reference(plan), t_state)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-12)


def test_accuracy_mode_end_to_end_matches_jax(accuracy_run):
    cfg, lams, plan = accuracy_run
    f_ref = np.asarray(run_simulation(plan)[0])
    atom_data = synth_linelist(build_builtin_atom_data(30, include_linelists=True), 300,
                               lam_lo=6499.0, lam_hi=6506.0)
    ours = stardis_tpu_torch.run_stardis(copy.deepcopy(cfg), tu.Quantity(lams, tu.AA),
                                         atom_data=atom_data)
    np.testing.assert_allclose(ours.stellar_radiation_field.F_nu.numpy(), f_ref, rtol=1e-9,
                               atol=1e-300)
    # and through the carried JAX plan
    f_carried = tpipe.run_simulation(tpipe.plan_from_reference(plan))[0].numpy()
    np.testing.assert_allclose(f_carried, f_ref, rtol=1e-9, atol=1e-300)
