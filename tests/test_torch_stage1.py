"""Stage 1 — LTE plasma solve and per-line quantities: the torch port against
the JAX package on the same host plan, at rtol 1e-10 in float64.

The plans are built by ``stardis_tpu.pipeline.build_simulation_plan`` and
carried over with ``plan_from_reference``; one TARDIS-line config
(builtin:2, H lines) and one VALD config (builtin:30, synthetic lines with
VALD broadening)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from bench_lines import synth_linelist  # noqa: E402
from stardis_tpu import parse_config_to_model, units as u  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.pipeline import (  # noqa: E402
    build_simulation_plan,
    stage_plasma_and_lines,
)
from stardis_tpu_torch import pipeline as tpipe  # noqa: E402
from stardis_tpu_torch.plasma import lte as tlte  # noqa: E402

RTOL = 1e-10
BROADENING = ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(model_path, atom, z_max, vald):
    line = {"disable": False, "broadening": BROADENING}
    if vald:
        line["vald_linelist"] = {"use_linelist": True, "use_vald_broadening": True}
    return {
        "stardis_config_version": 1.0,
        "atom_data": atom,
        "input_model": {"type": "marcs", "fname": model_path, "final_atomic_number": z_max},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"], "line": line},
        "no_of_thetas": 5,
    }


@pytest.fixture(scope="module", params=["tardis", "vald"])
def stage1(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stage1")
    model = str(tmp / "sun.mod")
    write_marcs_file(model)
    vald = request.param == "vald"
    cfg = _config(model, "builtin:30" if vald else "builtin:2", 30 if vald else 2, vald)
    path = tmp / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    config, adata, stellar_model = parse_config_to_model(str(path))
    if vald:
        synth_linelist(adata, 400, lam_lo=6499.0, lam_hi=6511.0)
        lams = np.arange(6500.0, 6510.0, 0.05)
    else:
        lams = np.arange(6540.0, 6590.0, 0.2)
    nus = np.asarray(u.Quantity(lams, u.AA).to(u.Hz, u.spectral()))
    plan = build_simulation_plan(config, adata, stellar_model, nus)
    state, quants = jax.jit(lambda t, n: stage_plasma_and_lines(plan, t, n))(
        jnp.asarray(plan.temperatures), jnp.asarray(plan.n_elem)
    )
    tplan = tpipe.plan_from_reference(plan)
    t_state, t_quants = tpipe.stage_plasma_and_lines(
        tplan, torch.from_numpy(tplan.temperatures), torch.from_numpy(tplan.n_elem),
        tpipe.device_constants(tplan, torch.float64, "cpu"),
    )
    return plan, state, quants, tplan, t_state, t_quants


def test_solve_lte_matches_jax(stage1):
    _, state, _, _, t_state, _ = stage1
    for name in state._fields:
        ours = getattr(t_state, name).numpy()
        ref = np.asarray(getattr(state, name))
        np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=1e-300, err_msg=name)


def test_line_quantities_match_jax(stage1):
    _, _, quants, _, _, t_quants = stage1
    assert quants["atomic"][0].shape[0] > 0
    for name, ours, ref in zip(("alpha", "gamma", "doppler"), t_quants["atomic"], quants["atomic"]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-300,
                                   err_msg=name)


def test_electron_density_is_charge_balanced(stage1):
    """The bisection root plus Newton step balances charge to ~1e-12."""
    _, _, _, tplan, t_state, _ = stage1
    dt = tlte.device_tables(tplan.tables)
    charges = dt.ion_charges[dt.slot_element, dt.slot_ion]
    total = (t_state.ion_number_density * charges[:, None]).sum(dim=0)
    np.testing.assert_allclose(total.numpy(), t_state.electron_densities.numpy(), rtol=1e-10)


def test_newton_derivative_matches_closed_form(stage1):
    """torch.func.jvp of log Q(x) - x equals -Var/Q - 1 with Var the
    density-weighted charge variance at fixed ion fractions."""
    _, _, _, tplan, t_state, _ = stage1
    dt = tlte.device_tables(tplan.tables)
    t = t_state.t
    log_u = tlte._log_partition_functions(dt, t_state.beta, dt.slot_element.shape[0])
    log_phi_tot = tlte._log_phi(dt, log_u, t_state.beta) + t_state.log_g_electron[None, None, :]
    x = torch.log(t_state.electron_densities)
    n_elem = torch.from_numpy(tplan.n_elem)

    def resid(v):
        frac = tlte._ion_fractions(dt, log_phi_tot, v)
        return torch.log((n_elem * (frac * dt.ion_charges[..., None]).sum(1)).sum(0)) - v

    _, dfx = torch.func.jvp(resid, (x,), (torch.ones_like(x),))
    frac = tlte._ion_fractions(dt, log_phi_tot, x)
    q = dt.ion_charges[..., None]
    mean = (frac * q).sum(1)
    var = (frac * q * q).sum(1) - mean**2
    total = (n_elem * mean).sum(0)
    closed = -(n_elem * var).sum(0) / total - 1.0
    np.testing.assert_allclose(dfx.numpy(), closed.numpy(), rtol=1e-9)


SPECIES = ["Hminus_bf", "Hminus_ff", "Heminus_ff", "H2minus_ff", "H2plus_ff", "H2plus_bf",
           "H_I_bf", "H_I_ff", "He_I_bf"]


def test_species_densities_match_jax(stage1):
    from stardis_tpu.opacities import continuum as jcont
    from stardis_tpu_torch.opacities import continuum as tcont

    plan, state, _, tplan, t_state, _ = stage1
    for source in SPECIES:
        ref = jcont.species_density(jcont.plan_species_density(source, plan.tables),
                                    state, plan.tables)
        ours = tcont.species_density(tcont.plan_species_density(source, tplan.tables),
                                     t_state, tplan.tables)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-300,
                                   err_msg=source)
