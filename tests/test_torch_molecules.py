"""Molecules: the port against the JAX package on the same inputs, float64.

* the builtin Huber & Herzberg tables and the plan's K(T) / U(T) tables at
  1e-12;
* pairwise (closed-form) and coupled-network densities at 1e-10 from the
  same plasma state, plus a float32 case at k ~ 1e22 that stays finite;
* molecular line quantities (alpha, gamma, Doppler; all broadening flags,
  scaled-vdW-only rule) at 1e-10;
* the cool-star MgH run of tests/test_molecules_and_vald.py end to end,
  pairwise and coupled, F_nu at 1e-9, with the port's own host phase, and
  the densities that ``stellar_plasma.molecule_number_density`` exposes.
"""

import copy

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import stardis_tpu_torch  # noqa: E402
from stardis_tpu import parse_config_to_model, units as ju  # noqa: E402
from stardis_tpu.atom_data import build_builtin_atom_data as j_builtin  # noqa: E402
from stardis_tpu.atom_data.builtin import build_molecule_data_hh as j_tables  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.pipeline import build_simulation_plan, run_simulation  # noqa: E402
from stardis_tpu.plasma import molecules as jmol  # noqa: E402
from stardis_tpu.plasma.lte import device_tables, solve_lte  # noqa: E402
from stardis_tpu.plasma.tables import build_plasma_tables  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.atom_data import Table  # noqa: E402
from stardis_tpu_torch.atom_data import build_builtin_atom_data as t_builtin  # noqa: E402
from stardis_tpu_torch.atom_data.builtin import build_molecule_data_hh as t_tables  # noqa: E402
from stardis_tpu_torch.base import _load_atom_data  # noqa: E402
from stardis_tpu_torch.plasma import lte as tlte  # noqa: E402
from stardis_tpu_torch.plasma import molecules as tmol  # noqa: E402

RTOL = 1e-10
FLAGS = ("radiation", "linear_stark", "quadratic_stark", "van_der_waals")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _linelist():
    """CO, H2, MgH, OH and an unknown molecule; packed vdW negative
    (scaled law), 0 and in (0, 20) (no contribution)."""
    return {
        "molecule": np.array(["CO", "H2", "MgH", "OH", "XY", "CO"]),
        "wavelength": np.array([6550.0, 6560.0, 6565.0, 6570.0, 6555.0, 6900.0]),
        "log_gf": np.array([-2.0, -3.0, 0.5, -1.5, -1.0, -1.0]),
        "e_low": np.array([0.1, 0.5, 0.0, 0.3, 0.2, 0.2]),
        "j_lo": np.array([10.0, 2.0, 5.0, 3.0, 1.0, 1.0]),
        "j_up": np.array([11.0, 3.0, 6.0, 4.0, 2.0, 2.0]),
        "rad": np.array([7.0, 7.5, 7.5, 6.5, 7.0, 7.0]),
        "stark": np.array([-5.0, 0.0, -5.5, -6.0, 0.0, 0.0]),
        "waals": np.array([-7.3, 0.0, 7.5, -7.8, 0.0, 0.0]),
    }


@pytest.fixture(scope="module")
def mol_setup():
    """The JAX package's molecule fixture (tests/test_molecules_and_vald.py),
    Mg included: JAX state, plasma tables and molecular tables, and the
    port's tables from its own atom data."""
    ad = j_builtin(max_atomic_number=12, include_linelists=True, include_molecules=True)
    tables = build_plasma_tables(ad)
    temps = np.array([3000.0, 4000.0, 5000.0, 6000.0])
    n_elem = np.zeros((tables.n_elements, 4))
    for i, z in enumerate(tables.zs):
        scale = {1: 1.0, 2: 0.085, 6: 2.7e-4, 8: 4.9e-4, 12: 3.9e-5}.get(int(z), 1e-6)
        n_elem[i] = 1e17 * scale
    state = solve_lte(jnp.asarray(temps), jnp.asarray(n_elem), device_tables(tables))
    mt = jmol.build_molecule_tables(ad, tables, temps)
    t_state = tlte.PlasmaState(*[
        torch.from_numpy(np.array(getattr(state, f))) for f in tlte.PlasmaState._fields
    ])
    tad = t_builtin(max_atomic_number=12, include_linelists=True, include_molecules=True)
    t_mt = tmol.build_molecule_tables(tad, tables, temps)
    return ad, tad, tables, temps, state, t_state, mt, t_mt


def test_builtin_molecule_tables_match_jax():
    ref, ours = j_tables(), t_tables()
    assert ours.names == list(ref.equilibrium_constants.index)
    np.testing.assert_allclose(ours.log_equilibrium_constants,
                               ref.equilibrium_constants.values, rtol=1e-12)
    np.testing.assert_allclose(ours.partition_functions, ref.partition_functions.values,
                               rtol=1e-12)
    np.testing.assert_array_equal(ours.equilibrium_temperatures,
                                  ref.equilibrium_constants.columns.values.astype(float))
    assert ours.ion1 == list(ref.dissociation_energies.Ion1)
    assert ours.ion2 == list(ref.dissociation_energies.Ion2)
    np.testing.assert_array_equal(ours.dissociation_energies,
                                  ref.dissociation_energies.dissociation_energy.values)
    assert _load_atom_data("builtin:8").molecule_data is not None
    assert t_builtin(8).molecule_data is None


def test_molecule_tables_match_jax(mol_setup):
    *_, mt, t_mt = mol_setup
    assert t_mt.names == mt.names
    for field in ("ion1_slot", "ion2_slot", "homonuclear", "included", "mass"):
        np.testing.assert_array_equal(getattr(t_mt, field), getattr(mt, field), err_msg=field)
    np.testing.assert_allclose(t_mt.k_density, mt.k_density, rtol=1e-12)
    np.testing.assert_allclose(t_mt.partition_function, mt.partition_function, rtol=1e-12)
    assert tmol.parse_molecular_ion("H+") == (1, 1)
    assert tmol.parse_molecular_ion("O-") == (8, -1)


@pytest.mark.parametrize("coupled", [False, True], ids=["pairwise", "coupled"])
def test_molecule_densities_match_jax(mol_setup, coupled):
    *_, state, t_state, mt, t_mt = mol_setup
    if coupled:
        ref, x_ref = jmol.molecule_number_density_coupled(mt, state, return_aux=True)
        ours, x = tmol.molecule_number_density_coupled(t_mt, t_state, return_aux=True)
        np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=RTOL)
        resid = tmol.coupled_network_residual(t_mt, t_state, x, ours)
        ref_resid = jmol.coupled_network_residual(mt, state, x_ref, ref)
        assert float(resid) < 1e-9
        np.testing.assert_allclose(float(resid), float(ref_resid), rtol=1e-3, atol=1e-14)
    else:
        ref = jmol.molecule_number_density(mt, state)
        ours = tmol.molecule_number_density(t_mt, t_state)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-300)
    assert (ours.numpy()[mt.index_of("H2")] > 0).all()


def test_float32_densities_stay_finite_at_large_k(mol_setup):
    """k ~ 1e22 (hot layers): k (k + 8N) overflows float32; the scaled
    conjugate roots stay finite and track float64."""
    *_, t_state, _mt, t_mt = mol_setup
    big = tmol.MoleculeTables(**{**t_mt.__dict__, "k_density": np.full_like(t_mt.k_density, 1e22)})
    f32 = tlte.PlasmaState(*[v.to(torch.float32) for v in t_state])
    for fn in (tmol.molecule_number_density, tmol.molecule_number_density_coupled):
        n32 = fn(big, f32).double().numpy()
        n64 = fn(big, t_state).numpy()
        assert np.isfinite(n32).all() and (n32 >= 0).all()
        live = n64 > 1e-30
        np.testing.assert_allclose(n32[live], n64[live], rtol=1e-4)


@pytest.mark.parametrize("coupled", [False, True], ids=["pairwise", "coupled"])
def test_molecule_line_quantities_match_jax(mol_setup, coupled):
    ad, tad, _tables, temps, state, t_state, mt, t_mt = mol_setup
    ad.linelist_molecules = pd.DataFrame(_linelist())
    tad.linelist_molecules = Table(_linelist())
    nu_min, nu_max = 2.99792458e18 / 6600.0, 2.99792458e18 / 6500.0
    mld = jmol.prepare_molecule_line_data(ad, mt, nu_min, nu_max)
    t_mld = tmol.prepare_molecule_line_data(tad, t_mt, nu_min, nu_max)
    assert t_mld.n_lines == mld.n_lines == 4  # XY unknown, the 6900 AA line outside
    for field in ("nu", "molecule_index", "gf", "e_low_erg", "e_up_erg", "A_ul", "mass"):
        np.testing.assert_allclose(getattr(t_mld, field), getattr(mld, field), rtol=1e-15,
                                   err_msg=field)
    ref = jmol.compute_molecule_line_quantities(mld, mt, state, jnp.asarray(temps), 1e5,
                                                FLAGS, coupled=coupled)
    ours = tmol.compute_molecule_line_quantities(t_mld, t_mt, t_state,
                                                 torch.from_numpy(temps), 1e5, FLAGS,
                                                 coupled=coupled)
    for name, o, r in zip(("alpha", "gamma", "doppler"), ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL, atol=1e-300,
                                   err_msg=name)


@pytest.fixture(scope="module")
def cool_star(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cool")
    model = str(tmp / "cool.mod")
    write_marcs_file(model, teff=4000.0)
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": model, "final_atomic_number": 30},
        "opacity": {
            "line": {
                "disable": False,
                "broadening": ["radiation"],
                "include_molecules": True,
                "vald_linelist": {"use_linelist": True},
            },
        },
        "no_of_thetas": 2,
        "result_options": {"return_plasma": True},
    }
    mgh = {
        "molecule": np.array(["MgH"]), "wavelength": np.array([5165.0]),
        "log_gf": np.array([0.5]), "e_low": np.array([0.0]), "e_up": np.array([2.4]),
        "j_lo": np.array([5.0]), "j_up": np.array([6.0]), "rad": np.array([7.5]),
        "stark": np.array([0.0]), "waals": np.array([0.0]),
    }
    return tmp, cfg, mgh, np.arange(5160.0, 5170.0, 0.05)


@pytest.mark.parametrize("coupled", [False, True], ids=["pairwise", "coupled"])
def test_cool_star_mgh_end_to_end_matches_jax(cool_star, coupled):
    tmp, base, mgh, lams = cool_star
    cfg = copy.deepcopy(base)
    cfg["opacity"]["line"]["molecules_coupled"] = coupled
    path = tmp / f"c_{coupled}.yml"
    path.write_text(yaml.safe_dump(cfg))
    config, adata, model = parse_config_to_model(path)
    adata.linelist_molecules = pd.DataFrame(mgh)
    nus = np.asarray(ju.Quantity(lams, ju.AA).to(ju.Hz, ju.spectral()))
    plan = build_simulation_plan(config, adata, model, nus)
    f_ref, _, opac_ref, _, state, _ = run_simulation(plan)

    atom_data = t_builtin(30, include_linelists=True, include_molecules=True)
    atom_data.linelist_molecules = Table(mgh)
    ours = stardis_tpu_torch.run_stardis(copy.deepcopy(cfg), tu.Quantity(lams, tu.AA),
                                         atom_data=atom_data)
    np.testing.assert_allclose(np.asarray(ours.spectrum_nu), np.asarray(f_ref)[-1],
                               rtol=1e-9)
    assert np.asarray(opac_ref["molecule_alpha_line_at_nu"]).max() > 0

    densities = ours.stellar_plasma.molecule_number_density
    frame = jmol.molecule_number_density_frame(plan.molecule_tables, state, coupled=coupled)
    assert densities.names == list(frame.index)
    np.testing.assert_allclose(densities.values, frame.values, rtol=RTOL, atol=1e-300)
    np.testing.assert_allclose(densities["MgH"], frame.loc["MgH"].values, rtol=RTOL)
