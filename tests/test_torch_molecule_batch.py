"""Molecules on the batched, served, scanned and sharded-batch paths, float64
on the CPU, against the JAX package's single-model runs.

The JAX batch and service give every member the template model's molecular
K(T) and U(T) tables; the port evaluates each member's and each request's
tables at its own temperatures (``MoleculeTables.rows_at``).  Each member
is therefore held to the JAX package's ``build_simulation_plan`` +
``run_simulation`` of that model alone:

* the rows against JAX's ``build_molecule_tables`` at each member's
  temperatures (1e-13), and bit for bit the port's single build;
* ``run_batch`` members at 1e-9, pairwise and coupled, cool dwarfs
  (plane-parallel) and cool giants (spherical, three file tables);
* the batched stage 1 bit for bit each member's single stage 1;
* served requests at other temperatures and ``synthesize_batch`` at 1e-9;
* a molecule grid scan resumed equal to a fresh one, ``run_batch`` on a
  2 x 2 CPU mesh against the unsharded batch at 1e-12.

A member's gradient against ``jax.grad``: ``tests/test_torch_molecule_grad.py``.
"""

import copy
import dataclasses

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import torch  # noqa: E402

import stardis_tpu  # noqa: E402
import stardis_tpu_torch  # noqa: E402
from bench_lines import synth_linelist as jax_synth_linelist  # noqa: E402
from stardis_tpu import units as ju  # noqa: E402
from stardis_tpu.io.marcs import read_marcs_model  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.parallel import batch as jbatch  # noqa: E402
from stardis_tpu.pipeline import (  # noqa: E402
    build_simulation_plan,
    run_simulation,
)
from stardis_tpu.plasma import molecules as jmol  # noqa: E402
from stardis_tpu_torch import grid as tgrid  # noqa: E402
from stardis_tpu_torch import pipeline as tpipe  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.atom_data import build_builtin_atom_data  # noqa: E402
from stardis_tpu_torch.base import parse_config_to_model as t_parse  # noqa: E402
from stardis_tpu_torch.base import read_stellar_model  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_opacity_tables  # noqa: E402
from stardis_tpu_torch.opacities.lines import synth_linelist, synth_molecule_linelist  # noqa: E402
from stardis_tpu_torch.parallel import batch as tbatch  # noqa: E402
from stardis_tpu_torch.parallel import sharding as tshard  # noqa: E402
from stardis_tpu_torch.plasma import molecules as tmol  # noqa: E402
from stardis_tpu_torch.serving import SpectralService  # noqa: E402

N_LINES, N_MOL_LINES = 150, 120
LINE_RANGE = (6499.0, 6506.0)
LAMS = np.arange(6500.0, 6505.0, 0.05)
CPU = {"device": "cpu", "dtype": torch.float64}
#: three cool members each: the template first
MEMBERS = {
    "dwarfs": [{"teff": t, "logg": 4.5} for t in (3600.0, 4000.0, 4500.0)],
    "giants": [{"teff": t, "logg": 2.0, "spherical": True, "radius_cm": r}
               for t, r in ((3600.0, 1.5e12), (4000.0, 2.5e12), (4400.0, 3.5e12))],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times.
    One thread also keeps a model's bits the same in any batch."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(base, paths, kind, coupled):
    line = {
        "disable": False,
        "broadening": ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"],
        "vald_linelist": {"use_linelist": True, "use_vald_broadening": True},
        "include_molecules": True,
        "molecules_coupled": coupled,
    }
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": paths[0], "final_atomic_number": 30},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H", "H2"],
                    "line": line},
        "no_of_thetas": 3,
        "result_options": {},
    }
    if kind == "giants":
        cfg["opacity"]["file"] = write_opacity_tables(base)
    return cfg


@dataclasses.dataclass
class Setup:
    cfg: dict
    paths: list
    nus: np.ndarray
    config: object  # the port's
    adata: object
    models: list
    plan: object  # the port's template plan and batch
    batch: object
    jconfig: object  # the JAX package's config, atom data, models and per-member plans
    jadata: object
    jmodels: list
    jplans: list
    jf: list  # JAX run_simulation F_nu of each member


def _setup(base, kind, coupled, jax_runs=True):
    paths = []
    for i, kw in enumerate(MEMBERS[kind]):
        paths.append(str(base / f"m{i}.mod"))
        write_marcs_file(paths[-1], **kw)
    cfg = _config(base, paths, kind, coupled)
    nus = tu.Quantity(LAMS, tu.AA).to(tu.Hz, tu.spectral()).value

    atom_data = build_builtin_atom_data(30, include_linelists=True, include_molecules=True)
    synth_linelist(atom_data, N_LINES, *LINE_RANGE)
    synth_molecule_linelist(atom_data, N_MOL_LINES, *LINE_RANGE)
    config, adata, model0 = t_parse(copy.deepcopy(cfg), atom_data=atom_data)
    models = [model0] + [read_stellar_model(config, adata, p) for p in paths[1:]]
    plan, batch = tbatch.make_batch(config, adata, models, nus)

    path = base / "c.yml"
    path.write_text(yaml.safe_dump(cfg))
    jconfig, jadata, jmodel0 = stardis_tpu.parse_config_to_model(str(path))
    jax_synth_linelist(jadata, N_LINES, *LINE_RANGE)
    jadata.linelist_molecules = pd.DataFrame(dict(atom_data.linelist_molecules.columns))
    jmodels = [jmodel0] + [
        read_marcs_model(p).to_stellar_model(jadata, final_atomic_number=30)
        for p in paths[1:]
    ]
    jnus = np.asarray(ju.Quantity(LAMS, ju.AA).to(ju.Hz, ju.spectral()))
    jplans = [build_simulation_plan(jconfig, jadata, m, jnus) for m in jmodels]
    assert jplans[0].molecule_line_data.n_lines > 50
    jf = [np.asarray(run_simulation(p)[0]) for p in jplans] if jax_runs else None
    return Setup(cfg, paths, nus, config, adata, models, plan, batch, jconfig, jadata,
                 jmodels, jplans, jf)


@pytest.fixture(scope="module", params=[
    ("dwarfs", False), ("dwarfs", True), ("giants", False), ("giants", True),
], ids=["dwarfs_pairwise", "dwarfs_coupled", "giants_pairwise", "giants_coupled"])
def setup(request, tmp_path_factory):
    return _setup(tmp_path_factory.mktemp("_".join(map(str, request.param))), *request.param)


# --- (a) the rows -----------------------------------------------------------------

def test_rows_match_jax_tables_and_the_single_build(setup):
    """Each member's K(T) and U(T) rows: JAX's build_molecule_tables at its
    temperatures within 1e-13, the port's own build bit for bit; the
    plan's samples evaluated at its own temperatures give its tables; a
    plan carried over from JAX with its atom data evaluates the same rows."""
    s = setup
    rows = s.batch.molecule_rows
    n_models, n_depth = s.batch.temperatures.shape
    m = s.plan.molecule_tables.n_molecules
    assert rows.k_density.shape == rows.partition_function.shape == (n_models, m, n_depth)
    for b, (jplan, model) in enumerate(zip(s.jplans, s.models)):
        temps = s.batch.temperatures[b]
        ref = jmol.build_molecule_tables(s.jadata, jplan.tables, temps)
        assert ref.names == s.plan.molecule_tables.names
        np.testing.assert_allclose(rows.k_density[b], ref.k_density, rtol=1e-13, atol=0)
        np.testing.assert_allclose(rows.partition_function[b], ref.partition_function,
                                   rtol=1e-13, atol=0)
        single = tpipe.build_simulation_plan(s.config, s.adata, model, s.nus).molecule_tables
        np.testing.assert_array_equal(rows.k_density[b], single.k_density)
        np.testing.assert_array_equal(rows.partition_function[b], single.partition_function)
    own = s.plan.molecule_tables.rows_at(s.plan.temperatures)
    np.testing.assert_array_equal(own.k_density, s.plan.molecule_tables.k_density)
    np.testing.assert_array_equal(own.partition_function,
                                  s.plan.molecule_tables.partition_function)
    carried = tpipe.plan_from_reference(s.jplans[0], s.jadata).molecule_tables
    theirs = carried.rows_at(s.batch.temperatures)
    np.testing.assert_allclose(theirs.k_density, rows.k_density, rtol=1e-13, atol=0)
    np.testing.assert_allclose(theirs.partition_function, rows.partition_function,
                               rtol=1e-13, atol=0)
    with pytest.raises(ValueError, match="samples"):
        tpipe.plan_from_reference(s.jplans[0]).molecule_tables.rows_at(s.plan.temperatures)


def test_rows_interpolate_as_np_interp_and_the_spline():
    """The vectorised U(T) interpolation equals one np.interp per molecule
    bit for bit, at, between and beyond the samples; K(T) equals one
    CubicSpline per molecule within 1e-14."""
    from scipy.interpolate import CubicSpline

    md = build_builtin_atom_data(12, include_molecules=True).molecule_data
    samples = tmol.MoleculeSamples.from_samples(
        md.equilibrium_temperatures, md.log_equilibrium_constants,
        md.partition_temperatures, md.partition_functions)
    rng = np.random.default_rng(3)
    temps = np.concatenate([rng.uniform(500.0, 15000.0, 201), md.partition_temperatures,
                            [md.partition_temperatures[0] - 1.0,
                             md.partition_temperatures[-1] + 1.0]])
    rows = samples.rows(temps.reshape(2, -1))
    for m in range(len(md.names)):
        u = np.interp(temps, md.partition_temperatures, md.partition_functions[m])
        np.testing.assert_array_equal(rows.partition_function[:, m].reshape(-1), u)
        log_kp = CubicSpline(md.equilibrium_temperatures, md.log_equilibrium_constants[m],
                             extrapolate=True)(temps)
        k = 10.0 ** log_kp * tmol.PA_TO_CGS / (tmol.K_B_CGS * temps)
        np.testing.assert_allclose(rows.k_density[:, m].reshape(-1), k, rtol=1e-14)


# --- (b) run_batch ----------------------------------------------------------------

def test_run_batch_members_match_jax_single_runs(setup):
    """Member b of run_batch equals the JAX package's run_simulation of
    model b alone at 1e-9, from the port's host phase and from the JAX
    plan and batch carried over (the plan with its atom data, the rows from
    the members' temperatures); a batch without its rows raises."""
    s = setup
    f = tbatch.run_batch(s.plan, s.batch, **CPU).numpy()
    jplan, jb = jbatch.make_batch(s.jconfig, s.jadata, s.jmodels, s.jplans[0].tracing_nus)
    tplan = tpipe.plan_from_reference(jplan, s.jadata)
    with pytest.raises(ValueError, match="molecule_rows"):
        tbatch.run_batch(tplan, tbatch.batch_from_reference(jb), **CPU)
    carried = tbatch.run_batch(tplan, tbatch.batch_from_reference(jb, tplan), **CPU).numpy()
    for b, ref in enumerate(s.jf):
        np.testing.assert_allclose(f[b], ref, rtol=1e-9, atol=1e-300, err_msg=f"member {b}")
        np.testing.assert_allclose(carried[b], ref, rtol=1e-9, atol=1e-300,
                                   err_msg=f"carried member {b}")
    assert np.abs(s.jf[1][-1] / s.jf[0][-1] - 1.0).max() > 1e-3  # distinct members


# --- (c) stage 1 --------------------------------------------------------------------

def _fields(state, quants):
    out = [(f"state.{k}", v) for k, v in state._asdict().items()]
    for key, triple in quants.items():
        out += [(f"{key}.{n}", x) for n, x in zip(("alpha", "gamma", "doppler"), triple)]
    return out


def test_batched_stage1_equals_single_stage1(setup):
    """The batched stage 1 on the members' rows equals each member's single
    stage 1 (its own plan's tables, read from its DeviceConstants) bit for
    bit; without the rows a batch of B > 1 raises."""
    s = setup
    consts = tpipe.device_constants(s.plan, torch.float64, "cpu")
    temps, n_elem = torch.from_numpy(s.batch.temperatures), torch.from_numpy(s.batch.n_elem)
    rows = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in s.batch.molecule_rows)
    state, quants = tpipe.stage_plasma_and_lines(s.plan, temps, n_elem, consts, rows)
    assert set(quants) == {"atomic", "molecular"}
    with pytest.raises(ValueError, match="molecule_rows"):
        tpipe.stage_plasma_and_lines(s.plan, temps, n_elem, consts)
    for b, model in enumerate(s.models):
        single = tpipe.build_simulation_plan(s.config, s.adata, model, s.nus)
        c1 = tpipe.device_constants(single, torch.float64, "cpu")
        ref = tpipe.stage_plasma_and_lines(single, torch.from_numpy(single.temperatures),
                                           torch.from_numpy(single.n_elem), c1)
        member = (type(state)(*(x[b] for x in state)),
                  {k: tuple(x[b] for x in t) for k, t in quants.items()})
        for (name, o), (_, r) in zip(_fields(*member), _fields(*ref)):
            assert torch.equal(o, r), f"member {b}: {name}"


# --- (d) serving --------------------------------------------------------------------

def test_served_requests_match_jax_single_runs(setup):
    """A service built on the template serves every member (at its own
    temperatures) equal to the JAX run_simulation of that model at 1e-9 and
    to the port's run_stardis at 1e-12; synthesize_batch equals the JAX runs
    at 1e-9 and run_batch bit for bit."""
    s = setup
    lam = tu.Quantity(LAMS, tu.AA)
    svc = SpectralService(copy.deepcopy(s.cfg), lam, atom_data=s.adata, **CPU)
    for b, (model, path) in enumerate(zip(s.models, s.paths)):
        ours = svc.synthesize(model)
        np.testing.assert_allclose(ours["F_nu"], s.jf[b], rtol=1e-9, atol=1e-300,
                                   err_msg=f"{b}")
        cfg = copy.deepcopy(s.cfg)
        cfg["input_model"]["fname"] = path
        single = stardis_tpu_torch.run_stardis(cfg, lam, atom_data=s.adata, **CPU)
        np.testing.assert_allclose(ours["spectrum_nu"], np.asarray(single.spectrum_nu.value),
                                   rtol=1e-12, atol=0, err_msg=f"{b}")
    assert svc.stats.requests == 3 and svc.stats.compiles == 1
    batch = svc.synthesize_batch(s.models)
    for b, ref in enumerate(s.jf):
        np.testing.assert_allclose(batch[b], ref, rtol=1e-9, atol=1e-300, err_msg=f"{b}")
    np.testing.assert_array_equal(batch, tbatch.run_batch(s.plan, s.batch, **CPU).numpy())


# --- (e) scans and meshes -----------------------------------------------------------

def test_grid_scan_resumed_and_batch_on_a_mesh(setup, tmp_path):
    """A molecule grid scan stopped after one chunk and resumed equals a
    fresh scan bit for bit and the JAX single runs at 1e-9 (its second
    chunk's template is another model); run_batch on a 2 x 2 CPU mesh and
    on a 'batch' mesh of 2 equals the unsharded batch at 1e-12."""
    s = setup
    kw = dict(batch_size=2, labels=[{"i": i} for i in range(3)], **CPU)
    first = tgrid.synthesize_grid(s.config, s.adata, s.models, s.nus, tmp_path / "scan",
                                  max_chunks=1, **kw)
    assert first["computed"] == 1 and not first["done"]
    rest = tgrid.synthesize_grid(s.config, s.adata, s.models, s.nus, tmp_path / "scan", **kw)
    assert rest["done"] and rest["skipped"] == 1
    fresh = tgrid.synthesize_grid(s.config, s.adata, s.models, s.nus, tmp_path / "fresh", **kw)
    assert fresh["computed"] == 2
    resumed = tgrid.load_grid(tmp_path / "scan")[0]
    np.testing.assert_array_equal(resumed, tgrid.load_grid(tmp_path / "fresh")[0])
    for b, ref in enumerate(s.jf):
        np.testing.assert_allclose(resumed[b], ref[-1], rtol=1e-9, atol=1e-300)

    whole = tbatch.run_batch(s.plan, s.batch, **CPU).numpy()
    for devices, axes in ((np.full((2, 2), "cpu", dtype=object), ("batch", "nu")),
                          (["cpu"] * 2, ("batch",))):
        mesh = tshard.Mesh(devices, axes)
        f = tbatch.run_batch(s.plan, s.batch, mesh=mesh, **CPU).numpy()
        np.testing.assert_allclose(f, whole, rtol=1e-12, atol=0, err_msg=str(axes))
