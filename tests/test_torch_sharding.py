"""The sharded paths (``parallel.sharding.shard_spectrum``,
``shard_batch_spectrum``, ``mesh=`` on ``run_stardis``, ``run_batch``,
``SpectralService`` and ``synthesize_grid``) on the CPU in float64, on
meshes of a repeated device (``["cpu"] * n``).

* shard_spectrum on 4 and 3 shards of a 502-point grid (neither divides
  it), F_nu and I_nu, in reference and in accuracy windows, and the
  spherical giant with file tables, molecules and molecular lines:
  against the JAX package's shard_spectrum on its virtual CPU devices
  (``make_nu_mesh(4)`` / ``(3)``) at 1e-9, against the port's unsharded run
  at 1e-12, and equal bit for bit to ``segmented_spectrum`` with as many
  segments;
* run_batch on a 4-entry 'batch' mesh and a 2 x 2 mesh against the JAX
  package's (``make_batch_mesh(4)``, ``make_batch_nu_mesh(2, 2)``) at 1e-9
  and the port's unsharded batch at 1e-12; uneven chunks;
* SpectralService(mesh=) against the JAX service on a 4-device mesh
  (``tests/test_serving.py``'s sharded test), and spherical requests with
  re-interpolated file tables, without and with molecules, against the
  unsharded service;
* synthesize_grid(mesh=), stopped and resumed;
* the raises: return_radiation_field and nu_segments with a mesh, the
  mesh constructors' sizes;
* shard_eval_stats against a direct count of in-window triples per range;
  the per-device threads.
"""

import copy
import threading

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
from stardis_tpu.io.marcs import read_marcs_model  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.parallel import batch as jbatch  # noqa: E402
from stardis_tpu.parallel import sharding as jshard  # noqa: E402
from stardis_tpu.pipeline import (  # noqa: E402
    build_simulation_plan,
    line_window_tiers,
    stage_plasma_and_lines,
)
from stardis_tpu.serving import SpectralService as JService  # noqa: E402
from stardis_tpu_torch import grid as tgrid  # noqa: E402
from stardis_tpu_torch import pipeline as tpipe  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.atom_data import build_builtin_atom_data  # noqa: E402
from stardis_tpu_torch.base import read_stellar_model  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_opacity_tables  # noqa: E402
from stardis_tpu_torch.opacities import line_kernel as tlk  # noqa: E402
from stardis_tpu_torch.opacities.lines import synth_linelist, synth_molecule_linelist  # noqa: E402
from stardis_tpu_torch.parallel import batch as tbatch  # noqa: E402
from stardis_tpu_torch.parallel import distributed as tdist  # noqa: E402
from stardis_tpu_torch.parallel import sharding as tshard  # noqa: E402
from stardis_tpu_torch.serving import SpectralService  # noqa: E402

N_LINES, N_MOL_LINES = 300, 200
LINE_RANGE = (6499.0, 6506.0)
LAMS = 6500.0 + 0.01 * np.arange(502)  # 502 points: neither 4 nor 3 divides them
CPU = {"device": "cpu", "dtype": torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(n, axes=("nu",)):
    shape = (n,) if len(axes) == 1 else n
    return tshard.Mesh(np.full(shape, "cpu", dtype=object), axes)


def _config(model, window_mode="reference"):
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
    cfg = _config(model)
    cfg["opacity"]["file"] = write_opacity_tables(tmp_path)
    cfg["opacity"]["rayleigh"] = ["H", "H2"]
    cfg["opacity"]["line"]["include_molecules"] = True
    return cfg


def _nus():
    return tu.Quantity(LAMS, tu.AA).to(tu.Hz, tu.spectral()).value


def _jax_sharded(tmp_path, cfg, ndev, molecules=None):
    """(F_nu, I_nus) of the JAX package's shard_spectrum on ``ndev`` virtual
    CPU devices, on the same config and synthetic lines."""
    path = tmp_path / "c.yml"
    path.write_text(yaml.safe_dump(cfg))
    config, adata, model = stardis_tpu.parse_config_to_model(str(path))
    jax_synth_linelist(adata, N_LINES, *LINE_RANGE)
    if molecules is not None:
        adata.linelist_molecules = pd.DataFrame(dict(molecules.columns))
    plan = build_simulation_plan(config, adata, model, _nus())
    state, lq = jax.jit(lambda t, n: stage_plasma_and_lines(plan, t, n))(
        jnp.asarray(plan.temperatures), jnp.asarray(plan.n_elem))
    window = line_window_tiers(plan, lq, state)
    mesh = jshard.make_nu_mesh(ndev)
    f_nu, i_nus = jax.jit(lambda s, q: jshard.shard_spectrum(plan, s, q, window, mesh,
                                                             chunk=None))(state, lq)
    return np.asarray(f_nu), np.asarray(i_nus)


def _port_stage1(cfg, atom_data):
    config, adata, model = stardis_tpu_torch.parse_config_to_model(copy.deepcopy(cfg),
                                                                   atom_data=atom_data)
    plan = tpipe.build_simulation_plan(config, adata, model, _nus())
    consts = tpipe.device_constants(plan, torch.float64, "cpu")
    state, lq = tpipe.stage_plasma_and_lines(plan, torch.as_tensor(plan.temperatures),
                                             torch.as_tensor(plan.n_elem), consts)
    return plan, state, lq, consts


def _check_sharded(plan, state, lq, consts, ndev, ref):
    walls = []
    f_nu, i_nus = tshard.shard_spectrum(plan, state, lq, cpu_mesh(ndev), consts,
                                        shard_walls=walls)
    assert len(walls) == ndev and all(w > 0 for w in walls)
    f_one, _, _, i_one = tpipe.stage_spectrum(plan, state, lq, consts)
    np.testing.assert_allclose(f_nu.numpy(), f_one.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(i_nus.numpy(), i_one.numpy(), rtol=1e-12, atol=0)
    f_seg, i_seg = tshard.segmented_spectrum(plan, state, lq, ndev, consts)
    np.testing.assert_array_equal(f_nu.numpy(), f_seg.numpy())
    np.testing.assert_array_equal(i_nus.numpy(), i_seg.numpy())
    f_ref, i_ref = ref
    assert f_nu.shape == f_ref.shape and i_nus.shape == i_ref.shape
    np.testing.assert_allclose(f_nu.numpy(), f_ref, rtol=1e-9, atol=1e-300)
    np.testing.assert_allclose(i_nus.numpy(), i_ref, rtol=1e-9, atol=1e-300)


@pytest.mark.parametrize("ndev, window_mode",
                         [(4, "reference"), (3, "reference"), (4, "accuracy")])
def test_shard_spectrum_matches_jax_and_unsharded(tmp_path, ndev, window_mode):
    model = str(tmp_path / "sun.mod")
    write_marcs_file(model)
    cfg = _config(model, window_mode)
    atom_data = synth_linelist(build_builtin_atom_data(30, include_linelists=True), N_LINES,
                               *LINE_RANGE)
    ours = _port_stage1(cfg, atom_data)
    _check_sharded(*ours, ndev, _jax_sharded(tmp_path, cfg, ndev))


def test_shard_spectrum_giant_with_files_and_molecules(tmp_path):
    model = str(tmp_path / "giant.mod")
    write_marcs_file(model, teff=4000.0, logg=2.0, spherical=True, radius_cm=2e12)
    cfg = _giant_config(tmp_path, model)
    atom_data = build_builtin_atom_data(30, include_linelists=True, include_molecules=True)
    synth_linelist(atom_data, N_LINES, *LINE_RANGE)
    synth_molecule_linelist(atom_data, N_MOL_LINES, *LINE_RANGE)
    plan, state, lq, consts = _port_stage1(cfg, atom_data)
    assert set(lq) == {"atomic", "molecular"} and plan.file_sources and plan.inward_rays
    _check_sharded(plan, state, lq, consts, 4,
                   _jax_sharded(tmp_path, cfg, 4, atom_data.linelist_molecules))


def test_run_stardis_mesh_equals_unsharded_and_segments(tmp_path):
    model = str(tmp_path / "sun.mod")
    write_marcs_file(model)
    cfg = _config(model)
    cfg["result_options"]["return_radiation_field"] = False
    atom_data = synth_linelist(build_builtin_atom_data(30, include_linelists=True), N_LINES,
                               *LINE_RANGE)
    lam = tu.Quantity(LAMS, tu.AA)

    def run(**kw):
        out = stardis_tpu_torch.run_stardis(copy.deepcopy(cfg), lam, atom_data=atom_data,
                                            **CPU, **kw)
        return out

    whole, seg = run(), run(nu_segments=4)
    for segments in (1, "auto"):
        sharded = run(mesh=cpu_mesh(4), nu_segments=segments)
        np.testing.assert_allclose(np.asarray(sharded.spectrum_nu), np.asarray(whole.spectrum_nu),
                                   rtol=1e-12, atol=0)
        np.testing.assert_array_equal(np.asarray(sharded.spectrum_nu),
                                      np.asarray(seg.spectrum_nu))
    f_nu, total, opac, i_nus, _ = tpipe.run_simulation(
        tpipe.build_simulation_plan(*stardis_tpu_torch.parse_config_to_model(
            copy.deepcopy(cfg), atom_data=atom_data), _nus()), mesh=cpu_mesh(3), **CPU)
    assert f_nu.shape == (56, len(LAMS)) and total is None and opac == {} and i_nus is None


# --- batches ------------------------------------------------------------------

def _batch_members(base, teffs):
    paths = []
    for i, teff in enumerate(teffs):
        paths.append(str(base / f"m{i}.mod"))
        write_marcs_file(paths[-1], teff=teff)
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:5",
        "input_model": {"type": "marcs", "fname": paths[0], "final_atomic_number": 5},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}},
                    "line": {"disable": False, "broadening": ["radiation", "linear_stark"]}},
        "no_of_thetas": 3,
        "result_options": {},
    }
    nus = np.asarray(ju.Quantity(np.arange(6555.0, 6575.0, 0.2), ju.AA)
                     .to(ju.Hz, ju.spectral()))
    return cfg, paths, nus


def _port_batch(cfg, paths, nus):
    config, adata, model0 = stardis_tpu_torch.parse_config_to_model(cfg)
    models = [model0] + [read_stellar_model(config, adata, p) for p in paths[1:]]
    return tbatch.make_batch(config, adata, models, nus)


@pytest.mark.parametrize("shape", [(4,), (2, 2)])
def test_run_batch_mesh_matches_jax_and_unsharded(tmp_path, shape):
    cfg, paths, nus = _batch_members(tmp_path, [4800.0, 5400.0, 5777.0, 6400.0])
    path = tmp_path / "c.yml"
    path.write_text(yaml.safe_dump(cfg))
    config, adata, model0 = stardis_tpu.parse_config_to_model(path)
    models = [model0] + [read_marcs_model(p).to_stellar_model(adata, final_atomic_number=5)
                         for p in paths[1:]]
    jplan, jb = jbatch.make_batch(config, adata, models, nus)
    if len(shape) == 1:
        jmesh, mesh = jbatch.make_batch_mesh(4), tbatch.make_batch_mesh(devices=["cpu"] * 4)
    else:
        jmesh, mesh = (jshard.make_batch_nu_mesh(2, 2),
                       tshard.make_batch_nu_mesh(2, 2, devices=["cpu"] * 4))
    ref = np.asarray(jbatch.run_batch(jplan, jb, mesh=jmesh))

    plan, batch = _port_batch(cfg, paths, nus)
    whole = tbatch.run_batch(plan, batch, **CPU)
    sharded = tbatch.run_batch(plan, batch, mesh=mesh, **CPU)
    assert sharded.shape == whole.shape == ref.shape
    np.testing.assert_allclose(sharded.numpy(), whole.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(sharded.numpy(), ref, rtol=1e-9, atol=1e-300)


@pytest.mark.parametrize("shape", [(4,), (2, 2), (3, 2)])
def test_run_batch_uneven_chunks_equal_unsharded(tmp_path, shape):
    """Five models over 4 rows (chunks 2, 2, 1), 2 rows (3, 2) and 3 rows x
    2 columns: every member as in the unsharded batch (1e-12: the CPU's
    vectorised loops may round a tensor of another shape otherwise), and
    shard_batch_spectrum on the same stage 1 equal to run_batch(mesh=) bit
    for bit."""
    cfg, paths, nus = _batch_members(tmp_path, [4800.0, 5400.0, 5777.0, 6400.0, 7000.0])
    plan, batch = _port_batch(cfg, paths, nus)
    axes = ("batch",) if len(shape) == 1 else ("batch", "nu")
    mesh = cpu_mesh(shape[0] if len(shape) == 1 else shape, axes)
    whole = tbatch.run_batch(plan, batch, **CPU)
    timings = {}
    sharded = tbatch.run_batch(plan, batch, mesh=mesh, timings=timings, **CPU)
    np.testing.assert_allclose(sharded.numpy(), whole.numpy(), rtol=1e-12, atol=0)
    assert {"plasma_and_lines", "line_opacity", "formal_solution"} <= set(timings)

    consts = tpipe.device_constants(plan, torch.float64, "cpu")
    states, quants = tbatch._stage1(plan, batch, 0, 5, consts, torch.float64)
    walls = []
    f_nu = tshard.shard_batch_spectrum(plan, states, quants, mesh, consts,
                                       ray_distances=batch.ray_distances, shard_walls=walls)
    np.testing.assert_array_equal(f_nu.numpy(), sharded.numpy())
    assert len(walls) == len(tshard._tiles(tshard.as_batch_nu(mesh), 5, len(nus)))


# --- serving --------------------------------------------------------------------

def _sun_setup(base):
    config = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": "", "final_atomic_number": 30},
        "opacity": {
            "bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
            "line": {
                "disable": False,
                "broadening": ["radiation", "van_der_waals"],
                "vald_linelist": {"use_linelist": True, "use_vald_broadening": True},
            },
        },
        "no_of_thetas": 5,
        "result_options": {"return_radiation_field": True},
    }
    paths = {}
    for name, teff in (("sun", 5777.0), ("warm", 6300.0)):
        paths[name] = str(base / f"{name}.mod")
        write_marcs_file(paths[name], teff=teff)
    config["input_model"]["fname"] = paths["sun"]
    cfg_path = base / "c.yml"
    cfg_path.write_text(yaml.safe_dump(config))
    return paths, config, str(cfg_path), np.arange(5885.0, 5900.0, 0.1)


def test_service_mesh_matches_jax_service(tmp_path):
    paths, cfg, cfg_path, lams = _sun_setup(tmp_path)
    jsvc = JService(cfg_path, ju.Quantity(lams, ju.AA), dtype=np.float64,
                    mesh=jshard.make_nu_mesh(4))
    tsvc = SpectralService(cfg, tu.Quantity(lams, tu.AA), mesh=cpu_mesh(4),
                           nu_segments="auto", **CPU)
    one = SpectralService(cfg, tu.Quantity(lams, tu.AA), **CPU)
    for name in ("sun", "warm"):
        jmodel = stardis_tpu.parse_config_to_model(
            cfg_path, add_config_dict={"input_model.fname": paths[name]})[2]
        ref = jsvc.synthesize(jmodel)
        model = read_stellar_model(tsvc.config, tsvc.atom_data, paths[name])
        ours, plain = tsvc.synthesize(model), one.synthesize(model)
        for key in ("F_nu", "spectrum_nu", "spectrum_lambda", "I_nus"):
            np.testing.assert_allclose(ours[key], ref[key], rtol=1e-9, atol=1e-300, err_msg=key)
            np.testing.assert_allclose(ours[key], plain[key], rtol=1e-12, atol=0, err_msg=key)
    assert tsvc.stats.requests == 2 and tsvc.stats.compiles == 1


def _service_mesh_spherical(tmp_path, molecules):
    """A sharded and an unsharded service of the spherical giant with file
    tables (and molecules with molecular lines when ``molecules``), serving
    the plan's model and a hotter, larger one."""
    giant, other = str(tmp_path / "giant.mod"), str(tmp_path / "other.mod")
    write_marcs_file(giant, teff=4000.0, logg=2.0, spherical=True, radius_cm=2e12)
    write_marcs_file(other, teff=4200.0, logg=2.0, spherical=True, radius_cm=3e12)
    cfg = _giant_config(tmp_path, giant)
    cfg["opacity"]["line"]["include_molecules"] = molecules
    cfg["result_options"]["return_radiation_field"] = False
    atom_data = synth_linelist(build_builtin_atom_data(30, include_linelists=True,
                                                       include_molecules=molecules),
                               N_LINES, *LINE_RANGE)
    if molecules:
        synth_molecule_linelist(atom_data, N_MOL_LINES, *LINE_RANGE)
    lam = tu.Quantity(LAMS, tu.AA)
    sharded = SpectralService(copy.deepcopy(cfg), lam, mesh=cpu_mesh(3), atom_data=atom_data,
                              **CPU)
    one = SpectralService(copy.deepcopy(cfg), lam, atom_data=atom_data, **CPU)
    for path in (giant, other):
        model = read_stellar_model(one.config, one.atom_data, path)
        ours, ref = sharded.synthesize(model), one.synthesize(model)
        np.testing.assert_allclose(ours["F_nu"], ref["F_nu"], rtol=1e-12, atol=0)
    assert sharded.stats.sigma_reinterp_events == one.stats.sigma_reinterp_events == 1
    return cfg, atom_data, other, ours


def test_service_mesh_spherical_requests_with_file_tables(tmp_path):
    """Requests that differ from the plan's model: their own chords, their
    own correction and re-interpolated sigma tables, through the shards."""
    _service_mesh_spherical(tmp_path, molecules=False)


def test_service_mesh_spherical_requests_with_molecules(tmp_path):
    """The same with molecules and molecular lines: the other request's own
    molecular rows, through the shards; it equals the port's run_stardis of
    that model at 1e-12."""
    cfg, atom_data, other, ours = _service_mesh_spherical(tmp_path, molecules=True)
    cfg["input_model"]["fname"] = other
    single = stardis_tpu_torch.run_stardis(cfg, tu.Quantity(LAMS, tu.AA), atom_data=atom_data,
                                           **CPU)
    np.testing.assert_allclose(ours["spectrum_nu"], np.asarray(single.spectrum_nu.value),
                               rtol=1e-12, atol=0)


# --- grid scans -------------------------------------------------------------------

def test_grid_scan_on_a_mesh_and_resumed(tmp_path):
    cfg, paths, nus = _batch_members(tmp_path, [4800.0, 5200.0, 5777.0, 6400.0, 7000.0])
    config, adata, model0 = stardis_tpu_torch.parse_config_to_model(cfg)
    models = [model0] + [read_stellar_model(config, adata, p) for p in paths[1:]]
    labels = [{"i": i} for i in range(5)]
    plain = tgrid.synthesize_grid(config, adata, models, nus, tmp_path / "plain",
                                  batch_size=2, labels=labels, **CPU)
    mesh = cpu_mesh(2, ("batch",))
    first = tgrid.synthesize_grid(config, adata, models, nus, tmp_path / "mesh", mesh=mesh,
                                  labels=labels, max_chunks=1, **CPU)
    assert first["computed"] == 1 and not first["done"]
    rest = tgrid.synthesize_grid(config, adata, models, nus, tmp_path / "mesh", mesh=mesh,
                                 labels=labels, **CPU)
    assert rest["done"] and rest["skipped"] == 1 and rest["computed"] == plain["total"] - 1
    fresh = tgrid.synthesize_grid(config, adata, models, nus, tmp_path / "fresh", mesh=mesh,
                                  labels=labels, **CPU)
    assert fresh["computed"] == plain["total"]
    resumed = tgrid.load_grid(tmp_path / "mesh")[0]
    np.testing.assert_array_equal(resumed, tgrid.load_grid(tmp_path / "fresh")[0])
    np.testing.assert_allclose(resumed, tgrid.load_grid(tmp_path / "plain")[0], rtol=1e-12,
                               atol=0)
    grid2 = tgrid.synthesize_grid(config, adata, models, nus, tmp_path / "grid2", batch_size=4,
                                  mesh=cpu_mesh((2, 2), ("batch", "nu")), **CPU)
    assert grid2["done"] and grid2["total"] == 2
    np.testing.assert_allclose(tgrid.load_grid(tmp_path / "grid2")[0], resumed, rtol=1e-12,
                               atol=0)
    with pytest.raises(ValueError, match="multiple of the mesh batch axis"):
        tgrid.synthesize_grid(config, adata, models, nus, tmp_path / "bad", batch_size=3,
                              mesh=mesh, **CPU)


# --- raises -----------------------------------------------------------------------

def test_mesh_options_raise(tmp_path, monkeypatch):
    model = str(tmp_path / "sun.mod")
    write_marcs_file(model)
    cfg = _config(model)
    lam = tu.Quantity(LAMS[:50], tu.AA)

    def no_plan(*args, **kw):
        raise AssertionError("the plan was built")

    with monkeypatch.context() as m:
        # refused before the plan is built
        m.setattr(stardis_tpu_torch.base, "build_simulation_plan", no_plan)
        with pytest.raises(ValueError, match="return_radiation_field"):
            stardis_tpu_torch.run_stardis(copy.deepcopy(cfg), lam, mesh=cpu_mesh(2), **CPU)
    cfg["result_options"]["return_radiation_field"] = False
    with pytest.raises(ValueError, match="mutually exclusive"):
        stardis_tpu_torch.run_stardis(copy.deepcopy(cfg), lam, mesh=cpu_mesh(2), nu_segments=2,
                                      **CPU)
    with pytest.raises(ValueError, match="'nu'"):
        stardis_tpu_torch.run_stardis(copy.deepcopy(cfg), lam,
                                      mesh=cpu_mesh(2, ("batch",)), **CPU)
    with pytest.raises(ValueError, match="do not make a 2 x 3 mesh"):
        tshard.make_batch_nu_mesh(2, 3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="not divisible"):
        tdist.make_batch_nu_mesh(n_batch=3, devices=["cpu"] * 4)
    mesh = tdist.make_batch_nu_mesh(n_batch=2, devices=["cpu"] * 4)
    assert mesh.axis_names == ("batch", "nu") and mesh.shape == {"batch": 2, "nu": 2}
    assert tdist.make_batch_nu_mesh(devices=["cpu"] * 4).shape == {"batch": 1, "nu": 4}
    glob = tdist.make_global_mesh(devices=["cpu"] * 3)
    assert glob.shape == {"nu": 3} and all(glob.held(i) for i in range(3))
    with pytest.raises(ValueError, match="axes"):
        tshard.Mesh(["cpu"] * 4, ("batch", "nu"))
    assert tbatch.make_batch_mesh(devices=["cpu"] * 3).shape == {"batch": 3}
    if not torch.cuda.is_available():
        for make in (tshard.make_nu_mesh, tbatch.make_batch_mesh):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


# --- the meter and the threads ----------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_shard_eval_stats_counts_in_window_triples(ndev):
    rng = np.random.default_rng(ndev)
    n_models, n_lines, n_depth, n_nu = 2, 40, 5, 300
    centers = np.sort(rng.integers(-30, n_nu + 30, n_lines))[::-1].copy()
    iw = rng.integers(0, 120, (n_models, n_lines, n_depth))
    ones = torch.ones((n_models, n_lines, n_depth), dtype=torch.float64)
    prepared = tlk.prepare_line_opacity(
        torch.linspace(1.0, -1.0, n_nu, dtype=torch.float64), torch.zeros(n_lines,
                                                                           dtype=torch.float64),
        torch.as_tensor(centers), ones, ones, ones, torch.as_tensor(iw, dtype=torch.int32))
    stats = tshard.shard_eval_stats([("alpha_line_at_nu", prepared, None, None)], n_nu, ndev)
    per = [0] * ndev
    for s, (a, b) in enumerate(tshard.segment_ranges(n_nu, ndev)):
        for m in range(n_models):
            for li in range(n_lines):
                for d in range(n_depth):
                    p = np.arange(a, b)
                    per[s] += int(((p - centers[li] >= -iw[m, li, d])
                                   & (p - centers[li] < iw[m, li, d])).sum())
    assert stats["per_shard_evals"] == per
    assert stats["unsharded_evals"] == sum(per) and stats["ndev"] == ndev
    assert stats["efficiency"] == pytest.approx(sum(per) / (ndev * max(per)), rel=1e-15)


def test_distinct_devices_run_on_threads_of_their_own():
    """Each distinct device's work runs on a thread of its own, at the same
    time as the others' (a barrier that every worker must reach), under the
    caller's grad mode; one device runs on the calling thread; the first
    failure is raised.  With more workers than cores and a short switch
    interval, every worker's disjoint slice of one shared tensor is written
    and every result returned."""
    import os
    import sys

    n_workers = (os.cpu_count() or 1) + 4
    devices = [torch.device("meta", i) for i in range(n_workers)]
    barrier = threading.Barrier(n_workers, timeout=60)
    shared = torch.zeros(n_workers, 1000, dtype=torch.int64)
    grad_modes = {}

    def work(i, fail=False):
        def fn():
            barrier.wait()
            grad_modes[i] = torch.is_grad_enabled()
            for k in range(1000):
                shared[i, k] += i + 1
            if fail:
                raise RuntimeError(f"worker {i} failed")
            return i
        return fn

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.no_grad():
            out = tshard._per_device({d: work(i) for i, d in enumerate(devices)})
    finally:
        sys.setswitchinterval(interval)
    assert out == {d: i for i, d in enumerate(devices)}
    assert grad_modes == {i: False for i in range(n_workers)}
    assert torch.equal(shared, torch.arange(1, n_workers + 1)[:, None].expand(-1, 1000))

    idents = []
    one = tshard._per_device({devices[0]: lambda: idents.append(threading.get_ident()) or 7})
    assert one == {devices[0]: 7} and idents == [threading.get_ident()]
    barrier = threading.Barrier(2, timeout=60)
    with pytest.raises(RuntimeError, match="worker 1 failed"):
        tshard._per_device({devices[0]: work(0), devices[1]: work(1, fail=True)})


def test_each_kernel_builds_once_when_threads_race(monkeypatch):
    """The host threads of a mesh over several cards reach a kernel's
    first launch together: each kernel is built once, different kernels
    at the same time."""
    import sys
    import time

    from stardis_tpu_torch import _cuda

    built = []

    def build(name):
        built.append(name)
        time.sleep(0.05)
        return name

    monkeypatch.setattr(_cuda, "_LIBS", {})
    monkeypatch.setattr(_cuda, "_build_and_load", build)
    names = list(_cuda.KERNELS) * 8
    results = [None] * len(names)

    def load(i):
        results[i] = _cuda.load(names[i])

    threads = [threading.Thread(target=load, args=(i,)) for i in range(len(names))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(built) == sorted(_cuda.KERNELS) and results == names


def test_stage1_in_racing_threads_equals_serial(tmp_path):
    """The per-card threads of a mesh run stage 1 at the same time (run_batch
    on a mesh): its Newton step's torch.func.jvp keeps its own level, so
    every thread's state equals the serial one bit for bit."""
    import sys

    model = str(tmp_path / "sun.mod")
    write_marcs_file(model)
    cfg = _config(model)
    atom_data = synth_linelist(build_builtin_atom_data(30, include_linelists=True), N_LINES,
                               *LINE_RANGE)
    plan, state, lq, consts = _port_stage1(cfg, atom_data)
    temps, n_elem = torch.as_tensor(plan.temperatures), torch.as_tensor(plan.n_elem)

    def work():
        for _ in range(3):
            got, got_lq = tpipe.stage_plasma_and_lines(plan, temps, n_elem, consts)
            assert all(torch.equal(a, b) for a, b in zip(got, state))
            assert all(torch.equal(a, b) for a, b in zip(got_lq["atomic"], lq["atomic"]))
        return True

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = tshard._per_device({torch.device("meta", i): work for i in range(6)})
    finally:
        sys.setswitchinterval(interval)
    assert all(out.values()) and len(out) == 6


def test_launch_counts_add_up_across_threads():
    """Every launch counts once when the threads of a mesh launch at once."""
    import sys

    from stardis_tpu_torch import _cuda

    def wrapper():
        pass

    wrapper.launches = 0

    def work():
        for _ in range(2000):
            _cuda.count(wrapper, "launches")

    threads = [threading.Thread(target=work) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and wrapper.launches == 8 * 2000
