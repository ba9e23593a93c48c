"""Batched synthesis: the port's run_batch against the JAX package's, float64.

* plane-parallel members (BASELINE config 5 cut to 3 models) and
  spherical giants with file opacities (per-model corrections and
  cross-sections): port == JAX run_batch at 1e-9, from the JAX plan and
  batch carried over and from the port's own host phase;
* each member against the port's single-model run of that model at 1e-12
  (the batch is the same code path with B > 1);
* the port's own batch carries each file table's rows (``FileSigmaRows``:
  a bracket, a weight and a factor per depth), which the device expands:
  expanded on the host they equal the JAX batch's dense cross-sections at
  1e-12; ``run_batch`` on them equals ``run_batch`` on the dense arrays, in
  the reference and the accuracy window modes, unsharded and on a 2 x 2
  mesh (rows cut by model chunk and pixel range), at 1e-12, and the
  counters say which path ran;
* mixed geometry is rejected, and so is a mesh that is not a
  ``parallel.sharding.Mesh`` (meshes: ``tests/test_torch_sharding.py``);
* molecules: the JAX run_batch evaluates every member's molecular
  densities with the template model's K(T) / U(T) tables.  The test shows
  that discrepancy (member 1 against the JAX single run of that model) and
  holds the port's batch, whose members carry their own tables, to the
  JAX single runs (more in ``tests/test_torch_molecule_batch.py``).
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import torch  # noqa: E402

from stardis_tpu import parse_config_to_model, units as ju  # noqa: E402
from stardis_tpu.io.marcs import read_marcs_model  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.parallel import batch as jbatch  # noqa: E402
from stardis_tpu.pipeline import build_simulation_plan, run_simulation  # noqa: E402
from stardis_tpu_torch import pipeline as tpipe  # noqa: E402
from stardis_tpu_torch.base import parse_config_to_model as t_parse  # noqa: E402
from stardis_tpu_torch.base import read_stellar_model as t_read_model  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_opacity_tables  # noqa: E402
from stardis_tpu_torch.opacities.file_tables import FileSigmaRows  # noqa: E402
from stardis_tpu_torch.parallel import batch as tbatch  # noqa: E402
from stardis_tpu_torch.parallel.sharding import Mesh  # noqa: E402
from stardis_tpu_torch.util import profiling  # noqa: E402

RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grid(base, members, files=None, molecules=False, z_max=5):
    """Model files + config; returns (config dict, paths, nus)."""
    paths = []
    for i, kw in enumerate(members):
        paths.append(str(base / f"m{i}.mod"))
        write_marcs_file(paths[-1], **kw)
    line = {"disable": False, "broadening": ["radiation", "linear_stark"]}
    if molecules:
        line.update(include_molecules=True, vald_linelist={"use_linelist": True})
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": f"builtin:{z_max}",
        "input_model": {"type": "marcs", "fname": paths[0], "final_atomic_number": z_max},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "line": line},
        "no_of_thetas": 3,
        "result_options": {},
    }
    if files:
        cfg["opacity"]["file"] = files
    lams = np.arange(6555.0, 6575.0, 0.2)
    return cfg, paths, np.asarray(ju.Quantity(lams, ju.AA).to(ju.Hz, ju.spectral()))


def _jax_batch(base, cfg, paths, nus):
    path = base / "c.yml"
    path.write_text(yaml.safe_dump(cfg))
    config, adata, model0 = parse_config_to_model(path)
    z_max = cfg["input_model"]["final_atomic_number"]
    models = [model0] + [
        read_marcs_model(p).to_stellar_model(adata, final_atomic_number=z_max)
        for p in paths[1:]
    ]
    plan, batch = jbatch.make_batch(config, adata, models, nus)
    return config, adata, models, plan, batch


@pytest.fixture(scope="module", params=["plane_parallel", "spherical_files"])
def grid(request, tmp_path_factory):
    base = tmp_path_factory.mktemp(request.param)
    if request.param == "plane_parallel":
        members = [{"teff": t} for t in (4500.0, 5777.0, 6500.0)]
        files = None
    else:
        members = [{"teff": t, "logg": 2.0, "spherical": True, "radius_cm": r}
                   for t, r in ((3900.0, 1.5e12), (4200.0, 2.0e12), (4800.0, 3.5e12))]
        files = write_opacity_tables(base)
    cfg, paths, nus = _grid(base, members, files)
    config, adata, models, plan, batch = _jax_batch(base, cfg, paths, nus)
    f_ref = np.asarray(jbatch.run_batch(plan, batch))
    return cfg, paths, nus, plan, batch, f_ref


def test_run_batch_matches_jax(grid):
    cfg, paths, nus, plan, batch, f_ref = grid
    tplan = tpipe.plan_from_reference(plan)
    tb = tbatch.batch_from_reference(batch)
    if plan.inward_rays:
        assert tb.photospheric_correction.shape == (3,)
        assert len(np.unique(tb.photospheric_correction)) == 3
        assert len(tb.file_sigmas) == 3 and tb.file_sigmas[0].shape == (3, 56, len(nus))
    else:
        assert tb.photospheric_correction is None and tb.file_sigmas is None
    f = tbatch.run_batch(tplan, tb, device="cpu", dtype=torch.float64)
    assert f.shape == f_ref.shape == (3, 56, len(nus))
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=RTOL, atol=1e-300)


def test_port_host_phase_builds_the_same_batch(grid):
    """make_batch from the port's own config, model reader and atom data
    gives the JAX package's BatchInputs and F_nu."""
    cfg, paths, nus, plan, batch, f_ref = grid
    config, adata, model0 = t_parse(dict(cfg))
    models = [model0] + [t_read_model(config, adata, p) for p in paths[1:]]
    tplan, tb = tbatch.make_batch(config, adata, models, nus)
    ref = tbatch.batch_from_reference(batch)
    for field in ("temperatures", "ray_distances", "photospheric_correction"):
        a, b = getattr(tb, field), getattr(ref, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=field)
    np.testing.assert_allclose(tb.n_elem, ref.n_elem, rtol=1e-12)
    # each tuple follows its plan's file_sources order (YAML sorts the JAX
    # config's keys): compare by source name; the port's are rows, expanded
    # here on the host
    assert all(isinstance(sig, FileSigmaRows) and sig.lo.shape == (3, 56)
               for sig in tb.file_sigmas or ())
    ours = {name: sig.dense() for (name, *_), sig in zip(tplan.file_sources,
                                                          tb.file_sigmas or ())}
    theirs = {name: sig for (name, *_), sig in zip(plan.file_sources, ref.file_sigmas or ())}
    assert ours.keys() == theirs.keys()
    for name in ours:
        np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-12, err_msg=name)
    np.testing.assert_allclose(tbatch.run_batch(tplan, tb, device="cpu", dtype=torch.float64).numpy(), f_ref,
                               rtol=RTOL,
                               atol=1e-300)


def _file_counts():
    c = profiling.counters()
    return c["file_sigma_rows"], c["file_sigma_uploads"]


@pytest.mark.parametrize("mode", ["reference", "accuracy"])
@pytest.mark.parametrize("sharded", [False, True], ids=["unsharded", "mesh2x2"])
def test_file_sigma_rows_match_dense_arrays(grid, mode, sharded):
    """run_batch on the port's rows equals run_batch on the same cross-
    sections as dense host arrays at 1e-12: unsharded, and on a 2 x 2
    ('batch', 'nu') mesh of the CPU, whose tiles cut the rows by model
    chunk and by pixel range; in the accuracy window mode the continuum
    pass that sets each depth's threshold takes them too.  Rows are
    expanded on the device and copied to it by nobody else: the counters
    see one expansion per table and continuum pass, and no upload."""
    cfg, paths, nus, _plan, _batch, _f_ref = grid
    config, adata, model0 = t_parse(dict(cfg))
    models = [model0] + [t_read_model(config, adata, p) for p in paths[1:]]
    tplan, tb = tbatch.make_batch(config, adata, models, nus)
    if not tplan.file_sources:
        assert tb.file_sigmas is None and tplan.file_tables == []
        return
    tplan = dataclasses.replace(tplan, window_mode=mode)
    dense = dataclasses.replace(tb, file_sigmas=tuple(s.dense() for s in tb.file_sigmas))
    mesh = Mesh(np.array(["cpu"] * 4).reshape(2, 2), ("batch", "nu")) if sharded else None
    rows0, uploads0 = _file_counts()
    f = tbatch.run_batch(tplan, tb, mesh=mesh, device="cpu", dtype=torch.float64)
    rows1, uploads1 = _file_counts()
    f_dense = tbatch.run_batch(tplan, dense, mesh=mesh, device="cpu", dtype=torch.float64)
    rows2, uploads2 = _file_counts()
    np.testing.assert_allclose(f.numpy(), f_dense.numpy(), rtol=1e-12, atol=1e-300)
    # continuum passes: one per tile, and in the accuracy mode one per pixel
    # range of the threshold, which a mesh row runs over its columns
    passes = (4 if sharded else 1) + (0 if mode == "reference" else (4 if sharded else 1))
    assert (rows1 - rows0, uploads1 - uploads0) == (3 * passes, 0)
    assert (rows2 - rows1, uploads2 - uploads1) == (0, 3 * passes)


def test_file_sigma_rows_slice_like_dense_arrays(grid):
    """The continuum's file terms from rows cut to a model chunk and a
    pixel range equal those of the dense arrays cut alike, and the whole
    batch's pass cut afterwards, at 1e-12."""
    cfg, paths, nus, _plan, _batch, _f_ref = grid
    config, adata, model0 = t_parse(dict(cfg))
    models = [model0] + [t_read_model(config, adata, p) for p in paths[1:]]
    tplan, tb = tbatch.make_batch(config, adata, models, nus)
    if not tplan.file_sources:
        assert tb.file_sigmas is None
        return
    consts = tpipe.device_constants(tplan, torch.float64, "cpu")
    state, _quants = tpipe.stage_plasma_and_lines(
        tplan, torch.as_tensor(tb.temperatures), torch.as_tensor(tb.n_elem), consts,
        tuple(torch.as_tensor(x) for x in tb.molecule_rows or ()) or None)
    whole = tpipe.continuum_batch(tplan, state, consts.tracing_nus, consts, tb.file_sigmas)
    (m0, m1), (a, b) = (1, 3), (17, 71)
    part = type(state)(*(x[m0:m1] for x in state))
    cut = tpipe.continuum_batch(tplan, part, consts.tracing_nus[a:b], consts,
                                [s[m0:m1] for s in tb.file_sigmas], slice(a, b))
    cut_dense = tpipe.continuum_batch(tplan, part, consts.tracing_nus[a:b], consts,
                                      [s.dense()[m0:m1] for s in tb.file_sigmas], slice(a, b))
    for name, *_ in tplan.file_sources:
        key = f"alpha_file_{name}"
        assert cut[key].shape == (m1 - m0, 56, b - a)
        np.testing.assert_allclose(cut[key].numpy(), cut_dense[key].numpy(), rtol=1e-12,
                                   atol=0, err_msg=key)
        np.testing.assert_allclose(cut[key].numpy(), whole[key][m0:m1, :, a:b].numpy(),
                                   rtol=1e-12, atol=0, err_msg=key)


def test_reference_plan_takes_dense_sigmas_only(grid):
    """A plan carried over from the JAX package has dense sigmas and no
    file tables: the port's batch inputs are refused for it, with a reason,
    in place of a wrong expansion."""
    cfg, paths, nus, plan, _batch, _f_ref = grid
    tplan = tpipe.plan_from_reference(plan)
    assert tplan.file_tables == []
    assert all(isinstance(sig, np.ndarray) and sig.shape == (56, len(nus))
               for _name, sig, _dplan in tplan.file_sources)
    config, adata, model0 = t_parse(dict(cfg))
    models = [model0] + [t_read_model(config, adata, p) for p in paths[1:]]
    if not tplan.file_sources:
        assert tbatch.collect_batch_inputs(config, models, tplan).file_sigmas is None
        return
    with pytest.raises(ValueError, match="batch_from_reference"):
        tbatch.collect_batch_inputs(config, models, tplan)
    _own_plan, tb = tbatch.make_batch(config, adata, models, nus)
    with pytest.raises(ValueError, match="file tables"):
        tbatch.run_batch(tplan, tb, device="cpu", dtype=torch.float64)


def test_members_match_single_runs(grid):
    """Member b of the port's batch equals the port's run of model b alone
    (one code path with B = 1) at 1e-12."""
    cfg, paths, nus, _plan, _batch, _f_ref = grid
    config, adata, model0 = t_parse(dict(cfg))
    models = [model0] + [t_read_model(config, adata, p) for p in paths[1:]]
    tplan, tb = tbatch.make_batch(config, adata, models, nus)
    f = tbatch.run_batch(tplan, tb, device="cpu", dtype=torch.float64).numpy()
    for b, model in enumerate(models):
        single = tpipe.run_simulation(tpipe.build_simulation_plan(config, adata, model, nus),
                                      device="cpu", dtype=torch.float64)
        np.testing.assert_allclose(f[b], single[0].numpy(), rtol=1e-12, atol=1e-300,
                                   err_msg=f"member {b}")


def test_mixed_geometry_and_mesh_are_rejected(tmp_path):
    members = [{"teff": 4800.0, "logg": 2.0, "spherical": True, "radius_cm": 2e12},
               {"teff": 5777.0}]
    cfg, paths, nus = _grid(tmp_path, members)
    config, adata, model0 = t_parse(cfg)
    models = [model0, t_read_model(config, adata, paths[1])]
    with pytest.raises(ValueError, match="geometry"):
        tbatch.make_batch(config, adata, models, nus)
    plan, batch = tbatch.make_batch(config, adata, models[:1], nus)
    with pytest.raises(TypeError, match="Mesh"):
        tbatch.run_batch(plan, batch, mesh=object(), device="cpu", dtype=torch.float64)


def test_molecule_batch_raises_and_jax_discrepancy(tmp_path):
    """Two cool models with one MgH line.  JAX run_batch hands member 1 the
    template's molecular tables; the measured max |dF/F| against the JAX
    single run of model 1 is recorded in ROADMAP.md Queue 3.  The port's
    batch evaluates each member's tables at its own temperatures: each
    member equals the JAX single run of its model at 1e-9."""
    members = [{"teff": 3800.0}, {"teff": 4600.0}]
    cfg, paths, _ = _grid(tmp_path, members, molecules=True, z_max=12)
    lams = np.arange(5160.0, 5170.0, 0.1)
    nus = np.asarray(ju.Quantity(lams, ju.AA).to(ju.Hz, ju.spectral()))
    config, adata, models, plan, batch = _jax_batch(tmp_path, cfg, paths, nus)
    mgh = pd.DataFrame({
        "molecule": ["MgH"], "wavelength": [5165.0], "log_gf": [0.5], "e_low": [0.0],
        "e_up": [2.4], "j_lo": [5], "j_up": [6], "rad": [7.5], "stark": [0.0],
        "waals": [0.0],
    })
    adata.linelist_molecules = mgh
    plan, batch = jbatch.make_batch(config, adata, models, nus)
    assert plan.molecule_line_data.n_lines == 1
    f_batch = np.asarray(jbatch.run_batch(plan, batch))
    f_single = [np.asarray(run_simulation(build_simulation_plan(config, adata, m, nus))[0])
                for m in models]
    err = float(np.abs(f_batch[1, -1] / f_single[1][-1] - 1.0).max())
    print(f"JAX run_batch member 1 vs run_simulation: max |dF/F| = {err:.3e}")
    assert np.isfinite(err)

    tplan = tpipe.plan_from_reference(plan, adata)
    ours = tbatch.run_batch(tplan, tbatch.batch_from_reference(batch, tplan), device="cpu",
                            dtype=torch.float64).numpy()
    for b, ref in enumerate(f_single):
        np.testing.assert_allclose(ours[b], ref, rtol=RTOL, atol=1e-300, err_msg=f"member {b}")
    ours_err = float(np.abs(ours[1, -1] / f_single[1][-1] - 1.0).max())
    print(f"port run_batch member 1 vs JAX run_simulation: max |dF/F| = {ours_err:.3e}")
