"""Batched synthesis: the port's run_batch against the JAX package's, float64.

* plane-parallel members (BASELINE config 5 cut to 3 models) and
  spherical giants with file opacities (per-model corrections and
  cross-sections): port == JAX run_batch at 1e-9, from the JAX plan and
  batch carried over and from the port's own host phase;
* each member against the port's single-model run of that model at 1e-12
  (the batch is the same code path with B > 1);
* mixed geometry is rejected, mesh= is not ported;
* molecules: the JAX run_batch evaluates every member's molecular
  densities with the template model's K(T) / U(T) tables.  The test shows
  that discrepancy (member 1 against the JAX single run of that model) and
  holds the port to raising on a molecule plan rather than copying it.
"""

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
from stardis_tpu_torch.parallel import batch as tbatch  # noqa: E402

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
    # config's keys): compare by source name
    ours = {name: sig for (name, *_), sig in zip(tplan.file_sources, tb.file_sigmas or ())}
    theirs = {name: sig for (name, *_), sig in zip(plan.file_sources, ref.file_sigmas or ())}
    assert ours.keys() == theirs.keys()
    for name in ours:
        np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-12, err_msg=name)
    np.testing.assert_allclose(tbatch.run_batch(tplan, tb, device="cpu", dtype=torch.float64).numpy(), f_ref,
                               rtol=RTOL,
                               atol=1e-300)


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
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tbatch.run_batch(plan, batch, mesh=object())


def test_molecule_batch_raises_and_jax_discrepancy(tmp_path):
    """Two cool models with one MgH line.  JAX run_batch hands member 1 the
    template's molecular tables; the measured max |dF/F| against the JAX
    single run of model 1 is recorded in ROADMAP.md Queue 3.  The port
    raises instead of copying or silently fixing it."""
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
    f_single = np.asarray(run_simulation(build_simulation_plan(config, adata, models[1], nus))[0])
    err = float(np.abs(f_batch[1, -1] / f_single[-1] - 1.0).max())
    print(f"JAX run_batch member 1 vs run_simulation: max |dF/F| = {err:.3e}")
    assert np.isfinite(err)

    with pytest.raises(NotImplementedError, match="Queue 3"):
        tbatch.run_batch(tpipe.plan_from_reference(plan), tbatch.batch_from_reference(batch))
