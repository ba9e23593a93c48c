"""Stage 1 with the model axis: the port's ``stage_plasma_and_lines`` of
[B, D] temperatures against the JAX package's own batched stage 1,
``jax.jit(jax.vmap(stardis_tpu.pipeline.stage_plasma_and_lines))``, in
float64 at 1e-9 on every PlasmaState field and every line quantity.

Configurations: 3-model plane-parallel batches on the TARDIS line path
(builtin:2, H lines) and on the VALD path (builtin:30, synthetic lines,
VALD broadening), and 3 spherical giants with file opacities (the fixture
of ``tests/test_torch_batch.py``); the JAX plans and batches are carried
over with ``plan_from_reference`` and ``batch_from_reference``.  Also:

* each member equals the port's single-model call at 1e-12;
* a stage-1 call dispatches the same operations for 1 and 4 models (a
  ``TorchDispatchMode`` count), and so does the continuum's one pass;
* stage 1 calls neither ``torch.as_tensor`` nor ``torch.tensor``: it
  uploads nothing per call (the plan's DeviceConstants hold every per-line
  column and table), molecules included; a batch of molecule models on
  their own molecular rows equals each model's single stage 1 bit for bit;
* the finiteness check names the model at fault; the captured graph
  (``pipeline.CapturedStage1``) refuses the CPU, and ``run_batch``'s cache
  of captured graphs keys, shares and evicts as the JAX package's
  ``_STAGE1_CACHE`` does.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from bench_lines import synth_linelist as jax_synth_linelist  # noqa: E402
from stardis_tpu import parse_config_to_model, units as ju  # noqa: E402
from stardis_tpu.io.marcs import read_marcs_model  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.parallel import batch as jbatch  # noqa: E402
from stardis_tpu.pipeline import stage_plasma_and_lines as jax_stage1  # noqa: E402
from stardis_tpu_torch import pipeline as tpipe  # noqa: E402
from stardis_tpu_torch.atom_data import build_builtin_atom_data  # noqa: E402
from stardis_tpu_torch.base import parse_config_to_model as t_parse  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_opacity_tables  # noqa: E402
from stardis_tpu_torch.opacities.lines import (  # noqa: E402
    synth_linelist,
    synth_molecule_linelist,
)
from stardis_tpu_torch.parallel import batch as tbatch  # noqa: E402
from stardis_tpu_torch.plasma.lte import PlasmaState  # noqa: E402

RTOL = 1e-9
BROADENING = ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"]
CPU = {"device": "cpu", "dtype": torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _members(base, members):
    paths = []
    for i, kw in enumerate(members):
        paths.append(str(base / f"m{i}.mod"))
        write_marcs_file(paths[-1], **kw)
    return paths


def _config(path, z_max, line, files=None):
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": f"builtin:{z_max}",
        "input_model": {"type": "marcs", "fname": path, "final_atomic_number": z_max},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"], "line": line},
        "no_of_thetas": 3,
    }
    if files:
        cfg["opacity"]["file"] = files
    return cfg


def _setup(kind, base):
    """(JAX config dict, model paths, nus, VALD line count or 0)."""
    if kind == "spherical_files":
        paths = _members(base, [{"teff": t, "logg": 2.0, "spherical": True, "radius_cm": r}
                                for t, r in ((3900.0, 1.5e12), (4200.0, 2.0e12),
                                             (4800.0, 3.5e12))])
        cfg = _config(paths[0], 5, {"disable": False, "broadening": ["radiation",
                                                                       "linear_stark"]},
                      write_opacity_tables(base))
        lams, n_vald = np.arange(6555.0, 6575.0, 0.2), 0
    else:
        paths = _members(base, [{"teff": t} for t in (4500.0, 5777.0, 6500.0)])
        line = {"disable": False, "broadening": BROADENING}
        if kind == "vald":
            line["vald_linelist"] = {"use_linelist": True, "use_vald_broadening": True}
            cfg = _config(paths[0], 30, line)
            lams, n_vald = np.arange(6500.0, 6510.0, 0.05), 400
        else:
            cfg = _config(paths[0], 2, line)
            lams, n_vald = np.arange(6540.0, 6590.0, 0.2), 0
    return cfg, paths, np.asarray(ju.Quantity(lams, ju.AA).to(ju.Hz, ju.spectral())), n_vald


@pytest.fixture(scope="module", params=["tardis", "vald", "spherical_files"])
def batched(request, tmp_path_factory):
    base = tmp_path_factory.mktemp(request.param)
    cfg, paths, nus, n_vald = _setup(request.param, base)
    path = base / "c.yml"
    path.write_text(yaml.safe_dump(cfg))
    config, adata, model0 = parse_config_to_model(str(path))
    if n_vald:
        jax_synth_linelist(adata, n_vald, lam_lo=6499.0, lam_hi=6511.0)
    z_max = cfg["input_model"]["final_atomic_number"]
    models = [model0] + [read_marcs_model(p).to_stellar_model(adata, final_atomic_number=z_max)
                         for p in paths[1:]]
    plan, batch = jbatch.make_batch(config, adata, models, nus)
    ref_state, ref_quants = jax.jit(jax.vmap(lambda t, n: jax_stage1(plan, t, n)))(
        jnp.asarray(batch.temperatures), jnp.asarray(batch.n_elem))
    tplan = tpipe.plan_from_reference(plan)
    tb = tbatch.batch_from_reference(batch)
    consts = tpipe.device_constants(tplan, torch.float64, "cpu")
    temps, n_elem = torch.from_numpy(tb.temperatures), torch.from_numpy(tb.n_elem)
    state, quants = tpipe.stage_plasma_and_lines(tplan, temps, n_elem, consts)
    return {"ref": (ref_state, ref_quants), "ours": (state, quants), "plan": tplan,
            "batch": tb, "consts": consts, "temps": temps, "n_elem": n_elem}


def _fields(state, quants):
    """[(name, array)] of every PlasmaState field and line quantity."""
    out = [(name, getattr(state, name)) for name in PlasmaState._fields]
    for key, triple in (quants or {}).items():
        out += [(f"{key} {q}", x) for q, x in zip(("alpha", "gamma", "doppler"), triple)]
    return out


def test_batched_stage1_matches_jax_vmap(batched):
    (ref_state, ref_quants), (state, quants) = batched["ref"], batched["ours"]
    assert set(quants) == set(ref_quants) == {"atomic"}
    ours, ref = _fields(state, quants), _fields(ref_state, ref_quants)
    for (name, o), (_, r) in zip(ours, ref):
        assert o.shape == r.shape and o.shape[0] == 3, name
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL, atol=1e-300,
                                   err_msg=name)


def test_members_equal_single_model_calls(batched):
    """Member b of the batched call equals the port's call on model b
    alone (1-D inputs, the same code with B = 1) at 1e-12."""
    state, quants = batched["ours"]
    for b in range(3):
        single = tpipe.stage_plasma_and_lines(batched["plan"], batched["temps"][b],
                                              batched["n_elem"][b], batched["consts"])
        assert single[0].t.ndim == 1 and single[1]["atomic"][0].ndim == 2
        member = (PlasmaState(*(x[b] for x in state)),
                  {k: tuple(x[b] for x in triple) for k, triple in quants.items()})
        for (name, o), (_, r) in zip(_fields(*member), _fields(*single)):
            np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-12, atol=1e-300,
                                       err_msg=f"member {b} {name}")


class _Count(TorchDispatchMode):
    """Counts the aten operations dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _repeat(x, n):
    return x[:1].repeat(n, *([1] * (x.ndim - 1)))


def test_dispatch_count_does_not_grow_with_the_batch(batched):
    """One stage-1 call, and one pass of the continuum, dispatch the same
    operations for 1 and 4 models."""
    plan, consts = batched["plan"], batched["consts"]
    counts = []
    for n_models in (1, 4):
        with _Count() as stage:
            state, _ = tpipe.stage_plasma_and_lines(
                plan, _repeat(batched["temps"], n_models), _repeat(batched["n_elem"], n_models),
                consts)
        sigmas = None if batched["batch"].file_sigmas is None else [
            np.repeat(s[:1], n_models, axis=0) for s in batched["batch"].file_sigmas]
        with _Count() as continuum:
            tpipe.continuum_batch(plan, state, consts.tracing_nus, consts, sigmas)
        counts.append((stage.n, continuum.n))
    assert counts[0] == counts[1] and counts[0][0] > 100


def _no_uploads(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("stage 1 uploaded a host array")

    monkeypatch.setattr(torch, "as_tensor", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)


def test_stage1_uploads_nothing(batched, monkeypatch):
    plan, consts = batched["plan"], batched["consts"]
    temps, n_elem = batched["temps"], batched["n_elem"]
    _no_uploads(monkeypatch)
    state, quants = tpipe.stage_plasma_and_lines(plan, temps, n_elem, consts)
    for (name, o), (_, r) in zip(_fields(state, quants), _fields(*batched["ours"])):
        assert torch.equal(o, r), name


@pytest.fixture(scope="module")
def molecules():
    """The port's own plan of the MARCS sun with molecules and molecular
    lines (builtin:30, VALD atomic and molecular lists)."""
    import tempfile

    base = tempfile.mkdtemp()
    path = f"{base}/sun.mod"
    write_marcs_file(path)
    line = {"disable": False, "broadening": BROADENING, "include_molecules": True,
            "vald_linelist": {"use_linelist": True, "use_vald_broadening": True}}
    adata = build_builtin_atom_data(30, include_linelists=True, include_molecules=True)
    synth_linelist(adata, 300, 6499.0, 6511.0)
    synth_molecule_linelist(adata, 300, 6499.0, 6511.0)
    config, adata, model = t_parse(_config(path, 30, line), atom_data=adata)
    lams = np.arange(6500.0, 6510.0, 0.05)
    nus = ju.Quantity(lams, ju.AA).to(ju.Hz, ju.spectral()).value
    plan = tpipe.build_simulation_plan(config, adata, model, nus)
    return plan, tpipe.device_constants(plan, torch.float64, "cpu")


@pytest.mark.parametrize("coupled", [False, True], ids=["pairwise", "coupled"])
def test_molecules_upload_nothing_and_batches_raise(molecules, monkeypatch, coupled):
    """A single run with molecules reads its molecular tables and line
    columns from the plan's DeviceConstants.  A batch of two models (the
    plan's, and one 8 % cooler) on their own molecular rows equals each
    model's single stage 1 on its own plan's tables bit for bit; a batch
    without the rows raises, as it would give every member the plan's."""
    import dataclasses

    plan, consts = molecules
    plan = dataclasses.replace(plan, molecules_coupled=coupled)
    temps, n_elem = torch.from_numpy(plan.temperatures), torch.from_numpy(plan.n_elem)
    ref = tpipe.stage_plasma_and_lines(plan, temps, n_elem, consts)
    assert set(ref[1]) == {"atomic", "molecular"}
    both = torch.stack([temps, temps * 0.92])
    with pytest.raises(ValueError, match="molecule_rows"):
        tpipe.stage_plasma_and_lines(plan, both, n_elem.repeat(2, 1, 1), consts)
    mt = plan.molecule_tables
    rows = mt.rows_at(both.numpy())
    batch = tpipe.stage_plasma_and_lines(
        plan, both, n_elem.repeat(2, 1, 1), consts,
        tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in rows))
    for b in range(2):
        cool = dataclasses.replace(plan, temperatures=both[b].numpy(), molecule_tables=(
            dataclasses.replace(mt, k_density=rows.k_density[b],
                                partition_function=rows.partition_function[b])))
        single = tpipe.stage_plasma_and_lines(
            cool, both[b], n_elem, tpipe.device_constants(cool, torch.float64, "cpu"))
        member = (PlasmaState(*(x[b] for x in batch[0])),
                  {k: tuple(x[b] for x in t) for k, t in batch[1].items()})
        for (name, o), (_, r) in zip(_fields(*member), _fields(*single)):
            assert torch.equal(o, r), f"member {b}: {name}"
    _no_uploads(monkeypatch)
    ours = tpipe.stage_plasma_and_lines(plan, temps, n_elem, consts)
    for (name, o), (_, r) in zip(_fields(*ours), _fields(*ref)):
        assert torch.equal(o, r), name


def test_continuum_batch_members_equal_single_passes(batched):
    """The continuum's one pass over B * D columns: each member equals the
    pass over that model alone at 1e-12."""
    plan, consts, tb = batched["plan"], batched["consts"], batched["batch"]
    state, _ = batched["ours"]
    whole = tpipe.continuum_batch(plan, state, consts.tracing_nus, consts, tb.file_sigmas)
    assert all(v.shape == (3, 56, len(plan.tracing_nus)) for v in whole.values())
    for b in range(3):
        member = PlasmaState(*(x[b:b + 1] for x in state))
        sigmas = None if tb.file_sigmas is None else [s[b:b + 1] for s in tb.file_sigmas]
        alone = tpipe.continuum_batch(plan, member, consts.tracing_nus, consts, sigmas)
        assert alone.keys() == whole.keys()
        for key in alone:
            np.testing.assert_allclose(whole[key][b].numpy(), alone[key][0].numpy(),
                                       rtol=1e-12, atol=1e-300, err_msg=f"{key} member {b}")


def test_validate_names_the_model_at_fault(batched):
    state, quants = batched["ours"]
    alpha, gamma, doppler = quants["atomic"]
    gamma = gamma.clone()
    gamma[1, 0, 5] = float("nan")
    tpipe.validate_line_quants(quants)
    with pytest.raises(ValueError, match=r"atomic \(model 1\):gamma"):
        tpipe.validate_line_quants({"atomic": (alpha, gamma, doppler)})


def test_captured_stage1_refuses_the_cpu(batched):
    with pytest.raises(ValueError, match="CUDA device"):
        tpipe.CapturedStage1(batched["plan"], batched["consts"], 3)


def test_stage1_cache_keys_shares_and_evicts(batched, monkeypatch):
    """run_batch's cache of captured graphs: one entry per (plan, B, dtype,
    device), shared by later calls, holding its plan; the oldest goes
    first beyond STAGE1_CACHE_LIMIT.  (The capture itself needs the card:
    a recording stand-in takes its place here.)"""
    made = []

    class Recording:
        def __init__(self, plan, consts, n_models):
            self.plan, self.consts, self.n_models = plan, consts, n_models
            made.append(self)

    monkeypatch.setattr(tbatch, "CapturedStage1", Recording)
    monkeypatch.setattr(tbatch, "_STAGE1_CACHE", {})
    plan = batched["plan"]
    first = tbatch.captured_stage1(plan, 3, torch.float64, "cpu")
    assert tbatch.captured_stage1(plan, 3, torch.float64, "cpu") is first
    assert first.plan is plan and first.n_models == 3 and len(made) == 1
    others = [tbatch.captured_stage1(plan, b, torch.float64, "cpu")
              for b in range(4, 4 + tbatch.STAGE1_CACHE_LIMIT)]
    assert len(tbatch._STAGE1_CACHE) == tbatch.STAGE1_CACHE_LIMIT
    assert tbatch.captured_stage1(plan, 3, torch.float64, "cpu") is not first
    assert tbatch.captured_stage1(plan, 3 + tbatch.STAGE1_CACHE_LIMIT, torch.float64,
                                  "cpu") is others[-1]


def test_run_batch_on_the_cpu_runs_the_eager_stage(batched, monkeypatch):
    """On the CPU run_batch never reaches the graph cache, and its F_nu is
    the eager stage's through spectrum_batch."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU run asked for a captured stage 1")

    monkeypatch.setattr(tbatch, "captured_stage1", refuse)
    plan, tb, consts = batched["plan"], batched["batch"], batched["consts"]
    f_nu = tbatch.run_batch(plan, tb, **CPU)
    state, quants = batched["ours"]
    lines = tpipe.prepare_lines(plan, state, quants, consts, tb.file_sigmas)
    ref = tpipe.spectrum_batch(plan, state, lines, consts, tb.ray_distances,
                               tb.photospheric_correction, tb.file_sigmas)[0]
    assert torch.equal(f_nu, ref)
