"""The differentiated stage 1 (``pipeline.stage_plasma_and_lines`` under
autograd) on the CPU.

* Off the card, under ``torch.no_grad()``, and with no input that requires
  grad, the stage runs its eager body: no ``CapturedStage1Grad`` is made
  and its three counters stay where they were.
* The route its graphs take on the card, run here eagerly: copies of the
  planes of ``_stage1_columns`` with their strides, the caller's
  views on them, and the planes' backward with a zero cotangent wherever
  the caller's loss gives none, equals the eager stage's outputs, strides
  and gradient bit for bit (float32 and float64, one model and a batch,
  atomic lines and spherical giants with molecules).
* A backward whose forward a later replay overwrote runs its forward again
  eagerly and equals the eager gradient bit for bit.
* ``run_batch``'s differentiated batches on the card share one upload of
  the plan's constants per (plan, dtype, device), so they find their
  graphs again.

The card's own checks (replays equal the eager stage bit for bit, stale
backwards, retained graphs, hooks, the pool) are in
``tests/test_torch_cuda.py``.  No JAX here.
"""

import copy

import numpy as np
import pytest
import torch

from stardis_tpu_torch import pipeline as tpipe
from stardis_tpu_torch import units as tu
from stardis_tpu_torch.atom_data.builtin import build_builtin_atom_data
from stardis_tpu_torch.base import parse_config_to_model, read_stellar_model
from stardis_tpu_torch.io.synthetic import write_marcs_file, write_opacity_tables
from stardis_tpu_torch.opacities.lines import synth_linelist, synth_molecule_linelist
from stardis_tpu_torch.parallel import batch as tbatch
from stardis_tpu_torch.util import profiling

LINE_RANGE = (6499.0, 6506.0)
LAMS = np.arange(6500.0, 6505.0, 0.05)
GRAD_COUNTERS = ("stage1_grad_captures", "stage1_grad_replays", "stage1_grad_stale_backwards")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one thread each
    (bit-for-bit comparisons hold at any thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(base, molecules):
    """(plan, BatchInputs) of three models: plane-parallel suns with atomic
    lines, or spherical giants with file tables, molecules and molecular
    lines."""
    if molecules:
        kws = [{"teff": t, "logg": 2.0, "spherical": True, "radius_cm": 1.152e12}
               for t in (3600.0, 4000.0, 4400.0)]
    else:
        kws = [{"teff": t} for t in (4800.0, 5777.0, 6500.0)]
    paths = []
    for i, kw in enumerate(kws):
        paths.append(str(base / f"m{i}.mod"))
        write_marcs_file(paths[-1], **kw)
    line = {"disable": False,
            "broadening": ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"],
            "vald_linelist": {"use_linelist": True, "use_vald_broadening": True}}
    opacity = {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"], "line": line}
    if molecules:
        opacity.update(rayleigh=["H", "H2"], file=write_opacity_tables(base))
        line["include_molecules"] = True
    cfg = {"stardis_config_version": 1.0, "atom_data": "builtin:30",
           "input_model": {"type": "marcs", "fname": paths[0], "final_atomic_number": 30},
           "opacity": opacity, "no_of_thetas": 3}
    adata = build_builtin_atom_data(30, include_linelists=True, include_molecules=molecules)
    synth_linelist(adata, 120, *LINE_RANGE)
    if molecules:
        synth_molecule_linelist(adata, 80, *LINE_RANGE)
    config, adata, model0 = parse_config_to_model(copy.deepcopy(cfg), atom_data=adata)
    models = [model0] + [read_stellar_model(config, adata, p) for p in paths[1:]]
    nus = tu.Quantity(LAMS, tu.AA).to(tu.Hz, tu.spectral()).value
    return tbatch.make_batch(config, adata, models, nus)


@pytest.fixture(scope="module", params=[False, True], ids=["suns", "giants"])
def batched(request, tmp_path_factory):
    plan, batch = _batch(tmp_path_factory.mktemp("stage1_grad"), request.param)
    return plan, batch


def _inputs(plan, batch, dtype, single, scale=1.0):
    """(temps, n_elem, molecule rows) at ``scale``: T s and n / s with s a
    tensor that requires grad, as a fit's step makes them."""
    s = torch.tensor(scale, dtype=dtype, requires_grad=True)
    if single:
        temps, n_elem, rows = plan.temperatures, plan.n_elem, None
    else:
        temps, n_elem = batch.temperatures, batch.n_elem
        rows = batch.molecule_rows and tuple(torch.as_tensor(x).to(dtype)
                                             for x in batch.molecule_rows)
    return (torch.as_tensor(temps).to(dtype) * s, torch.as_tensor(n_elem).to(dtype) / s,
            rows)


def _tensors(state, quants):
    return list(state) + [x for triple in quants.values() for x in triple]


def _loss(state, quants, seed=0):
    """A weighted sum of alpha, gamma, doppler and n_e, as the spectrum
    reads them; the weights are drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    used = [state.electron_densities] + [x for triple in quants.values() for x in triple]
    return sum((x * torch.rand(x.shape, generator=gen, dtype=x.dtype)).sum() for x in used)


@pytest.mark.parametrize("mode", ["cpu", "no_grad", "no_input_requires_grad"])
def test_off_the_card_the_stage_runs_its_eager_body(batched, monkeypatch, mode):
    plan, batch = batched
    consts = tpipe.device_constants(plan, torch.float64, "cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("stage 1 captured a graph off the card")

    monkeypatch.setattr(tpipe, "captured_stage1_grad", refuse)
    before = {k: profiling.counters()[k] for k in GRAD_COUNTERS}
    temps, n_elem, rows = _inputs(plan, batch, torch.float64, single=False)
    if mode == "no_input_requires_grad":
        temps, n_elem = temps.detach(), n_elem.detach()
    grad = torch.no_grad() if mode == "no_grad" else torch.enable_grad()
    with grad:
        assert not tpipe._replays_grad_graph((temps, n_elem, *(rows or ())), consts)
        out = _tensors(*tpipe.stage_plasma_and_lines(plan, temps, n_elem, consts, rows))
        eager = _tensors(*tpipe._stage_plasma_and_lines(plan, temps, n_elem, consts, rows))
    assert all(torch.equal(a, b) and a.stride() == b.stride() for a, b in zip(out, eager))
    assert all(a.requires_grad == (mode == "cpu") for a in out[4:5])
    assert {k: profiling.counters()[k] for k in GRAD_COUNTERS} == before
    assert not tpipe._STAGE1_GRAD_CACHE


@pytest.mark.parametrize("single", [True, False], ids=["one model", "batch"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_graphs_route_equals_the_eager_stage(batched, dtype, single):
    """Copies of the planes, the caller's views on them and
    a zero cotangent on every plane the loss leaves out: the outputs, their
    strides and the gradient are the eager stage's, bit for bit."""
    plan, batch = batched
    consts = tpipe.device_constants(plan, dtype, "cpu")
    for scale in (1.0, 1.03):
        temps, n_elem, rows = _inputs(plan, batch, dtype, single, scale)
        state, quants = tpipe._stage_plasma_and_lines(plan, temps, n_elem, consts, rows)
        eager = _tensors(state, quants)
        want = torch.autograd.grad(_loss(state, quants), (temps, n_elem))

        leaves = (temps.detach().requires_grad_(), n_elem.detach().requires_grad_())
        planes, keys = tpipe._flatten(*tpipe._stage1_columns(plan, *leaves, consts, rows))
        copies = [x.detach().clone().requires_grad_(x.requires_grad) for x in planes]
        state, quants = tpipe._model_views(*tpipe._unflatten(copies, keys), temps)
        out = _tensors(state, quants)
        assert all(torch.equal(a, b) and a.stride() == b.stride() for a, b in zip(out, eager))
        cotangents = torch.autograd.grad(_loss(state, quants), copies, allow_unused=True)
        cotangents = [torch.zeros_like(x) if g is None else g
                      for x, g in zip(copies, cotangents)]
        got = torch.autograd.grad(planes, leaves, cotangents)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), scale


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_a_stale_backward_differentiates_its_own_forward(batched, dtype):
    """An entry whose generation has moved on: its backward runs the saved
    inputs' forward eagerly and equals the eager gradient bit for bit,
    with None where the caller gave no cotangent, and is counted."""
    plan, batch = batched
    consts = tpipe.device_constants(plan, dtype, "cpu")
    temps, n_elem, rows = _inputs(plan, batch, dtype, single=False, scale=0.97)
    inputs = (temps, n_elem, *(rows or ()))
    state, quants = tpipe._stage_plasma_and_lines(plan, temps, n_elem, consts, rows)
    want = torch.autograd.grad(_loss(state, quants), (temps, n_elem))

    entry = object.__new__(tpipe.CapturedStage1Grad)
    entry.plan, entry.consts, entry._generation = plan, consts, 2
    entry._requires = tuple(x.requires_grad for x in inputs)
    entry._lock = tpipe.threading.Lock()
    planes, keys = entry._planes(tuple(x.detach() for x in inputs))
    copies = [x.requires_grad_() for x in planes]
    state, quants = tpipe._model_views(*tpipe._unflatten(copies, keys), temps)
    grads = torch.autograd.grad(_loss(state, quants), copies, allow_unused=True)
    before = tpipe.CapturedStage1Grad.stale_backwards
    got = entry.backward(1, inputs, grads)
    assert tpipe.CapturedStage1Grad.stale_backwards == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(g is None for g in got[2:])


def test_differentiated_batches_share_their_constants(batched, monkeypatch):
    """One upload per (plan, dtype, device), the oldest dropped beyond
    STAGE1_GRAD_CACHE_LIMIT, so a batch's graphs are found again."""
    plan, _batch = batched
    uploads = []
    monkeypatch.setattr(tbatch, "device_constants",
                        lambda *args: uploads.append(args) or object())
    monkeypatch.setattr(tbatch, "_GRAD_CONSTS", {})
    first = tbatch._grad_constants(plan, torch.float32, torch.device("cuda"))
    assert tbatch._grad_constants(plan, torch.float32, torch.device("cuda")) is first
    assert len(uploads) == 1
    for i in range(tpipe.STAGE1_GRAD_CACHE_LIMIT):
        tbatch._grad_constants(plan, torch.float32, torch.device("cuda", i + 1))
    assert len(tbatch._GRAD_CONSTS) == tpipe.STAGE1_GRAD_CACHE_LIMIT
    assert tbatch._grad_constants(plan, torch.float32, torch.device("cuda")) is not first
