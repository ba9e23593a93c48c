"""The program's spans and counters (``stardis_tpu_torch.util.profiling``).

* With no profiler a span is the shared null context: nothing is kept and
  no ``record_function`` opens.
* Under ``torch.profiler.profile`` spans nest with their parents and
  request ids, and each is a user annotation ``stardis.<name>`` of the
  profile whose interval lies inside its parent's.
* A CPU served request and a CPU ``collect_batch_inputs`` + ``run_batch``
  of spherical giants with file tables and molecules yield the documented
  span names; ``run_batch(timings=)`` keeps its keys, each stage's span
  covering its wall; ``StageTimer`` reports as before.
* A second profiler session starts an empty buffer.
* A float32 batch's H- ff opacity, expanded from the file table's rows
  with the subnormal factor 1e-26 k_B T folded into the density, matches
  its float64 evaluation at 1e-6, where the dense float32 cross-section
  (~1e-40, subnormal) misses it.
* On the card (marked ``cuda``): no ``stardis.*`` event is among the device
  events of a profiled request or batch, and after warm-up 20 requests and
  3 batches capture no stage 1 again, build no kernel and replay stage 1
  once a call; 3 batches expand their 3 file tables from rows 9 times and
  copy no dense cross-section, and the float32 H- ff opacity holds its
  1e-6.  Run there with
  ``python -m pytest --noconftest tests/test_torch_tracing.py``.

No JAX here, so the file runs on the card's machine too.
"""

import copy
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stardis_tpu_torch import pipeline as tpipe
from stardis_tpu_torch import units as tu
from stardis_tpu_torch.atom_data.builtin import build_builtin_atom_data
from stardis_tpu_torch.base import parse_config_to_model, read_stellar_model
from stardis_tpu_torch.io.synthetic import write_marcs_file, write_opacity_tables
from stardis_tpu_torch.opacities import continuum as tcont
from stardis_tpu_torch.opacities.lines import synth_linelist, synth_molecule_linelist
from stardis_tpu_torch.parallel import batch as tbatch
from stardis_tpu_torch.serving import SpectralService
from stardis_tpu_torch.util import profiling
from stardis_tpu_torch.util.profiling import StageTimer, span, spans

LINE_RANGE = (6499.0, 6506.0)
LAMS = np.arange(6500.0, 6505.0, 0.05)
GIANTS = [{"teff": t, "logg": 2.0, "spherical": True, "radius_cm": 1.152e12}
          for t in (3600.0, 4000.0, 4400.0)]
REQUEST_SPANS = {"serve.request", "serve.inputs", "plasma_and_lines", "validate",
                 "line_opacity", "continuum", "formal_solution", "readback"}
BATCH_SPANS = {"batch.collect_inputs", "batch.member_inputs", "batch.file_sigmas",
               "batch.molecule_rows", "batch.run", "plasma_and_lines", "validate",
               "line_opacity", "continuum", "formal_solution"}
STAGES = {"plasma_and_lines", "validate", "line_opacity", "continuum", "formal_solution"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_profile():
    """A host-only profiler session whose spans start an empty buffer: a
    span outside any profiler comes first, as a program's calls before a
    trace do (two sessions with no span between share one buffer)."""
    with span("before"):
        pass
    return profile(activities=[ProfilerActivity.CPU])


def wall(s):
    return (s.end_ns - s.start_ns) * 1e-9


def annotations(prof):
    """{name: [(start_us, end_us)]} of the profile's stardis.* user
    annotations on the host."""
    out = {}
    for e in prof.events():
        if e.is_user_annotation and e.name.startswith(profiling.PREFIX):
            out.setdefault(e.name.removeprefix(profiling.PREFIX), []).append(
                (e.time_range.start, e.time_range.end))
    return out


@pytest.fixture(scope="module")
def giants(tmp_path_factory):
    """Three spherical giants with file tables, pairwise molecules and
    molecular lines, the port's config and models, and the template plan."""
    base = tmp_path_factory.mktemp("tracing")
    paths = []
    for i, kw in enumerate(GIANTS):
        paths.append(str(base / f"m{i}.mod"))
        write_marcs_file(paths[-1], **kw)
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": paths[0], "final_atomic_number": 30},
        "opacity": {
            "bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H", "H2"],
            "file": write_opacity_tables(base),
            "line": {"disable": False, "broadening": ["radiation", "van_der_waals"],
                     "vald_linelist": {"use_linelist": True, "use_vald_broadening": True},
                     "include_molecules": True},
        },
        "no_of_thetas": 3,
        "result_options": {},
    }
    adata = build_builtin_atom_data(30, include_linelists=True, include_molecules=True)
    synth_linelist(adata, 120, *LINE_RANGE)
    synth_molecule_linelist(adata, 80, *LINE_RANGE)
    config, adata, model0 = parse_config_to_model(copy.deepcopy(cfg), atom_data=adata)
    models = [model0] + [read_stellar_model(config, adata, p) for p in paths[1:]]
    return cfg, config, adata, models


def serve(giants, device, dtype):
    cfg, _config, adata, models = giants
    return SpectralService(copy.deepcopy(cfg), tu.Quantity(LAMS, tu.AA), atom_data=adata,
                           device=device, dtype=dtype)


def template_plan(giants):
    _cfg, config, adata, models = giants
    nus = tu.Quantity(LAMS, tu.AA).to(tu.Hz, tu.spectral()).value
    plan, _batch = tbatch.make_batch(config, adata, models[:1], nus)
    return plan


def test_span_off_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler")

    before = spans()
    monkeypatch.setattr(profiling.autograd_profiler, "record_function", refuse)
    assert span("a") is span("b") is profiling._OFF
    with span("a"), span("b"):
        pass
    timer = StageTimer()
    with timer.stage("plan"):
        pass
    with tbatch._stage({}, "continuum", torch.device("cpu")), tbatch._stage(
            None, "validate", torch.device("cpu")):
        pass
    assert spans() == before and set(timer.report(log=False)) == {"plan", "total"}


def test_spans_nest_with_parents_requests_and_profiler_events():
    with cpu_profile() as prof:
        with span("outer"):
            with span("middle"):
                with span("inner"):
                    torch.ones(8).sum()
            with span("beside"):
                time.sleep(0.001)
        with span("second"):
            pass
    kept = {s.name: s for s in spans()}
    assert set(kept) == {"outer", "middle", "inner", "beside", "second"}
    outer, second = kept["outer"], kept["second"]
    assert outer.parent is None and outer.request == outer.id
    assert second.parent is None and second.request == second.id != outer.request
    parents = {"middle": "outer", "inner": "middle", "beside": "outer"}
    for name, parent in parents.items():
        assert kept[name].parent == kept[parent].id and kept[name].request == outer.id
        assert kept[parent].start_ns <= kept[name].start_ns <= kept[name].end_ns \
            <= kept[parent].end_ns
    events = annotations(prof)
    assert set(events) == set(kept) and all(len(v) == 1 for v in events.values())
    for name, parent in parents.items():
        (s, e), (ps, pe) = events[name][0], events[parent][0]
        assert ps <= s <= e <= pe, (name, parent)
    assert wall(kept["beside"]) >= 1e-3


def test_served_request_yields_its_spans(giants):
    svc = serve(giants, "cpu", torch.float64)
    models = giants[3]
    svc.synthesize(models[0])  # builds the plan
    with cpu_profile() as prof:
        for model in models[1:]:
            svc.synthesize(model)
    kept = spans()
    roots = [s for s in kept if s.parent is None]
    assert [s.name for s in roots] == ["serve.request"] * 2
    assert {s.name for s in kept} == REQUEST_SPANS
    for root in roots:
        children = [s for s in kept if s.request == root.id and s is not root]
        assert all(s.parent == root.id for s in children)
        assert {s.name for s in children} == REQUEST_SPANS - {"serve.request"}
        assert sum(wall(s) for s in children) <= wall(root)
    assert set(annotations(prof)) == REQUEST_SPANS


def test_batch_yields_its_spans_and_keeps_its_timings(giants):
    _cfg, config, _adata, models = giants
    plan = template_plan(giants)
    timings = {}
    with cpu_profile():
        batch = tbatch.collect_batch_inputs(config, models, plan)
        tbatch.run_batch(plan, batch, device="cpu", dtype=torch.float64, timings=timings)
    kept = spans()
    assert {s.name for s in kept} == BATCH_SPANS
    collect, run = (next(s for s in kept if s.name == n)
                    for n in ("batch.collect_inputs", "batch.run"))
    assert collect.parent is None and run.parent is None and collect.request != run.request
    for s in kept:
        if s.name.startswith("batch.") and s is not collect and s is not run:
            assert s.parent == collect.id
        elif s.name in STAGES:
            assert s.parent == run.id and s.request == run.id
    assert set(timings) == STAGES
    for name, seconds in timings.items():
        assert sum(wall(s) for s in kept if s.name == name) >= seconds > 0


def test_batch_inputs_unchanged_by_tracing(giants):
    _cfg, config, _adata, models = giants
    plan = template_plan(giants)
    plain = tbatch.collect_batch_inputs(config, models, plan)
    with cpu_profile():
        traced = tbatch.collect_batch_inputs(config, models, plan)
    assert len(plain.file_sigmas) == 3 and plain.molecule_rows is not None

    def rows(batch):
        return [x for s in batch.file_sigmas for x in (s.lo, s.w, s.factor)]

    for a, b in zip((plain.temperatures, plain.n_elem, plain.ray_distances,
                     plain.photospheric_correction, *rows(plain),
                     *plain.molecule_rows),
                    (traced.temperatures, traced.n_elem, traced.ray_distances,
                     traced.photospheric_correction, *rows(traced),
                     *traced.molecule_rows)):
        np.testing.assert_array_equal(a, b)


def hminus_ff_f32(giants, device, dense=False):
    """(float32 alpha_file_Hminus_ff [B, D, N] of the giants' batch on
    ``device``, its float64 evaluation from the same float32 densities):
    the continuum takes the batch's rows, or with ``dense`` the rows
    expanded to float64 host arrays, which it copies to the device."""
    _cfg, config, _adata, models = giants
    plan = template_plan(giants)
    batch = tbatch.collect_batch_inputs(config, models, plan)
    consts = tpipe.device_constants(plan, torch.float32, device)

    def f32(x):
        return torch.as_tensor(x, device=device).to(torch.float32)

    state, _quants = tpipe.stage_plasma_and_lines(
        plan, f32(batch.temperatures), f32(batch.n_elem), consts,
        tuple(f32(x) for x in batch.molecule_rows))
    sigmas = batch.file_sigmas
    opac = tpipe.continuum_batch(plan, state, consts.tracing_nus, consts,
                                 [s.dense() for s in sigmas] if dense else sigmas)
    i = [name for name, *_ in plan.file_sources].index("Hminus_ff")
    density = tcont.species_density(plan.file_sources[i][2], tpipe.column_state(state),
                                    plan.tables)
    density = density.cpu().double().numpy().reshape(state.t.shape)
    sigma = sigmas[i].dense()
    # every cross-section lies below float32's smallest normal number
    assert (sigma > 0).any() and sigma.max() < torch.finfo(torch.float32).tiny
    ref = density[..., None] * sigma
    return opac["alpha_file_Hminus_ff"].cpu().double().numpy(), ref


def test_float32_hminus_ff_from_rows_matches_float64(giants):
    """The rows' expansion keeps float32's precision; the dense float32
    sigma (1e-26 k_B T x the table, ~1e-40, a subnormal of ~1e-5 relative
    precision) does not."""
    got, ref = hminus_ff_f32(giants, "cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    got_dense, ref_dense = hminus_ff_f32(giants, "cpu", dense=True)
    nonzero = ref_dense > 0
    assert np.abs(got_dense[nonzero] / ref_dense[nonzero] - 1).max() > 1e-6


def test_stage_timer_reports_as_before_under_a_profiler():
    timer = StageTimer(grid_cells=100)
    with cpu_profile():
        for name in ("plan", "solve", "plan"):
            with timer.stage(name):
                time.sleep(0.002)
    report = timer.report(log=False)
    assert list(report) == ["plan", "solve", "total"]
    assert report["plan"] >= 0.004 and report["total"] == pytest.approx(
        report["plan"] + report["solve"])
    assert [s.name for s in spans()] == ["plan", "solve", "plan"]


def test_second_session_starts_an_empty_buffer(tmp_path):
    with cpu_profile():
        with span("first"):
            pass
    assert [s.name for s in spans()] == ["first"]
    with span("between"):  # no profiler: nothing kept, the buffer still the first's
        pass
    assert [s.name for s in spans()] == ["first"]
    with profile(activities=[ProfilerActivity.CPU]):
        with span("second"):
            pass
    assert [s.name for s in spans()] == ["second"]
    with profiling.device_trace(tmp_path / "trace"):  # a trace starts empty by itself
        pass
    assert spans() == []
    with profiling.device_trace(tmp_path / "trace"):
        with span("traced"):
            pass
    assert [s.name for s in spans()] == ["traced"]


def test_span_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_LIMIT", 3)
    with cpu_profile():
        for i in range(5):
            with span(f"s{i}"):
                pass
    assert [s.name for s in spans()] == ["s0", "s1", "s2"]
    assert profiling.counters()["spans_dropped"] == 2


def test_counters_read_where_the_work_happens():
    from stardis_tpu_torch import _cuda
    from stardis_tpu_torch.opacities import line_kernel
    from stardis_tpu_torch.pipeline import CapturedStage1, CapturedStage1Grad

    c = profiling.counters()
    assert c["stage1_captures"] == CapturedStage1.captures
    assert c["stage1_replays"] == CapturedStage1.replays
    assert c["stage1_grad_captures"] == CapturedStage1Grad.captures
    assert c["stage1_grad_replays"] == CapturedStage1Grad.replays
    assert c["stage1_grad_stale_backwards"] == CapturedStage1Grad.stale_backwards
    assert c["kernel_builds"] == len(_cuda.BUILD_LOGS)
    assert c["line_opacity_launches"] == line_kernel.accumulate_line_opacity_cuda.launches
    assert all(isinstance(v, int) for v in c.values())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_annotations_stay_out_of_device_events_and_nothing_is_built_again(cuda,
                                                                               giants):
    from portbench import bench

    _cfg, config, _adata, models = giants
    svc = serve(giants, cuda, torch.float32)
    plan = template_plan(giants)

    def request(i):
        return svc.synthesize(models[i % len(models)])

    def batch():
        inputs = tbatch.collect_batch_inputs(config, models, plan)
        return tbatch.run_batch(plan, inputs, device=cuda, dtype=torch.float32).cpu()

    request(0), batch()  # warm-up: the plans, the kernels, both graphs
    torch.cuda.synchronize()
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        request(1), batch()
        torch.cuda.synchronize()
    device_events, host_spans = bench.trace_events(prof)
    assert device_events and not [n for n, _s, _e in device_events
                                  if n.startswith(profiling.PREFIX)]
    names = {n.removeprefix(profiling.PREFIX) for n, _s, _e in host_spans}
    assert names >= REQUEST_SPANS | BATCH_SPANS
    for i in range(20):
        request(i)
    for _ in range(3):
        batch()
    after = profiling.counters()
    assert after["stage1_captures"] == before["stage1_captures"]
    assert after["kernel_builds"] == before["kernel_builds"]
    assert after["stage1_replays"] == before["stage1_replays"] + 2 + 20 + 3


@pytest.mark.cuda
def test_card_batches_expand_file_tables_from_rows(cuda, giants):
    """After warm-up, 3 batches of the giants expand their 3 file tables on
    the card from rows 9 times and copy no dense cross-section there; the
    float32 H- ff opacity holds 1e-6 of its float64 evaluation."""
    _cfg, config, _adata, models = giants
    plan = template_plan(giants)

    def batch():
        inputs = tbatch.collect_batch_inputs(config, models, plan)
        return tbatch.run_batch(plan, inputs, device=cuda, dtype=torch.float32).cpu()

    batch()
    before = profiling.counters()
    for _ in range(3):
        batch()
    after = profiling.counters()
    assert after["file_sigma_rows"] - before["file_sigma_rows"] == 9
    assert after["file_sigma_uploads"] == before["file_sigma_uploads"]
    got, ref = hminus_ff_f32(giants, cuda)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
