"""Batched synthesis of many atmospheres on one device.

The port of ``stardis_tpu/parallel/batch.py`` (BASELINE.json config 5: a
Teff/logg grid of models).  All models of a batch share the config
(opacity sources, line window, theta count), the depth-point count and the
geometry kind; temperatures, densities, geometry, the spherical correction,
the file-opacity cross-sections and the molecular K(T) / U(T) rows vary per
model.  The JAX package's batch gives every member the template model's
molecular tables; the port evaluates each member's at its own temperatures
(``MoleculeTables.rows_at``), as it does the file cross-sections, so a
member equals that model's single run.

Stage 1 (plasma and line quantities), the continuum and the source run
once for the whole batch, its models folded into the depth columns (the
port of ``jax.vmap``); each kernel runs the whole batch in one launch
(Kernel 1 once per line set, Kernel 2 once), through the same
``pipeline.spectrum_batch`` that a single ``run_stardis`` uses with a
batch of one.  On the card, without autograd and without a mesh, stage 1
is captured once per (plan, B, dtype, device) in a CUDA graph
(``pipeline.CapturedStage1``) and replayed by later batches, as the JAX
package keeps its jitted stage 1 in ``_STAGE1_CACHE``; under autograd
it replays the graphs of its forward and backward
(``pipeline.CapturedStage1Grad``) captured for the device constants that
``_grad_constants`` keeps per (plan, dtype, device).  On a mesh
(``parallel.sharding``) each batch row runs a contiguous chunk of the
models, stage 1 (eager, one call per chunk) and the spectrum on the
devices of its entries.
"""

from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager

import numpy as np
import torch

from ..pipeline import (
    STAGE1_GRAD_CACHE_LIMIT,
    CapturedStage1,
    SimulationPlan,
    _stage,
    build_simulation_plan,
    device_constants,
    elemental_densities,
    model_geometry,
    prepare_lines,
    resolve_device,
    spectrum_batch,
    stage_plasma_and_lines,
    validate_line_quants,
)
from ..pipeline import _stage_plasma_and_lines as _eager_stage1
from ..plasma.molecules import MoleculeRows
from ..radiation_field.solver import gauss_legendre_thetas
from ..util.profiling import span
from .sharding import Mesh, as_batch_nu, shard_tiles, visible_devices


@dataclasses.dataclass
class BatchInputs:
    # temperatures and n_elem may also be tensors on the run's device, with
    # requires_grad for gradients of run_batch's F_nu with respect to them
    temperatures: np.ndarray  # [B, D]
    n_elem: np.ndarray  # [B, E, D]
    ray_distances: np.ndarray  # [B, G, T]
    # per-model spherical flux correction (r_outer/r_ref)^2, or None for
    # plane-parallel batches
    photospheric_correction: np.ndarray | None = None  # [B]
    # per-model file-opacity cross-sections, one per plan.file_sources entry
    # (same order), or None without file sources: they depend on each
    # model's temperatures.  FileSigmaRows [B, D] of the plan's file tables
    # (``collect_batch_inputs``; the device expands them), or dense
    # [B, D, N] host arrays (``batch_from_reference``)
    file_sigmas: tuple | None = None
    # per-model molecular tables at each model's temperatures, K(T) and
    # U(T), each [B, M, D] (``MoleculeTables.rows_at``), or None without
    # molecules; host constants, which carry no gradient
    molecule_rows: MoleculeRows | None = None


def make_batch(config, atom_data, stellar_models, tracing_nus_hz):
    """(template plan, BatchInputs) for a homogeneous model batch; the plan
    is built from the first model."""
    with span("plan"):
        plan = build_simulation_plan(config, atom_data, stellar_models[0], tracing_nus_hz)
    return plan, collect_batch_inputs(config, stellar_models, plan)


def collect_batch_inputs(config, stellar_models, plan) -> BatchInputs:
    """Per-model arrays for an existing template plan.  Traced, the call is
    the root span "batch.collect_inputs", with "batch.member_inputs" (each
    member's checks, densities and geometry), "batch.file_sigmas" (each
    file table's rows at the members' temperatures) and
    "batch.molecule_rows"."""
    with span("batch.collect_inputs"):
        with span("batch.member_inputs"):
            temps, n_elem, rays, corrs = _member_inputs(config, stellar_models, plan)
        with span("batch.file_sigmas"):
            file_sigmas = _file_sigmas(plan, temps)
        with span("batch.molecule_rows"):
            molecule_rows = _molecule_rows(plan, temps)
    return BatchInputs(temps, n_elem, rays, corrs, file_sigmas, molecule_rows)


def _member_inputs(config, stellar_models, plan):
    """Each member held to the plan: temperatures [B, D], elemental
    densities [B, E, D], rays [B, G, T] and spherical corrections [B] (or
    None)."""
    thetas, _ = gauss_legendre_thetas(int(config.no_of_thetas))
    n_depth = len(plan.temperatures)

    temps, n_elem, rays, corrs = [], [], [], []
    for i, model in enumerate(stellar_models):
        if len(model.temperatures) != n_depth:
            raise ValueError("all models in a batch need equal depth points")
        if bool(model.spherical) != bool(plan.inward_rays):
            raise ValueError(
                f"batch model {i} geometry (spherical={bool(model.spherical)}) "
                f"does not match the template plan "
                f"(spherical={bool(plan.inward_rays)})"
            )
        temps.append(np.asarray(model.temperatures, dtype=np.float64))
        n_elem.append(elemental_densities(model, plan.tables))
        ray, _inward, correction = model_geometry(model, thetas)
        rays.append(ray)
        if correction is not None:
            corrs.append(correction)
    return (np.stack(temps), np.stack(n_elem), np.stack(rays),
            np.asarray(corrs) if corrs else None)


def _file_sigmas(plan, temps):
    """Every member's file-opacity cross-sections: per plan.file_tables
    entry its FileSigmaRows [B, D], one host evaluation each, or None for
    a plan without file sources."""
    if not plan.file_sources:
        return None
    if not plan.file_tables:
        raise ValueError("a plan carried over from the JAX package has no file tables: "
                         "take its batch's cross-sections with batch_from_reference")
    return tuple(table.rows_at(temps) for table in plan.file_tables)


def _molecule_rows(plan, temps):
    """Every member's K(T) and U(T) rows [B, M, D] in one evaluation, or
    None for a plan without molecules."""
    if plan.molecule_tables is None:
        return None
    return plan.molecule_tables.rows_at(temps)


def batch_from_reference(batch, plan=None) -> BatchInputs:
    """The port's BatchInputs from a ``stardis_tpu.parallel.batch
    .BatchInputs`` (its fields are NumPy arrays), in float64.  The JAX
    batch has no molecular rows: for a plan with molecules (the port's,
    ``pipeline.plan_from_reference`` with the atom data) they are evaluated
    at the members' temperatures."""
    f64 = lambda x: None if x is None else np.asarray(x, dtype=np.float64)  # noqa: E731
    temps = f64(batch.temperatures)
    return BatchInputs(
        temperatures=temps,
        n_elem=f64(batch.n_elem),
        ray_distances=f64(batch.ray_distances),
        photospheric_correction=f64(batch.photospheric_correction),
        file_sigmas=(tuple(f64(s) for s in batch.file_sigmas)
                     if batch.file_sigmas else None),
        molecule_rows=None if plan is None else _molecule_rows(plan, temps),
    )


def run_batch(plan: SimulationPlan, batch: BatchInputs, mesh=None, device="cuda",
              dtype=torch.float32, plain=False, timings=None):
    """Synthesize all atmospheres; returns F_nu [B, D, N].

    device, dtype : as run_simulation (the card in float32 by default; a
        CUDA device without a GPU raises); ``plain`` runs the kernels' plain
        torch versions.  ``timings`` receives the wall time of each stage.
    Stage 1 runs once for the batch: on the card, without autograd, as a
    replay of the CUDA graph captured for (plan, B, dtype, device) on the
    first such call (``captured_stage1``); under autograd, as a replay of
    its forward and backward graphs (``pipeline.CapturedStage1Grad``);
    on the CPU and on a mesh eagerly.
    F_nu carries gradients to ``batch.temperatures`` / ``batch.n_elem``
    when they are tensors that require grad (Kernels 1b and 2b take the
    whole batch in one launch each); the file-table cross-sections and the
    molecular rows are host arrays and, as the JAX package's file tables
    and molecular tables, carry none (the gradient reaches the file
    opacities through the species densities only).
    mesh : a ``parallel.sharding.Mesh``.  A 1-D 'batch' mesh cuts the
        models into contiguous chunks of ceil(B / n) (the JAX package needs
        B divisible by n), one per entry, with stage 1 and the spectrum on
        that entry's device; a ('batch', 'nu') mesh also splits each chunk's
        wavelength grid over its row (``shard_batch_spectrum``), stage 1
        running on each device of the row, each row on its models'
        molecular rows.  F_nu only, on the first device of the mesh this
        process holds; ``device`` is then not used.

    A plan with molecules takes each member's own K(T) and U(T) rows from
    ``batch.molecule_rows`` (``collect_batch_inputs`` evaluates them), so
    member b equals ``run_simulation`` of model b's own plan.
    Traced, the call is the root span "batch.run", over the stage spans.
    """
    with span("batch.run"):
        return _run_batch(plan, batch, mesh, device, dtype, plain, timings)


def _run_batch(plan, batch, mesh, device, dtype, plain, timings):
    if plan.molecule_tables is not None and batch.molecule_rows is None:
        raise ValueError("a batch of a plan with molecules needs its members' "
                         "molecule_rows (collect_batch_inputs, or "
                         "batch_from_reference(batch, plan))")
    correction = batch.photospheric_correction
    if correction is None and plan.inward_rays:
        raise ValueError("a spherical batch needs its per-model corrections")
    if mesh is not None:
        f_nu, _ = shard_tiles(
            plan, as_batch_nu(mesh), len(batch.temperatures),
            lambda m0, m1, consts, stage_t: _stage1(plan, batch, m0, m1, consts, dtype,
                                                    stage_t, _eager_stage1),
            dtype, ray_distances=batch.ray_distances, photospheric_correction=correction,
            file_sigmas=batch.file_sigmas, plain=plain, timings=timings)
        return f_nu
    device = resolve_device(device, "run_batch")
    with _batch_stage1(plan, batch, device, dtype, timings) as (consts, state, quants):
        with _stage(timings, "line_opacity", device):
            lines = prepare_lines(plan, state, quants, consts, batch.file_sigmas, plain)
        f_nu, *_ = spectrum_batch(
            plan, state, lines, consts,
            ray_distances=batch.ray_distances,
            photospheric_correction=correction,
            file_sigmas=batch.file_sigmas,
            plain=plain,
            timings=timings,
        )
    return f_nu


def make_batch_mesh(n_devices=None, devices=None):
    """1-D ``'batch'`` mesh: ``devices`` (which may repeat one device), or
    the first ``n_devices`` visible cards (default all of them)."""
    if devices is None:
        devices = visible_devices()[: n_devices or None]
    return Mesh(list(devices), ("batch",))


#: captured stage-1 graphs kept at once: each pins its memory pool (the
#: stage's outputs and workspace for its B models), which a compiled XLA
#: executable does not, so the cache stays small
STAGE1_CACHE_LIMIT = 4
# (id(plan), B, dtype, device) -> CapturedStage1.  id(plan) is a safe key:
# the entry holds its plan, so a live entry keeps the id from being reused;
# eviction drops the oldest entry, its graph and its pool together.
_STAGE1_CACHE = {}
_CACHE_LOCK = threading.Lock()


def captured_stage1(plan, n_models, dtype, device) -> CapturedStage1:
    """The cached CUDA graph of stage 1 for ``n_models`` models of ``plan``,
    captured (with the plan's device constants) on first use; creation is
    atomic, so concurrent callers share one capture."""
    key = (id(plan), n_models, dtype, torch.device(device))
    with _CACHE_LOCK:
        entry = _STAGE1_CACHE.get(key)
        if entry is None:
            if len(_STAGE1_CACHE) >= STAGE1_CACHE_LIMIT:
                _STAGE1_CACHE.pop(next(iter(_STAGE1_CACHE)))
            entry = _STAGE1_CACHE[key] = CapturedStage1(
                plan, device_constants(plan, dtype, device), n_models)
    return entry


# (id(plan), dtype, device) -> (plan, DeviceConstants) of differentiated
# batches on the card: their stage 1 replays the graphs captured for these
# constants, so a later batch finds those graphs rather than uploading the
# constants and capturing again; as many as the graphs kept
_GRAD_CONSTS = {}


def _grad_constants(plan, dtype, device):
    """The device constants that differentiated batches of ``plan`` share."""
    key = (id(plan), dtype, device)
    with _CACHE_LOCK:
        held = _GRAD_CONSTS.get(key)
        if held is None:
            if len(_GRAD_CONSTS) >= STAGE1_GRAD_CACHE_LIMIT:
                _GRAD_CONSTS.pop(next(iter(_GRAD_CONSTS)))
            held = _GRAD_CONSTS[key] = (plan, device_constants(plan, dtype, device))
    return held[1]


def _requires_grad(*inputs):
    return any(torch.is_tensor(x) and x.requires_grad for x in inputs)


@contextmanager
def _batch_stage1(plan, batch, device, dtype, timings):
    """(consts, state, quants) of the whole batch, valid inside the block:
    the cached CUDA graph replayed on the card (under its lock, which the
    block holds), ``stage_plasma_and_lines`` on the CPU or under autograd
    (which replays its own graphs on the card)."""
    n_models = len(batch.temperatures)
    if device.type != "cuda" or _requires_grad(batch.temperatures, batch.n_elem):
        consts = (_grad_constants if device.type == "cuda" else device_constants)(
            plan, dtype, device)
        yield (consts, *_stage1(plan, batch, 0, n_models, consts, dtype, timings))
        return
    graph = captured_stage1(plan, n_models, dtype, device)
    with graph.replay(batch.temperatures, batch.n_elem, batch.molecule_rows,
                      timings=timings) as (state, quants):
        with _stage(timings, "validate", device):
            validate_line_quants(quants)
        yield graph.consts, state, quants


def _stage1(plan, batch, m0, m1, consts, dtype, timings=None,
            stage1=stage_plasma_and_lines):
    """Stage 1 of the batch's models [m0, m1) on the device of ``consts``
    in one call of ``stage1`` (a mesh's threads pass the eager stage), and
    one finiteness check of their line quantities: (state, quants) with
    the model axis."""
    device = consts.tracing_nus.device
    with _stage(timings, "plasma_and_lines", device):
        temps, n_elem = (x[m0:m1] if torch.is_tensor(x)
                         else torch.as_tensor(x[m0:m1], device=device)
                         for x in (batch.temperatures, batch.n_elem))
        rows = batch.molecule_rows and tuple(
            torch.as_tensor(x[m0:m1], device=device).to(dtype) for x in batch.molecule_rows)
        state, quants = stage1(plan, temps.to(device, dtype), n_elem.to(device, dtype),
                               consts, rows)
    with _stage(timings, "validate", device):
        validate_line_quants(quants)
    return state, quants
