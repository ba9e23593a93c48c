"""Batched synthesis of many atmospheres on one device.

The port of ``stardis_tpu/parallel/batch.py`` (BASELINE.json config 5: a
Teff/logg grid of models).  All models of a batch share the config
(opacity sources, line window, theta count), the depth-point count and the
geometry kind; temperatures, densities, geometry, the spherical correction
and the file-opacity cross-sections vary per model.

Stage 1 (plasma and line quantities) and the continuum run model by model;
each kernel runs the whole batch in one launch (Kernel 1 once per line
set, Kernel 2 once), through the same ``pipeline.spectrum_batch`` that a
single ``run_stardis`` uses with a batch of one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..pipeline import (
    SimulationPlan,
    _stage,
    build_simulation_plan,
    device_constants,
    elemental_densities,
    file_cross_sections,
    model_geometry,
    not_ported,
    prepare_lines,
    resolve_device,
    spectrum_batch,
    stage_plasma_and_lines,
    validate_line_quants,
)
from ..radiation_field.solver import gauss_legendre_thetas


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
    # per-model file-opacity cross-sections, one [B, D, N] array per
    # plan.file_sources entry (same order), or None without file sources:
    # they depend on each model's temperatures
    file_sigmas: tuple | None = None


def make_batch(config, atom_data, stellar_models, tracing_nus_hz):
    """(template plan, BatchInputs) for a homogeneous model batch; the plan
    is built from the first model."""
    plan = build_simulation_plan(config, atom_data, stellar_models[0], tracing_nus_hz)
    return plan, collect_batch_inputs(config, stellar_models, plan)


def collect_batch_inputs(config, stellar_models, plan) -> BatchInputs:
    """Per-model arrays for an existing template plan."""
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
    file_sigmas = None
    if plan.file_sources:
        per_model = [
            dict(file_cross_sections(config.opacity.file, plan.tracing_nus, t))
            for t in temps
        ]
        file_sigmas = tuple(
            np.stack([sigmas[name] for sigmas in per_model])  # [B, D, N]
            for name, _sig, _dplan in plan.file_sources
        )
    return BatchInputs(
        temperatures=np.stack(temps),
        n_elem=np.stack(n_elem),
        ray_distances=np.stack(rays),
        photospheric_correction=np.asarray(corrs) if corrs else None,
        file_sigmas=file_sigmas,
    )


def batch_from_reference(batch) -> BatchInputs:
    """The port's BatchInputs from a ``stardis_tpu.parallel.batch
    .BatchInputs`` (its fields are NumPy arrays), in float64."""
    f64 = lambda x: None if x is None else np.asarray(x, dtype=np.float64)  # noqa: E731
    return BatchInputs(
        temperatures=f64(batch.temperatures),
        n_elem=f64(batch.n_elem),
        ray_distances=f64(batch.ray_distances),
        photospheric_correction=f64(batch.photospheric_correction),
        file_sigmas=(tuple(f64(s) for s in batch.file_sigmas)
                     if batch.file_sigmas else None),
    )


def run_batch(plan: SimulationPlan, batch: BatchInputs, mesh=None, device="cuda",
              dtype=torch.float32, plain=False, timings=None):
    """Synthesize all atmospheres; returns F_nu [B, D, N].

    device, dtype : as run_simulation (the card in float32 by default; a
        CUDA device without a GPU raises); ``plain`` runs the kernels' plain
        torch versions.  ``timings`` receives the wall time of each stage.
    F_nu carries gradients to ``batch.temperatures`` / ``batch.n_elem``
    when they are tensors that require grad (Kernels 1b and 2b take the
    whole batch in one launch each); the file-table cross-sections are host
    arrays and, as in the JAX package, carry none.
    mesh : not ported (multi-GPU, ROADMAP Queue 1).

    A plan with molecules raises: the JAX package's run_batch evaluates
    every member's molecular densities with the template model's K(T) and
    U(T) tables (ROADMAP Queue 3), and the port neither copies that nor
    departs from it silently.
    """
    if mesh is not None:
        raise not_ported("run_batch(mesh=)", "multi-GPU sharding")
    if plan.molecule_tables is not None:
        raise not_ported(
            "run_batch with molecules (per-model molecular tables)",
            "the JAX batch evaluates molecules at the template's temperatures",
            queue=3,
        )
    device = resolve_device(device, "run_batch")
    consts = device_constants(plan, dtype, device)
    states, quants = [], []
    with _stage(timings, "plasma_and_lines", device):
        temps = torch.as_tensor(batch.temperatures, device=device).to(dtype)
        n_elem = torch.as_tensor(batch.n_elem, device=device).to(dtype)
        for b in range(temps.shape[0]):
            state, lq = stage_plasma_and_lines(plan, temps[b], n_elem[b], consts)
            states.append(state)
            quants.append(lq)
    with _stage(timings, "validate", device):
        validate_line_quants({
            f"{key} (model {b})": triple
            for b, lq in enumerate(quants) if lq for key, triple in lq.items()
        })
    correction = batch.photospheric_correction
    if correction is None and plan.inward_rays:
        raise ValueError("a spherical batch needs its per-model corrections")
    with _stage(timings, "line_opacity", device):
        lines = prepare_lines(plan, states, quants, consts, batch.file_sigmas, plain)
    f_nu, *_ = spectrum_batch(
        plan, states, lines, consts,
        ray_distances=batch.ray_distances,
        photospheric_correction=correction,
        file_sigmas=batch.file_sigmas,
        plain=plain,
        timings=timings,
    )
    return f_nu
