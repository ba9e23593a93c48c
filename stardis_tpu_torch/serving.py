"""Serving: one plan, many requests (the port of ``stardis_tpu/serving.py``).

``SpectralService`` answers repeated synthesis requests (parameter scans,
MCMC fits, library generation) that share the config, the wavelength grid
and the depth count:

* the simulation plan (config, atom data, line selection, geometry kind)
  is built once, from the first request's model;
* the plan's constants are uploaded to the device once and stay there
  (``pipeline.DeviceConstants``: the plasma tables, the grid, and for
  each line set its frequencies and centre pixels, the constant part of
  Kernel 1's inputs); each request uploads its temperatures, densities
  and ray geometry, and its per-(line, depth) quantities come from its own
  stage 1;
* requests are held to the plan: depth count, geometry kind and
  microturbulence must match or the request raises;
* with file opacities (``opacity.file``), a request whose temperatures
  differ from the plan's gets its own rows of the plan's file tables
  (``FileTable.rows_at``, counted in ``stats.sigma_reinterp_events``),
  which the device expands;
* with molecules, a request whose temperatures differ from the plan's gets
  its molecular K(T) and U(T) rows evaluated on the host from the plan's
  samples (``MoleculeTables.rows_at``), as each batch member does: the
  JAX service serves every request with the plan model's tables, so its
  answer at other temperatures is not that model's run, where the port's
  is;
* spherical requests get their own chords, and the flux their own
  (r_outer / r_ref)^2 in place of the plan model's;
* ``I_nus`` is returned when the config tracks it
  (``result_options.return_radiation_field``);
* on the card, stage 1 is captured once per service in a CUDA graph
  (``pipeline.CapturedStage1``, the port of the JAX service's jitted
  stage 1) and each request replays it; with ``mesh=`` it runs eagerly;
* ``synthesize_batch`` goes through ``parallel.batch.run_batch`` (whose
  captured stage 1 is cached per plan and batch size);
* ``nu_segments`` K or ``"auto"`` serves through the serial wavelength
  segments of ``parallel.sharding.segmented_spectrum``; "auto" counts the
  service's captured graph's pool as fixed overhead, against the budget
  as it stood before the capture (``util.memory``).

The JAX service's refusal of file-table drift in a batch is never reached
(both its callers pass ``reject_file_drift=False``), so the port has none:
``run_batch`` takes each member's own sigma tables.

The JAX service freezes window tiers from its first request and compiles
against them, re-tiering when a request's windows outgrow them.  The port
has no window tiers and compiles nothing per plan: Kernel 1 reads each
request's exact windows, so ``tier_margin`` and ``chunk`` are not carried.
``compiles`` counts the plans built.  ``mesh=`` (a 1-D 'nu'
``parallel.sharding.Mesh``) serves each request through
``parallel.sharding.shard_spectrum``, with the request's own rays and sigma
tables; stage 1 runs on ``device``.
"""

from __future__ import annotations

import dataclasses
import logging
from contextlib import nullcontext

import numpy as np
import torch

from . import units as u
from .base import check_segments, parse_config_to_model, resolve_segments
from .pipeline import (
    C_AA_PER_S,
    CapturedStage1,
    build_simulation_plan,
    device_constants,
    elemental_densities,
    model_geometry,
    resolve_device,
    stage_plasma_and_lines,
    stage_spectrum,
    validate_line_quants,
)
from .radiation_field.solver import gauss_legendre_thetas
from .util.memory import segment_budget
from .util.profiling import span

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ServiceStats:
    requests: int = 0
    compiles: int = 0
    sigma_reinterp_events: int = 0


class SpectralService:
    """Repeated synthesis against one plan.

    config : dict or JSON (or YAML) path; tracing_lambdas_or_nus : Quantity
        (or frequencies in Hz); add_config_dict : dotted-key overrides;
        atom_data : optional AtomData replacing the one the config names.
    device, dtype : the card in float32 unless the caller asks otherwise;
        a CUDA device without a GPU raises.
    nu_segments : an integer K, or "auto" (the memory model, on the first
        request's plan; 1 with a mesh).
    mesh : a 1-D 'nu' ``parallel.sharding.Mesh``: each request's spectrum
        is sharded over it; exclusive with nu_segments > 1.
    """

    def __init__(self, config, tracing_lambdas_or_nus, add_config_dict=None,
                 device="cuda", dtype=torch.float32, mesh=None, nu_segments=1,
                 atom_data=None):
        check_segments(nu_segments, mesh)
        self._device = resolve_device(device, "SpectralService")
        from .util.compile_cache import enable_compilation_cache

        enable_compilation_cache()  # no-op unless STARDIS_COMPILE_CACHE is set
        self._dtype = dtype
        self._nu_segments = 1 if mesh is not None else nu_segments
        self._mesh = mesh
        self.stats = ServiceStats()
        self.config, self.atom_data, _model = parse_config_to_model(
            config, add_config_dict, atom_data=atom_data
        )
        q = tracing_lambdas_or_nus
        if hasattr(q, "to"):
            q = q.to(u.Hz, u.spectral())
        self._nus = np.atleast_1d(np.asarray(q, dtype=np.float64))
        self._thetas, _ = gauss_legendre_thetas(int(self.config.no_of_thetas))
        self._plan = None
        self._consts = None
        self._stage1 = None
        self._batch_plan = None

    def _build(self, stellar_model):
        with span("plan"):
            self._plan = build_simulation_plan(self.config, self.atom_data, stellar_model,
                                               self._nus)
        self._consts = device_constants(self._plan, self._dtype, self._device)
        # "auto" sizes the segments against the budget as it stood before
        # this service's graph, with the graph's pool as fixed overhead
        budget = segment_budget(self._device) if self._nu_segments == "auto" else None
        if self._device.type == "cuda" and self._mesh is None:
            self._stage1 = CapturedStage1(self._plan, self._consts)
        pool = self._stage1.pool_bytes if self._stage1 is not None else 0
        self._nu_segments = resolve_segments(self._nu_segments, self._plan, self._dtype,
                                             self._device, budget, pool)
        if self._nu_segments > 1:
            logger.info("serving through %d serial wavelength segments", self._nu_segments)
        self.stats.compiles += 1

    def _check_request(self, stellar_model, plan, label="this request"):
        """The quantities baked into the plan (depth count, geometry kind,
        microturbulence) must match the request's; returns its
        temperatures."""
        temps = np.asarray(stellar_model.temperatures, dtype=np.float64)
        if len(temps) != len(plan.temperatures):
            raise ValueError("all served models must share the plan's depth count")
        if bool(stellar_model.spherical) != bool(plan.inward_rays):
            raise ValueError(
                f"{label} geometry (spherical={bool(stellar_model.spherical)}) does not "
                f"match the plan (spherical={bool(plan.inward_rays)}); rebuild the service"
            )
        micro = stellar_model.microturbulence
        micro_cgs = float(micro.cgs.value) if hasattr(micro, "cgs") else float(micro)
        if getattr(self.config.opacity.line, "disable_microturbulence", False):
            micro_cgs = 0.0  # the plan bakes 0 when disabled
        if not np.isclose(micro_cgs, plan.microturbulence_cgs, rtol=1e-6, atol=1e-6):
            raise ValueError(
                f"microturbulence {micro_cgs} differs from the plan's "
                f"{plan.microturbulence_cgs} (baked per service); rebuild the service"
            )
        return temps

    def _file_sigmas_for(self, temps):
        """The request's file-opacity sigmas: the plan's when the
        temperatures match, else the rows of the plan's file tables at the
        request's temperatures (counted)."""
        plan = self._plan
        if not plan.file_sources:
            return None
        if np.allclose(temps, plan.temperatures, rtol=1e-12):
            return [sig for _name, sig, _dplan in plan.file_sources]
        self.stats.sigma_reinterp_events += 1
        return [table.rows_at(temps) for table in plan.file_tables]

    def _molecule_rows_for(self, temps):
        """The request's molecular K(T) and U(T) rows [M, D]: the plan's
        when the temperatures match, else evaluated at the request's; None
        without molecules."""
        mt = self._plan.molecule_tables
        if mt is None:
            return None
        if np.allclose(temps, self._plan.temperatures, rtol=1e-12):
            return mt.k_density, mt.partition_function
        return mt.rows_at(temps)

    def synthesize(self, stellar_model):
        """Emergent spectrum of one atmosphere: a dict of host arrays, nus /
        lambdas / F_nu [D, N] / spectrum_nu / spectrum_lambda, and I_nus
        [D, N, T] when tracked.  Traced, the request is the root span
        "serve.request" (its spans share its id): "serve.inputs" (the
        request's checks, sigma tables, molecular rows, geometry and
        densities on the host), "plasma_and_lines" (the copies in and stage
        1), "validate" (the host waits for the finiteness flags),
        "line_opacity", "continuum", "formal_solution" (the host enqueues
        them), "readback" (the host waits for F_nu and copies it)."""
        with span("serve.request"):
            return self._synthesize(stellar_model)

    def _synthesize(self, stellar_model):
        self.stats.requests += 1
        if self._plan is None:
            self._build(stellar_model)
        plan, consts = self._plan, self._consts
        with span("serve.inputs"):
            temps_np = self._check_request(stellar_model, plan)
            sigmas = self._file_sigmas_for(temps_np)
            rows = self._molecule_rows_for(temps_np)
            rays, _inward, correction = model_geometry(stellar_model, self._thetas)
            n_elem_np = elemental_densities(stellar_model, plan.tables)
        if self._stage1 is not None:
            stage1 = self._stage1.replay(temps_np, n_elem_np, rows)
        else:
            def upload(x):
                return torch.as_tensor(np.asarray(x, dtype=np.float64),
                                       device=self._device).to(self._dtype)

            with span("plasma_and_lines"):
                stage1 = nullcontext(stage_plasma_and_lines(
                    plan, upload(temps_np), upload(n_elem_np), consts,
                    None if rows is None else tuple(upload(x) for x in rows)))
        # a replayed graph's outputs are valid inside the block only
        with stage1 as (state, lq):
            with span("validate"):
                validate_line_quants(lq)
            f_nu, i_nus = self._spectrum(plan, consts, state, lq, rays, sigmas)
        with span("readback"):
            f_nu = f_nu.cpu().numpy()
            if plan.track_individual_intensities:
                i_nus = i_nus.cpu().numpy()
        if correction is not None and plan.photospheric_correction:
            # the spectrum carries the plan model's (r_outer / r_ref)^2; swap
            # in this model's (F only: the reference corrects the flux, not
            # the per-angle intensities)
            f_nu = f_nu * (correction / plan.photospheric_correction)

        lambdas = C_AA_PER_S / plan.tracing_nus
        surface = f_nu[-1]
        out = {
            "nus": plan.tracing_nus.copy(),
            "lambdas": lambdas,
            "F_nu": f_nu,
            "spectrum_nu": surface,
            "spectrum_lambda": surface * plan.tracing_nus / lambdas,
        }
        if plan.track_individual_intensities:
            out["I_nus"] = i_nus
        return out

    def _spectrum(self, plan, consts, state, lq, rays, sigmas):
        """(F_nu, I_nus or None) of one request's stage 1."""
        if self._mesh is not None:
            from .parallel.sharding import shard_spectrum

            out = shard_spectrum(plan, state, lq, self._mesh, consts, ray_distances=rays,
                                 file_sigma_override=sigmas)
            return out if plan.track_individual_intensities else (out, None)
        if self._nu_segments > 1:
            from .parallel.sharding import segmented_spectrum

            out = segmented_spectrum(plan, state, lq, self._nu_segments, consts,
                                     ray_distances=rays, file_sigma_override=sigmas)
            return out if plan.track_individual_intensities else (out, None)
        f_nu, _total, _opac, i_nus = stage_spectrum(
            plan, state, lq, consts, ray_distances=rays, file_sigmas=sigmas
        )
        return f_nu, i_nus

    def synthesize_batch(self, stellar_models):
        """F_nu [B, D, N] (host array) of a homogeneous list of models
        through ``run_batch``; the batch plan is built on the first call.
        Each model is held to ``synthesize``'s guards; per-model spherical
        corrections and file-opacity sigma tables go through run_batch."""
        from .parallel.batch import collect_batch_inputs, make_batch, run_batch

        if self._batch_plan is None:
            self._batch_plan, batch = make_batch(self.config, self.atom_data,
                                                 stellar_models, self._nus)
            self.stats.compiles += 1
        else:
            batch = collect_batch_inputs(self.config, stellar_models, self._batch_plan)
        for i, model in enumerate(stellar_models):
            self._check_request(model, self._batch_plan, label=f"batch model {i}")
        self.stats.requests += len(stellar_models)
        return run_batch(self._batch_plan, batch, device=self._device,
                         dtype=self._dtype).cpu().numpy()
