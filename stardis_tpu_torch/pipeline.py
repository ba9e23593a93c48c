"""End-to-end simulation pipeline (PyTorch).

The port of ``stardis_tpu/pipeline.py``, single device:

1. ``build_simulation_plan`` — host phase (NumPy): config, model and atom
   data -> plasma tables, file-opacity cross-sections, selected atomic and
   molecular lines, molecular tables, quadrature and geometry
   (plane-parallel or spherical).
2. ``stage_plasma_and_lines`` — LTE solve + per-line alpha/gamma/Doppler
   for the "atomic" and "molecular" line sets.
3. ``validate_line_quants`` — one finiteness flag, one host sync.
4. ``spectrum_batch`` — for a batch of models: continuum, line
   accumulation (Kernel 1, once per line set for the whole batch, in the
   reference or the accuracy window mode), blackbody source, formal
   solution (Kernel 2, once for the whole batch) -> F_nu.  A single run
   (``stage_spectrum``) is a batch of one.  It runs on a pixel range of
   the grid too: ``parallel.sharding.segmented_spectrum`` runs the grid as
   K such ranges, one after another, to bound device memory.

Entry points run on the card (``device="cuda"``, float32) unless the
caller asks for the CPU; ``resolve_device`` raises when no GPU is present.

The JAX package's window tiers (``line_window_tiers``) are a TPU schedule
and have no counterpart: Kernel 1 takes the per-(line, depth) windows
directly.  Branches the port does not take yet raise NotImplementedError
naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from contextlib import contextmanager

import numpy as np
import torch

from .constants import H_CGS
from .opacities import continuum as cont
from .opacities.file_tables import sigma_file
from .opacities.line_kernel import (
    grid_min_step,
    line_center_indices,
    line_opacity_range,
    prepare_line_opacity,
    window_half_widths,
)
from .opacities.lines import (
    LineData,
    compute_line_quantities,
    prepare_line_data,
)
from .plasma.lte import DevicePlasmaTables, device_tables, solve_lte
from .plasma.molecules import (
    MoleculeLineData,
    MoleculeTables,
    build_molecule_tables,
    compute_molecule_line_quantities,
    prepare_molecule_line_data,
)
from .plasma.tables import PlasmaTables, build_plasma_tables
from .radiation_field.blackbody import blackbody_flux_at_nu
from .radiation_field.solver import (
    calculate_spherical_ray,
    gauss_legendre_thetas,
    raytrace,
    raytrace_plain,
)

logger = logging.getLogger(__name__)

#: speed of light in AA/s, for the file tables' wavelength grid
C_AA_PER_S = 2.99792458e18


def not_ported(what, roadmap_item, queue=1):
    return NotImplementedError(
        f"{what} is not ported to stardis_tpu_torch yet "
        f"(ROADMAP.md Queue {queue}: {roadmap_item})"
    )


def resolve_device(device, caller):
    """``device`` as a torch.device; a CUDA device without a GPU raises
    (the entry points never fall back to the CPU on their own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller}(device='cuda'): no CUDA device is available; "
            "pass device='cpu' (with dtype=torch.float64) to run on the CPU"
        )
    return device


@dataclasses.dataclass
class BFSpecies:
    cutoff_frequencies: np.ndarray  # [K] Hz
    level_flat: np.ndarray  # [K] flat level indices
    ion_numbers: np.ndarray  # [K]
    coefficients: np.ndarray  # [K] f32-safe BF coefficients (host f64)


@dataclasses.dataclass
class SimulationPlan:
    """Host (NumPy, float64) inputs of the device stages."""

    tracing_nus: np.ndarray  # [N] descending Hz
    tables: PlasmaTables
    temperatures: np.ndarray  # [D]
    n_elem: np.ndarray  # [E, D]
    microturbulence_cgs: float
    file_sources: list  # [(name, sigmas [D, N], SpeciesDensityPlan)]
    bf: BFSpecies | None
    ff_slots: np.ndarray  # [M]
    ff_ion_numbers: np.ndarray  # [M]
    rayleigh_species: list
    disable_electron_scattering: bool
    line_data: LineData | None
    broadening_flags: tuple
    use_vald_broadening: bool
    ray_distances: np.ndarray  # [G, T]
    weights: np.ndarray  # [T]
    inward_rays: bool
    photospheric_correction: float | None
    track_individual_intensities: bool = False
    d_nu: float = 0.0
    window_mode: str = "reference"
    window_epsilon: float = 1e-4
    molecule_tables: MoleculeTables | None = None
    molecule_line_data: MoleculeLineData | None = None
    molecules_coupled: bool = False


def _cfg_dict(node):
    return node.to_dict() if hasattr(node, "to_dict") else dict(node)


def model_geometry(stellar_model, thetas):
    """(ray_distances [G, T], inward_rays, photospheric_correction) of one
    model: chords through the shells and (r_outer / r_ref)^2 for a
    spherical model, dr / cos(theta) and no correction otherwise."""
    r = np.asarray(stellar_model.geometry.r, dtype=np.float64)
    if stellar_model.spherical:
        ref_r = float(np.asarray(stellar_model.geometry.reference_r))
        return calculate_spherical_ray(thetas, r), True, float((r[-1] / ref_r) ** 2)
    return np.diff(r)[:, None] / np.cos(thetas)[None, :], False, None


def elemental_densities(stellar_model, tables):
    """[E, D] elemental number densities, rows in the tables' sorted-Z
    order."""
    comp = stellar_model.composition
    row = {int(z): i for i, z in enumerate(comp.atomic_numbers)}
    return comp.elemental_number_density[[row[int(z)] for z in tables.zs]]


def file_cross_sections(opacity_files, tracing_nus, temperatures):
    """[(name, sigma [D, N])] of the configured ``opacity.file`` tables."""
    lambdas_aa = C_AA_PER_S / np.asarray(tracing_nus)
    return [
        (name, sigma_file(lambdas_aa, temperatures, fpath, name))
        for name, fpath in _cfg_dict(opacity_files).items()
    ]


def build_simulation_plan(config, atom_data, stellar_model, tracing_nus_hz):
    """Host phase: MARCS models (plane-parallel or spherical), file,
    bf/ff/Rayleigh/Thomson continuum, TARDIS or VALD atomic lines,
    molecules and molecular lines, reference or accuracy window mode."""
    tracing_nus = np.sort(np.asarray(tracing_nus_hz, dtype=np.float64))[::-1].copy()
    temps = np.asarray(stellar_model.temperatures, dtype=np.float64)
    tables = build_plasma_tables(atom_data, stellar_model.composition.atomic_numbers)
    n_elem = elemental_densities(stellar_model, tables)

    opacity = config.opacity
    file_sources = [
        (name, sig, cont.plan_species_density(name, tables))
        for name, sig in file_cross_sections(opacity.file, tracing_nus, temps)
    ]

    # --- hydrogenic bf ------------------------------------------------
    bf = None
    bf_cfg = _cfg_dict(opacity.bf)
    if bf_cfg:
        cutoffs, flats, ions = [], [], []
        for spec in bf_cfg:
            plan = cont.plan_species_density(spec + "_bf", tables)
            z, ion = plan.atomic_number, plan.ion_number
            chi_ion = atom_data.ionization_energy(z, ion + 1)
            for (lz, lion, lnum), flat in tables.level_flat_index.items():
                if lz == z and lion == ion:
                    e_level = tables.level_energy[flat]
                    cutoffs.append((chi_ion - e_level) / H_CGS)
                    flats.append(flat)
                    ions.append(ion)
        bf = BFSpecies(
            cutoff_frequencies=np.asarray(cutoffs, dtype=np.float64),
            level_flat=np.asarray(flats, dtype=np.int64),
            ion_numbers=np.asarray(ions, dtype=np.float64),
            coefficients=cont.bf_level_coefficients(cutoffs, ions),
        )

    # --- hydrogenic ff ------------------------------------------------
    ff_slots, ff_ions = [], []
    for spec in _cfg_dict(opacity.ff):
        plan = cont.plan_species_density(spec + "_ff", tables)
        ff_slots.append(plan.slot)
        ff_ions.append(plan.ion_number)

    # --- lines --------------------------------------------------------
    line_cfg = opacity.line
    line_data = None
    use_vald = False
    if not line_cfg.disable:
        use_vald = line_cfg.vald_linelist.use_linelist
        line_data = prepare_line_data(
            atom_data,
            tables,
            tracing_nus.min(),
            tracing_nus.max(),
            use_vald=use_vald,
            drop_autoionization=not line_cfg.vald_linelist.use_vald_broadening,
        )
        logger.info("Selected %d lines in the tracing window", line_data.n_lines)

    # --- molecules ----------------------------------------------------
    molecule_tables = None
    molecule_line_data = None
    if not line_cfg.disable and line_cfg.include_molecules:
        molecule_tables = build_molecule_tables(atom_data, tables, temps)
        if use_vald and atom_data.linelist_molecules is not None:
            molecule_line_data = prepare_molecule_line_data(
                atom_data, molecule_tables, tracing_nus.min(), tracing_nus.max()
            )
            logger.info("Selected %d molecular lines", molecule_line_data.n_lines)

    # --- geometry / quadrature ----------------------------------------
    thetas, weights = gauss_legendre_thetas(int(config.no_of_thetas))
    ray_distances, inward_rays, correction = model_geometry(stellar_model, thetas)

    micro = stellar_model.microturbulence
    micro_cgs = float(micro.cgs.value) if hasattr(micro, "cgs") else float(micro)
    if getattr(line_cfg, "disable_microturbulence", False):
        micro_cgs = 0.0

    return SimulationPlan(
        tracing_nus=tracing_nus,
        tables=tables,
        temperatures=temps,
        n_elem=n_elem,
        microturbulence_cgs=micro_cgs,
        file_sources=file_sources,
        bf=bf,
        ff_slots=np.asarray(ff_slots, dtype=np.int64),
        ff_ion_numbers=np.asarray(ff_ions, dtype=np.float64),
        rayleigh_species=list(opacity.rayleigh),
        disable_electron_scattering=bool(opacity.disable_electron_scattering),
        line_data=line_data,
        broadening_flags=tuple(line_cfg.broadening),
        use_vald_broadening=bool(
            use_vald and line_cfg.vald_linelist.use_vald_broadening
        ) if not line_cfg.disable else False,
        ray_distances=ray_distances,
        weights=weights,
        inward_rays=inward_rays,
        photospheric_correction=correction,
        track_individual_intensities=bool(
            config.result_options.return_radiation_field
        ),
        d_nu=grid_min_step(tracing_nus),
        window_mode=str(line_cfg.get("window_mode", "reference")),
        window_epsilon=float(line_cfg.get("window_epsilon", 1e-4)),
        molecule_tables=molecule_tables,
        molecule_line_data=molecule_line_data,
        molecules_coupled=bool(line_cfg.get("molecules_coupled", False)),
    )


def _copy_fields(cls, obj):
    """A ``cls`` dataclass from the same-named attributes of ``obj``, its
    float arrays in float64."""
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            v = v.astype(np.float64)
        out[f.name] = v
    return cls(**out)


def plan_from_reference(plan) -> SimulationPlan:
    """The port's plan from a ``stardis_tpu.pipeline.SimulationPlan`` (taken
    by duck typing: its fields are NumPy arrays), in float64."""
    f64 = lambda x: np.asarray(x, dtype=np.float64)  # noqa: E731
    maybe = lambda cls, obj: None if obj is None else _copy_fields(cls, obj)  # noqa: E731
    correction = plan.photospheric_correction
    return SimulationPlan(
        tracing_nus=f64(plan.tracing_nus),
        tables=_copy_fields(PlasmaTables, plan.tables),
        temperatures=f64(plan.temperatures),
        n_elem=f64(plan.n_elem),
        microturbulence_cgs=float(plan.microturbulence_cgs),
        file_sources=[
            (name, f64(sig), _copy_fields(cont.SpeciesDensityPlan, dplan))
            for name, sig, dplan in plan.file_sources
        ],
        bf=maybe(BFSpecies, plan.bf),
        ff_slots=np.asarray(plan.ff_slots, dtype=np.int64),
        ff_ion_numbers=f64(plan.ff_ion_numbers),
        rayleigh_species=list(plan.rayleigh_species),
        disable_electron_scattering=bool(plan.disable_electron_scattering),
        line_data=maybe(LineData, plan.line_data),
        broadening_flags=tuple(plan.broadening_flags),
        use_vald_broadening=bool(plan.use_vald_broadening),
        ray_distances=f64(plan.ray_distances),
        weights=f64(plan.weights),
        inward_rays=bool(plan.inward_rays),
        photospheric_correction=None if correction is None else float(correction),
        track_individual_intensities=bool(plan.track_individual_intensities),
        d_nu=float(plan.d_nu),
        window_mode=str(plan.window_mode),
        window_epsilon=float(plan.window_epsilon),
        molecule_tables=maybe(MoleculeTables, plan.molecule_tables),
        molecule_line_data=maybe(MoleculeLineData, plan.molecule_line_data),
        molecules_coupled=bool(plan.molecules_coupled),
    )


# ----------------------------------------------------------------------
# device stages
# ----------------------------------------------------------------------

@contextmanager
def _stage(timings, name, device):
    """Record the wall time of a stage (synchronising the device at its
    end) when ``timings`` is a dict; a no-op otherwise."""
    if timings is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


@contextmanager
def _full_float32_matmul():
    """Matrix products in full float32, not TF32, inside the block only:
    the previous setting comes back afterwards."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def host_array(tensor, what):
    """``tensor`` as a host NumPy array.  A tensor that carries a gradient
    raises instead: the copy would silently cut the autograd graph."""
    if tensor.requires_grad:
        raise RuntimeError(
            f"{what} copies results to the host as NumPy arrays, which carry no "
            "gradient; under autograd call the device stages instead "
            "(stage_plasma_and_lines, stage_spectrum, spectrum_batch, run_batch, "
            "or segmented_spectrum without collect_opacities)"
        )
    return tensor.cpu().numpy()


def _tensor(x, like):
    """Host float64 array -> tensor of ``like``'s dtype and device."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=like.device).to(like.dtype)


@dataclasses.dataclass
class DeviceConstants:
    """The plan's request-independent device tensors, uploaded once
    (``device_constants``) and shared by every stage that reads them: a
    run builds them once, ``serving.SpectralService`` once per service."""

    tables: DevicePlasmaTables
    tracing_nus: torch.Tensor  # [N] Hz, descending
    grid: torch.Tensor  # [N] tracing_nus minus the middle frequency nu_ref
    lines: dict  # line-set key -> (line nu - nu_ref [L], center pixels [L])


def device_constants(plan: SimulationPlan, dtype, device) -> DeviceConstants:
    """Upload the plan's constants.  The line sum sees the grid only
    through dnu = grid - line_nu; shifting both by the grid's middle
    frequency in float64 before the cast removes the float32 cancellation
    of two ~4.5e14 Hz values (ulp ~3e7 Hz, ~4% of a 0.01 AA pixel).  Every
    pixel range of a segmented run uses this one global shift, so float32
    rounds as in the unsegmented run."""
    device = torch.device(device)
    like = torch.empty(0, dtype=dtype, device=device)
    nu_ref = float(plan.tracing_nus[len(plan.tracing_nus) // 2])
    line_data = {"atomic": plan.line_data, "molecular": plan.molecule_line_data}
    lines = {
        key: (_tensor(ld.nu - nu_ref, like),
              torch.as_tensor(line_center_indices(plan.tracing_nus, ld.nu),
                              device=device).to(torch.int32))
        for key, ld in line_data.items() if ld is not None and ld.n_lines > 0
    }
    return DeviceConstants(
        tables=device_tables(plan.tables, dtype=dtype, device=device),
        tracing_nus=_tensor(plan.tracing_nus, like),
        grid=_tensor(plan.tracing_nus - nu_ref, like),
        lines=lines,
    )


def stage_plasma_and_lines(plan: SimulationPlan, temps, n_elem, consts):
    """LTE solve + per-line quantities on the device of ``temps``.

    consts : the plan's DeviceConstants (``device_constants``; its plasma
        tables)
    Returns (state, quants): quants maps "atomic" / "molecular" to the
    (alpha, gamma, doppler) triple of that line set, or is None when no
    lines are configured.
    """
    state = solve_lte(temps, n_elem, consts.tables)
    quants = {}
    if plan.line_data is not None and plan.line_data.n_lines > 0:
        quants["atomic"] = compute_line_quantities(
            plan.line_data,
            state,
            temps,
            plan.microturbulence_cgs,
            plan.broadening_flags,
            use_vald_broadening=plan.use_vald_broadening,
        )
    mld = plan.molecule_line_data
    if mld is not None and mld.n_lines > 0:
        quants["molecular"] = compute_molecule_line_quantities(
            mld,
            plan.molecule_tables,
            state,
            temps,
            plan.microturbulence_cgs,
            plan.broadening_flags,
            coupled=plan.molecules_coupled,
        )
    return state, (quants or None)


def validate_line_quants(line_quants):
    """NaN/inf line quantities abort the run: one reduction, one host sync."""
    if not line_quants:
        return
    arrays = [arr for triple in line_quants.values() for arr in triple]
    flags = torch.stack([torch.isfinite(arr).all() for arr in arrays]).cpu()
    if not bool(flags.all()):
        names = list(line_quants.keys())
        bad = flags.reshape(len(names), 3)
        detail = ", ".join(
            f"{names[i]}:{'alpha gamma doppler'.split()[j]}"
            for i in range(bad.shape[0])
            for j in range(3)
            if not bad[i, j]
        )
        raise ValueError(
            f"Some line quantities ({detail}) are nan, inf, -inf. "
            "Something went wrong!"
        )


def compute_continuum(plan: SimulationPlan, state, tracing_nus, file_sigmas=None,
                      pixels=slice(None)):
    """All continuum sources -> dict of [D, n] tensors over ``tracing_nus``.

    file_sigmas: optional [D, N] host arrays, one per plan.file_sources
    entry, replacing the plan's (a batch member's own temperatures).
    pixels: the columns of the global grid that ``tracing_nus`` holds; the
    file sigmas are cut to them."""
    n_nu = tracing_nus.shape[0]
    t = state.t
    out = {}
    for i, (name, sig, dplan) in enumerate(plan.file_sources):
        density = cont.species_density(dplan, state, plan.tables)
        sig = sig if file_sigmas is None else file_sigmas[i]
        out[f"alpha_file_{name}"] = cont.calc_alpha_file(_tensor(sig[:, pixels], t), density)

    if plan.bf is not None and len(plan.bf.level_flat):
        level_densities = state.level_number_density[
            torch.as_tensor(plan.bf.level_flat, device=t.device)
        ]
        # the bf (D,K)x(K,N) product runs in full float32 on the card
        with _full_float32_matmul():
            out["alpha_bf"] = cont.calc_alpha_bf_hydrogenic(
                tracing_nus,
                level_densities,
                _tensor(plan.bf.cutoff_frequencies, t),
                _tensor(plan.bf.coefficients, t),
            )

    if len(plan.ff_slots):
        ion_densities = state.ion_number_density[
            torch.as_tensor(plan.ff_slots, device=t.device)
        ]
        out["alpha_ff"] = cont.calc_alpha_ff_hydrogenic(
            tracing_nus,
            ion_densities,
            _tensor(plan.ff_ion_numbers, t),
            state.electron_densities,
            t,
        )

    if plan.rayleigh_species:
        densities = {}
        for name in plan.rayleigh_species:
            if name == "H":
                densities["H"] = state.ion_number_density[plan.tables.slot_of(1, 0)]
            elif name == "He":
                densities["He"] = state.ion_number_density[plan.tables.slot_of(2, 0)]
            elif name == "H2":
                densities["H2"] = state.h2_density
        out["alpha_rayleigh"] = cont.calc_alpha_rayleigh(tracing_nus, densities)

    out["alpha_electron"] = cont.calc_alpha_electron(
        state.electron_densities, n_nu, disable=plan.disable_electron_scattering
    )
    return out


def _stack(tensors):
    """torch.stack, without the copy for a batch of one."""
    return tensors[0][None] if len(tensors) == 1 else torch.stack(tensors)


def continuum_batch(plan: SimulationPlan, states, tracing_nus, file_sigmas=None,
                    pixels=slice(None)):
    """Every continuum source of each model over ``tracing_nus`` (the
    columns ``pixels`` of the global grid): dict of [B, D, n] tensors.
    file_sigmas: per plan.file_sources entry, a [B, D, N] host array."""
    continua = [
        compute_continuum(plan, state, tracing_nus,
                          None if file_sigmas is None else [sig[b] for sig in file_sigmas],
                          pixels)
        for b, state in enumerate(states)
    ]
    # pop as it stacks, so each source is held once, not per model and stacked
    return {key: _stack([c.pop(key) for c in continua]) for key in list(continua[0])}


def accuracy_epsilon(plan, states, consts, file_sigmas=None, ranges=None):
    """Per-depth absolute truncation threshold [1/cm] of the accuracy
    window mode, [B, D]: epsilon_rel times the minimum over the grid of
    each model's total continuum extinction (summed in the continuum
    dict's order), so wing truncation is bounded relative to the local
    continuum whatever dominates it.

    A continuum-only pass over the pixel ranges ``ranges`` (default the
    whole grid as one), keeping the minimum of each range's minimum: equal
    to the whole grid's (a minimum does not depend on the order), with one
    range's continuum on the device at a time.
    file_sigmas : per plan.file_sources entry, a [B, D, N] host array."""
    epsilon = None
    for a, b in ranges or [(0, consts.grid.shape[0])]:
        total = None
        for val in continuum_batch(plan, states, consts.tracing_nus[a:b], file_sigmas,
                                   slice(a, b)).values():
            total = val if total is None else total + val
        part = plan.window_epsilon * torch.amin(total, dim=-1)
        epsilon = part if epsilon is None else torch.minimum(epsilon, part)
    return epsilon


#: the line sets and the opacity keys their sums go under
LINE_SETS = (("atomic", "alpha_line_at_nu"), ("molecular", "molecule_alpha_line_at_nu"))


def prepare_lines(plan: SimulationPlan, states, line_quants, consts, file_sigmas=None,
                  plain=False, ranges=None):
    """Kernel 1's inputs for every line set of a batch, prepared once for
    any number of pixel ranges: [(opacity key, LineOpacityInputs, gamma,
    doppler)].  The half-windows are clamped at the global grid's size
    and read the global centres, so a window edge falls on the same pixel
    whatever range evaluates it.

    states, line_quants : one stage-1 result per model
    file_sigmas, ranges : as ``accuracy_epsilon``, which the accuracy
        window mode reads
    plain : prepare for the plain torch version on any device
    """
    out = []
    n_nu = consts.grid.shape[0]
    epsilon = (accuracy_epsilon(plan, states, consts, file_sigmas, ranges)
               if plan.window_mode == "accuracy" else None)
    for key, label in LINE_SETS:
        if not line_quants[0] or key not in line_quants[0]:
            continue
        alpha, gamma, doppler = (
            _stack([q[key][i] for q in line_quants]) for i in range(3)
        )  # [B, L, D]
        line_nu, centers = consts.lines[key]
        iw = window_half_widths(alpha, gamma, doppler, plan.d_nu, n_nu,
                                plan.window_mode, epsilon)
        prepared = prepare_line_opacity(consts.grid, line_nu, centers, alpha, gamma,
                                        doppler, iw, plain=plain)
        out.append((label, prepared, gamma, doppler))
    return out


def spectrum_batch(plan: SimulationPlan, states, lines, consts, ray_distances=None,
                   photospheric_correction=None, file_sigmas=None, plain=False,
                   timings=None, pixels=None):
    """Opacities + formal solution for a batch of models that share the
    plan's grid, lines and configuration.

    states : one stage-1 state per model
    lines : ``prepare_lines``' result for these models (shared by the
        ranges of a segmented run)
    consts : the plan's DeviceConstants (``device_constants``)
    ray_distances : [B, G, T] host array; default the plan's, for each model
    photospheric_correction : [B] host array, a number, or None (none)
    file_sigmas : per plan.file_sources entry, a [B, D, N] host array
    plain : run Kernel 2's plain torch version on any device (Kernel 1's
        follows ``prepare_lines(plain=)``): the reference the kernels are
        checked against
    pixels : (a, b), the pixel range [a, b) of the grid to synthesize;
        default the whole grid
    returns F_nu [B, D, n], total [B, D, n], opacities (each [B, ...]),
        I_nus [B, D, n, T] or None, over the n pixels of the range
    """
    t0 = states[0].t
    n_models = len(states)
    a, b = (0, consts.grid.shape[0]) if pixels is None else pixels
    tracing_nus = consts.tracing_nus[a:b]
    with _stage(timings, "continuum", t0.device):
        opacities = continuum_batch(plan, states, tracing_nus, file_sigmas, slice(a, b))

    with _stage(timings, "line_opacity", t0.device):
        for label, prepared, gamma, doppler in lines:
            opacities[label] = line_opacity_range(prepared, a, b - a)
            opacities[label + "_gammas"] = gamma
            opacities[label + "_doppler_widths"] = doppler

    with _stage(timings, "formal_solution", t0.device):
        total = None
        for key, val in opacities.items():
            if "gammas" in key or "doppler" in key:
                continue
            total = val if total is None else total + val
        source = _stack([blackbody_flux_at_nu(tracing_nus, s.t) for s in states])
        if ray_distances is None:
            ray_distances = np.repeat(plan.ray_distances[None], n_models, axis=0)
        trace = raytrace_plain if plain else raytrace
        f_nu, i_nus = trace(
            total,
            source,
            _tensor(ray_distances, t0),
            _tensor(plan.weights, t0),
            inward_rays=plan.inward_rays,
            photospheric_correction=photospheric_correction,
            track_individual_intensities=plan.track_individual_intensities,
        )
    return f_nu, total, opacities, i_nus


def stage_spectrum(plan: SimulationPlan, state, line_quants, consts, plain=False,
                   timings=None, ray_distances=None, file_sigmas=None):
    """Opacities + formal solution of one model -> (F_nu, total, opacities,
    I_nus): ``prepare_lines`` and ``spectrum_batch`` on a batch of one.

    consts : the plan's DeviceConstants (``device_constants``)
    ray_distances : [G, T] host array replacing the plan's (a served
        request's own geometry)
    file_sigmas : per plan.file_sources entry, a [D, N] host array
        replacing the plan's (a served request's own temperatures)
    """
    sigmas = None if file_sigmas is None else [np.asarray(s)[None] for s in file_sigmas]
    with _stage(timings, "line_opacity", state.t.device):
        lines = prepare_lines(plan, [state], [line_quants], consts, sigmas, plain)
    f_nu, total, opacities, i_nus = spectrum_batch(
        plan, [state], lines, consts,
        ray_distances=None if ray_distances is None else np.asarray(ray_distances)[None],
        photospheric_correction=plan.photospheric_correction,
        file_sigmas=sigmas, plain=plain, timings=timings,
    )
    return (f_nu[0], total[0], {k: v[0] for k, v in opacities.items()},
            None if i_nus is None else i_nus[0])


def run_simulation(plan: SimulationPlan, device="cuda", dtype=torch.float32,
                   plain=False, timings=None, nu_segments=1):
    """Both device stages; returns (F_nu, totals, opacities, I_nus, state).

    device, dtype : the card in float32 unless asked otherwise; a CUDA
        device without a GPU raises
    nu_segments : K > 1 runs the spectrum as K pixel ranges one after
        another (``parallel.sharding.segmented_spectrum``): totals and
        opacities are then host NumPy arrays when the plan tracks I_nu
        (``result_options.return_radiation_field``), else None and {}
    timings : optional dict that receives the wall time of each stage
        (the device is synchronised around each)."""
    device = resolve_device(device, "run_simulation")
    consts = device_constants(plan, dtype, device)
    with _stage(timings, "plasma_and_lines", device):
        temps = torch.as_tensor(plan.temperatures, device=device).to(dtype)
        n_elem = torch.as_tensor(plan.n_elem, device=device).to(dtype)
        state, line_quants = stage_plasma_and_lines(plan, temps, n_elem, consts)
    with _stage(timings, "validate", device):
        validate_line_quants(line_quants)
    if int(nu_segments) > 1:
        from .parallel.sharding import segmented_spectrum

        collect = plan.track_individual_intensities
        out = segmented_spectrum(plan, state, line_quants, int(nu_segments), consts,
                                 collect_opacities=collect, plain=plain, timings=timings)
        if collect:
            f_nu, i_nus, opacities, total = out
        else:
            f_nu, i_nus, opacities, total = out, None, {}, None
        return f_nu, total, opacities, i_nus, state
    f_nu, total, opacities, i_nus = stage_spectrum(
        plan, state, line_quants, consts, plain=plain, timings=timings
    )
    return f_nu, total, opacities, i_nus, state
