"""End-to-end simulation pipeline (PyTorch).

The port of ``stardis_tpu/pipeline.py``, single device:

1. ``build_simulation_plan`` — host phase (NumPy): config, model and atom
   data -> plasma tables, file-opacity tables (interpolated in wavelength
   once; a model's cross-sections are rows of them), selected atomic and
   molecular lines, molecular tables, quadrature and geometry
   (plane-parallel or spherical).
2. ``stage_plasma_and_lines`` — LTE solve + per-line alpha/gamma/Doppler
   for the "atomic" and "molecular" line sets, for a batch of models in
   one pass (its B models folded into B * D depth columns); on the card
   ``CapturedStage1`` keeps it as a CUDA graph that batches and services
   replay, and under autograd ``CapturedStage1Grad`` keeps its forward
   and backward as two graphs that the stage itself replays.
3. ``validate_line_quants`` — one finiteness flag, one host sync.
4. ``spectrum_batch`` — for a batch of models: continuum (one pass over
   the B * D columns), line
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
directly.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from contextlib import contextmanager

import numpy as np
import torch

from . import _cuda
from .constants import H_CGS
from .opacities import continuum as cont
from .opacities.file_tables import FileSigmaRows, read_file_table
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
    device_line_columns,
    prepare_line_data,
)
from .plasma.lte import DevicePlasmaTables, PlasmaState, device_tables, solve_lte
from .plasma.molecules import (
    DeviceMoleculeTables,
    MoleculeLineData,
    MoleculeSamples,
    MoleculeTables,
    build_molecule_tables,
    compute_molecule_line_quantities,
    device_molecule_lines,
    device_molecule_tables,
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
from .util import memory
from .util.profiling import span

logger = logging.getLogger(__name__)

#: speed of light in AA/s, for the file tables' wavelength grid
C_AA_PER_S = 2.99792458e18


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
    # [(name, sigma, SpeciesDensityPlan)]: sigma at the plan's temperatures,
    # FileSigmaRows [D] of the plan's file_tables entry (same order), or a
    # dense [D, N] array (a plan carried over from the JAX package)
    file_sources: list
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
    # FileTable per file_sources entry (same order); none for a plan carried
    # over from the JAX package, whose file_sources hold dense arrays
    file_tables: list = dataclasses.field(default_factory=list)


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


def build_simulation_plan(config, atom_data, stellar_model, tracing_nus_hz):
    """Host phase: MARCS models (plane-parallel or spherical), file,
    bf/ff/Rayleigh/Thomson continuum, TARDIS or VALD atomic lines,
    molecules and molecular lines, reference or accuracy window mode."""
    tracing_nus = np.sort(np.asarray(tracing_nus_hz, dtype=np.float64))[::-1].copy()
    temps = np.asarray(stellar_model.temperatures, dtype=np.float64)
    tables = build_plasma_tables(atom_data, stellar_model.composition.atomic_numbers)
    n_elem = elemental_densities(stellar_model, tables)

    opacity = config.opacity
    # each opacity.file table read once and interpolated at the grid's
    # wavelengths; the plan's sigma is its rows at the plan's temperatures
    file_tables = [read_file_table(fpath, name, C_AA_PER_S / tracing_nus)
                   for name, fpath in _cfg_dict(opacity.file).items()]
    file_sources = [
        (table.name, table.rows_at(temps), cont.plan_species_density(table.name, tables))
        for table in file_tables
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
        file_tables=file_tables,
    )


def _copy_fields(cls, obj, **given):
    """A ``cls`` dataclass from the same-named attributes of ``obj``, its
    float arrays in float64; ``given`` fields are taken as they are."""
    out = dict(given)
    for f in dataclasses.fields(cls):
        if f.name in given:
            continue
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            v = v.astype(np.float64)
        out[f.name] = v
    return cls(**out)


def _reference_samples(molecule_data, names):
    """MoleculeSamples of ``names`` from a ``stardis_tpu`` atom data's
    molecule_data (taken by duck typing: DataFrames of log10 K_p and U,
    one row per molecule, one column per sample temperature)."""
    eq, pf = molecule_data.equilibrium_constants, molecule_data.partition_functions
    return MoleculeSamples.from_samples(
        np.asarray(eq.columns.values, dtype=np.float64), eq.loc[list(names)].values,
        np.asarray(pf.columns.values, dtype=np.float64), pf.loc[list(names)].values)


def plan_from_reference(plan, atom_data=None) -> SimulationPlan:
    """The port's plan from a ``stardis_tpu.pipeline.SimulationPlan`` (taken
    by duck typing: its fields are NumPy arrays), in float64.

    atom_data : the ``stardis_tpu`` atom data the plan was built from; its
        molecule_data gives the molecular tables their K(T) / U(T) samples,
        which a batch or a served request at other temperatures evaluates
        (``MoleculeTables.rows_at``).  Without it the tables carry none."""
    f64 = lambda x: np.asarray(x, dtype=np.float64)  # noqa: E731
    maybe = lambda cls, obj: None if obj is None else _copy_fields(cls, obj)  # noqa: E731
    correction = plan.photospheric_correction
    molecule_tables = None
    if plan.molecule_tables is not None:
        mt = plan.molecule_tables
        samples = (None if atom_data is None or atom_data.molecule_data is None
                   else _reference_samples(atom_data.molecule_data, mt.names))
        molecule_tables = _copy_fields(MoleculeTables, mt, samples=samples)
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
        molecule_tables=molecule_tables,
        molecule_line_data=maybe(MoleculeLineData, plan.molecule_line_data),
        molecules_coupled=bool(plan.molecules_coupled),
    )


# ----------------------------------------------------------------------
# device stages
# ----------------------------------------------------------------------

@contextmanager
def _stage(timings, name, device):
    """A stage: its span (``util.profiling.span``), and when ``timings`` is
    a dict its wall time, the device synchronised at both edges (the span
    then covers what the wall time does)."""
    if timings is None:
        with span(name):
            yield
        return
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    with span(name):
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize(device)
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


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
    run builds them once, ``serving.SpectralService`` once per service, a
    captured stage 1 (``CapturedStage1``) holds its own.  Stage 1 reads
    nothing else, so it uploads nothing."""

    tables: DevicePlasmaTables
    tracing_nus: torch.Tensor  # [N] Hz, descending
    grid: torch.Tensor  # [N] tracing_nus minus the middle frequency nu_ref
    lines: dict  # line-set key -> (line nu - nu_ref [L], center pixels [L])
    # line-set key -> its per-line columns: "atomic" DeviceLineColumns,
    # "molecular" DeviceMoleculeLines
    line_columns: dict = dataclasses.field(default_factory=dict)
    molecules: DeviceMoleculeTables | None = None
    bf: tuple | None = None  # (level_flat [K] int64, cutoffs [K], coefficients [K])
    ff: tuple | None = None  # (slots [M] int64, ion numbers [M])
    # per plan.file_tables entry, its g [K, N] (the table interpolated at
    # the grid's wavelengths), which rows of file sigmas expand
    file_tables: tuple = ()


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
    line_columns = {}
    if "atomic" in lines:
        line_columns["atomic"] = device_line_columns(plan.line_data, dtype, device)
    if "molecular" in lines:
        line_columns["molecular"] = device_molecule_lines(plan.molecule_line_data, dtype,
                                                          device)
    molecules = None
    if plan.molecule_tables is not None:
        molecules = device_molecule_tables(plan.molecule_tables,
                                           len(plan.tables.slot_element), dtype, device)
    bf = ff = None
    if plan.bf is not None and len(plan.bf.level_flat):
        bf = (torch.as_tensor(plan.bf.level_flat, device=device),
              _tensor(plan.bf.cutoff_frequencies, like), _tensor(plan.bf.coefficients, like))
    if len(plan.ff_slots):
        ff = (torch.as_tensor(plan.ff_slots, device=device), _tensor(plan.ff_ion_numbers, like))
    return DeviceConstants(
        tables=device_tables(plan.tables, dtype=dtype, device=device),
        tracing_nus=_tensor(plan.tracing_nus, like),
        grid=_tensor(plan.tracing_nus - nu_ref, like),
        lines=lines,
        line_columns=line_columns,
        molecules=molecules,
        bf=bf,
        ff=ff,
        file_tables=tuple(_tensor(table.g, like) for table in plan.file_tables),
    )


#: stage 1's depth columns are padded to a multiple of this: the widest
#: vectorised loop of the CPU (4 accumulators of 16 float32 lanes)
COLUMN_BLOCK = 64


def padded_columns(n_cols, device):
    """Indices of ``n_cols`` depth columns padded with copies of the last
    one to a multiple of COLUMN_BLOCK: the layout stage 1 solves in."""
    return torch.arange(-(-n_cols // COLUMN_BLOCK) * COLUMN_BLOCK,
                        device=device).clamp_(max=n_cols - 1)


def _split_models(x, n_models):
    """[..., B * D] columns -> [B, ..., D], a view."""
    return x.unflatten(-1, (n_models, -1)).movedim(-2, 0)


def _fold_columns(x, cols):
    """[B, R, D] per-model rows -> [R, B * D] model-major columns, taken at
    ``cols``: the layout stage 1 solves in."""
    x = x.transpose(0, 1).clone(memory_format=torch.contiguous_format)
    return x.view(x.shape[0], -1)[:, cols]


def stage_plasma_and_lines(plan: SimulationPlan, temps, n_elem, consts, molecule_rows=None):
    """LTE solve + per-line quantities on the device of ``temps``, for a
    batch of models in one pass (the port of ``jax.vmap`` of the JAX
    package's stage 1).

    temps : [B, D] K, or [D] for one model
    n_elem : [B, E, D] (or [E, D]) elemental number densities
    consts : the plan's DeviceConstants (``device_constants``): the plasma
        tables and each line set's per-line columns, so the stage uploads
        nothing and syncs nothing with the host (a CUDA graph can capture
        it: ``CapturedStage1``)
    molecule_rows : (K(T), U(T)) tensors of temps' device and dtype,
        [B, M, D] (or [M, D]): each model's molecular tables at its own
        temperatures (``MoleculeTables.rows_at``).  Without them the stage
        reads the plan's tables (``consts.molecules``), which hold the plan
        model's; a batch of B > 1 models with molecular lines needs them.
    Returns (state, quants): the PlasmaState with the leading model axis
    [B, ...] (none for one model), and quants mapping "atomic" /
    "molecular" to the (alpha, gamma, doppler) triple of that line set,
    each [B, L, D] (or [L, D]), or None when no lines are configured.

    The B models are folded into B * D depth columns, since every step is
    per column and the tables are shared: the stage launches the same
    operations for any B, and its outputs are views of [.., B * D]
    planes.  The columns are padded to a multiple of COLUMN_BLOCK, so
    that every one of them takes the same path through the CPU's
    vectorised loops (which round a tail of columns otherwise, in another
    order), and a model's results have the same bits in any batch.  The
    molecular rows are folded into the same columns.

    On one CUDA device with autograd on and an input that requires grad
    (outside a capture of the current stream, and without anomaly
    detection, whose checks read the device), the stage replays its
    forward and backward from CUDA graphs captured for these inputs
    (``CapturedStage1Grad``, under the span "plasma_and_lines"): the same
    operations on the same inputs, so the same bits.  Everywhere else it
    runs eagerly.
    """
    inputs = (temps, n_elem, *(molecule_rows or ()))
    if not _replays_grad_graph(inputs, consts):
        return _stage_plasma_and_lines(plan, temps, n_elem, consts, molecule_rows)
    with span("plasma_and_lines"):
        entry = captured_stage1_grad(plan, consts, inputs)
        state, quants = _unflatten(_Stage1GradReplay.apply(entry, *inputs), entry.keys)
    return _model_views(state, quants, temps)


def _stage_plasma_and_lines(plan, temps, n_elem, consts, molecule_rows=None):
    """``stage_plasma_and_lines`` run eagerly, op by op."""
    return _model_views(*_stage1_columns(plan, temps, n_elem, consts, molecule_rows), temps)


def _stage1_columns(plan, temps, n_elem, consts, molecule_rows):
    """Stage 1 in the layout it solves in: (state, quants) as
    ``stage_plasma_and_lines`` returns them, each field a plane over the
    padded B * D depth columns."""
    if temps.ndim == 1:
        temps, n_elem = temps[None], n_elem[None]
        if molecule_rows is not None:
            molecule_rows = tuple(x[None] for x in molecule_rows)
    n_models = temps.shape[0]
    # model-major columns: column b * D + d is depth d of model b, padded
    # with copies of the last one to a multiple of COLUMN_BLOCK
    t = temps.reshape(-1)
    cols = padded_columns(t.shape[0], t.device)
    t = t[cols]
    state = solve_lte(t, _fold_columns(n_elem, cols), consts.tables)
    quants = {}
    if "atomic" in consts.line_columns:
        quants["atomic"] = compute_line_quantities(
            consts.line_columns["atomic"],
            state,
            t,
            plan.microturbulence_cgs,
            plan.broadening_flags,
            use_vald_broadening=plan.use_vald_broadening,
        )
    if "molecular" in consts.line_columns:
        molecules = consts.molecules
        if molecule_rows is not None:
            k, u_mol = (_fold_columns(x, cols) for x in molecule_rows)
        elif n_models == 1:  # the plan's [M, D] tables, of its own model
            k, u_mol = molecules.k[:, cols], molecules.u_mol[:, cols]
        else:
            raise ValueError(
                f"stage 1 of {n_models} models with molecular lines needs each model's "
                "molecule_rows (MoleculeTables.rows_at of its temperatures): the plan's "
                "tables hold its own model's K(T) and U(T)"
            )
        quants["molecular"] = compute_molecule_line_quantities(
            consts.line_columns["molecular"],
            molecules._replace(k=k, u_mol=u_mol),
            state,
            t,
            plan.microturbulence_cgs,
            plan.broadening_flags,
            coupled=plan.molecules_coupled,
        )
    return state, quants


def _model_views(state, quants, temps):
    """Stage 1's planes over the padded columns as the models' views:
    [B, ...], or without the model axis for 1-D ``temps``."""
    single = temps.ndim == 1
    n_models, n_cols = 1 if single else temps.shape[0], temps.numel()
    state = PlasmaState(*(_split_models(x[..., :n_cols], n_models) for x in state))
    quants = {key: tuple(_split_models(x[..., :n_cols], n_models) for x in triple)
              for key, triple in quants.items()}
    if single:
        state = PlasmaState(*(x[0] for x in state))
        quants = {key: tuple(x[0] for x in triple) for key, triple in quants.items()}
    return state, (quants or None)


def _flatten(state, quants):
    """(state, quants) -> (the list of their tensors, the line-set keys)."""
    return [*state, *(x for triple in quants.values() for x in triple)], tuple(quants)


def _unflatten(tensors, keys):
    n = len(PlasmaState._fields)
    state = PlasmaState(*tensors[:n])
    return state, {key: tuple(tensors[n + 3 * i:n + 3 * i + 3]) for i, key in enumerate(keys)}


def _replays_grad_graph(inputs, consts):
    """Whether ``stage_plasma_and_lines`` on ``inputs`` (temps, n_elem and
    the molecular rows) replays a CapturedStage1Grad: autograd on, an
    input that requires grad, every input and the constants on one CUDA
    device, no capture under way on its current stream, no anomaly
    detection."""
    if not torch.is_grad_enabled() or torch.is_anomaly_enabled():
        return False
    if not all(torch.is_tensor(x) for x in inputs) or not any(x.requires_grad for x in inputs):
        return False
    device = inputs[0].device
    if device.type != "cuda" or consts.tracing_nus.device != device:
        return False
    if any(x.device != device for x in inputs):
        return False
    with torch.cuda.device(device):
        return not torch.cuda.is_current_stream_capturing()


#: warm-up calls of stage 1 on a side stream before a capture, as
#: PyTorch's CUDA-graph documentation asks
CAPTURE_WARMUP = 3


def _warm_up(step):
    """``step()`` CAPTURE_WARMUP times on a side stream, ordered after the
    current stream's work and before its next."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(CAPTURE_WARMUP):
            step()
    torch.cuda.current_stream().wait_stream(side)


def _pool_bytes(graph):
    """(bytes, free bytes) of a captured graph's private memory pool, read
    from one ``torch.cuda.memory_snapshot()``: the free blocks are those
    no tensor holds, which no other allocation can use."""
    pool = tuple(graph.pool())
    segments = [seg for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", ())) == pool]
    return (sum(seg["total_size"] for seg in segments),
            sum(seg["total_size"] - seg["allocated_size"] for seg in segments))


class CapturedStage1:
    """``stage_plasma_and_lines`` of ``n_models`` models (None: one model,
    1-D inputs) captured once in a CUDA graph and replayed: the port of the
    JAX package's compiled stage 1 kept across calls (``jax.jit`` of its
    vmapped stage in ``parallel.batch.run_batch``, of its stage in each
    ``SpectralService``).

    The graph reads the plan's DeviceConstants (``consts``, held here with
    the plan) and static input buffers: the temperatures and densities, and
    with molecular lines each model's K(T) and U(T) rows; its outputs are fixed tensors
    of its private memory pool (``pool_bytes``), overwritten by each
    replay.  ``replay`` copies the inputs in and yields the outputs under
    the graph's own lock, so the caller consumes them (validates them,
    prepares Kernel 1's inputs, runs the spectrum) before another thread
    can replay.  The capture registers its pool with the memory model
    (``util.memory.register_pool``) for as long as it lives.  A failed
    capture or replay raises; nothing falls back to the eager stage.  CUDA
    only, and without autograd: a differentiated stage 1 replays its own
    graphs (``CapturedStage1Grad``).  ``captures`` and ``replays`` count
    both in the process (``util.profiling.counters``)."""

    captures = 0
    replays = 0

    def __init__(self, plan: SimulationPlan, consts: DeviceConstants, n_models=None):
        device = consts.tracing_nus.device
        if device.type != "cuda":
            raise ValueError(f"a captured stage 1 needs a CUDA device, not {device}")
        self.plan, self.consts, self.n_models = plan, consts, n_models
        dtype = consts.tracing_nus.dtype
        lead = () if n_models is None else (n_models,)
        # static inputs, allocated before the capture; the warm-up runs on
        # the plan's own model
        self._temps = torch.empty(lead + plan.temperatures.shape, dtype=dtype, device=device)
        self._n_elem = torch.empty(lead + plan.n_elem.shape, dtype=dtype, device=device)
        self._temps.copy_(torch.as_tensor(plan.temperatures))
        self._n_elem.copy_(torch.as_tensor(plan.n_elem))
        self._rows = None
        if "molecular" in consts.line_columns:
            mt = plan.molecule_tables
            self._rows = tuple(
                torch.empty(lead + x.shape, dtype=dtype, device=device).copy_(
                    torch.as_tensor(x))
                for x in (mt.k_density, mt.partition_function))
        self._lock = threading.Lock()
        with torch.no_grad(), torch.cuda.device(device):
            _warm_up(lambda: _stage_plasma_and_lines(plan, self._temps, self._n_elem, consts,
                                                     self._rows))
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph, capture_error_mode="thread_local"):
                self._out = _stage_plasma_and_lines(plan, self._temps, self._n_elem, consts,
                                                    self._rows)
            torch.cuda.synchronize()
        self.device = device
        # the pool's free blocks: a replay allocates nothing and the outputs
        # stay held, so both counts hold while the graph lives
        self.pool_bytes, self.pool_free_bytes = _pool_bytes(self._graph)
        memory.register_pool(self)
        _cuda.count(CapturedStage1, "captures")

    @contextmanager
    def replay(self, temps, n_elem, molecule_rows=None, timings=None):
        """Replay on ``temps`` ([B, D], or [D]), ``n_elem`` and, for a plan
        with molecular lines, ``molecule_rows`` (K(T) and U(T), [B, M, D] or
        [M, D]: ``MoleculeTables.rows_at`` of the temperatures); host arrays
        or tensors, copied into the static buffers.  Yields (state, quants)
        as ``stage_plasma_and_lines`` returns them, valid inside the block
        only.  ``timings`` receives the wall time of the copies and the
        replay as "plasma_and_lines"."""
        if self._rows is not None and molecule_rows is None:
            raise ValueError("a captured stage 1 with molecular lines replays on each "
                             "model's molecule_rows")
        with self._lock:
            with _stage(timings, "plasma_and_lines", self._temps.device), torch.no_grad():
                self._temps.copy_(torch.as_tensor(temps))
                self._n_elem.copy_(torch.as_tensor(n_elem))
                for buf, rows in zip(self._rows or (), molecule_rows or ()):
                    buf.copy_(torch.as_tensor(rows))
                self._graph.replay()
                _cuda.count(CapturedStage1, "replays")
            yield self._out


class CapturedStage1Grad:
    """``stage_plasma_and_lines`` under autograd, its forward and its
    backward captured once in two CUDA graphs that share one private
    memory pool, and replayed through one ``torch.autograd.Function``:
    a differentiated stage 1 (a gradient fit's step, ``run_batch`` on
    temperatures that require grad) launches two graphs where it
    dispatched its operations, and their backward, one by one.

    ``stage_plasma_and_lines`` captures one for each (plan, device
    constants, the inputs' shapes and dtypes, which of them require grad,
    molecular rows or none, device) on its first differentiated call on
    the card (``captured_stage1_grad``; at most STAGE1_GRAD_CACHE_LIMIT
    live, as each pins its pool).  The graphs read the constants and
    static input buffers; the forward graph writes the planes of
    ``_stage1_columns`` and what its backward reads, and the backward
    graph (``torch.autograd.grad`` with the graph retained, so that it
    can run more than once) the gradients of the inputs that require
    grad.  A forward replay copies the inputs in and hands back copies of
    the planes, with their shapes and strides, which the caller owns and
    the next replay leaves alone.  A backward replays its graph while no
    later forward has replayed over what it reads; one that comes later
    (two forwards, then their backwards) runs its own forward again
    eagerly from its saved inputs and differentiates that.  The copies
    and replays run on the caller's current stream; a lock orders the
    replays of several threads.

    The mesh paths (``parallel.sharding``: one host thread per device,
    device constants built per call) keep the eager stage.  The capture
    registers its pool with the memory model (``util.memory
    .register_pool``) for as long as it lives.  ``captures``, ``replays``
    (forward replays) and ``stale_backwards`` (backwards run again
    eagerly) count in the process (``util.profiling.counters``)."""

    captures = 0
    replays = 0
    stale_backwards = 0

    def __init__(self, plan: SimulationPlan, consts: DeviceConstants, inputs):
        device = inputs[0].device
        self.plan, self.consts, self.device = plan, consts, device
        self._requires = tuple(x.requires_grad for x in inputs)
        self._lock = threading.Lock()
        self._generation = 0
        with torch.cuda.device(device), torch.enable_grad():
            # static inputs, allocated before the capture; the warm-up runs
            # on the caller's inputs
            self._inputs = tuple(
                torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x.detach())
                .requires_grad_(r) for x, r in zip(inputs, self._requires))
            wrt = [x for x in self._inputs if x.requires_grad]

            def forward_and_backward():
                outputs = [o for o in self._planes(self._inputs)[0] if o.requires_grad]
                torch.autograd.grad(outputs, wrt, [torch.zeros_like(o) for o in outputs],
                                    allow_unused=True)

            _warm_up(forward_and_backward)
            fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            with torch.cuda.graph(fwd, capture_error_mode="thread_local"):
                planes, self.keys = self._planes(self._inputs)
            self.differentiable = tuple(o.requires_grad for o in planes)
            diff = [o for o in planes if o.requires_grad]
            self._grad_outputs = tuple(torch.empty_like(o) for o in diff)
            with torch.cuda.graph(bwd, pool=fwd.pool(), capture_error_mode="thread_local"):
                grads = iter(torch.autograd.grad(diff, wrt, self._grad_outputs,
                                                 retain_graph=True, allow_unused=True))
            torch.cuda.synchronize()
        self._grad_inputs = tuple(next(grads) if r else None for r in self._requires)
        # the outputs without the capture's autograd graph, which goes now:
        # the blocks of what it saved stay in the pool, where the forward
        # graph writes them and the backward graph reads them
        self._outputs = tuple(o.detach() for o in planes)
        del planes, diff
        self._fwd, self._bwd = fwd, bwd
        self.pool_bytes, self.pool_free_bytes = _pool_bytes(fwd)
        memory.register_pool(self)
        _cuda.count(CapturedStage1Grad, "captures")

    def _planes(self, inputs):
        """The eager stage's planes on ``inputs`` and its line-set keys."""
        return _flatten(*_stage1_columns(self.plan, inputs[0], inputs[1], self.consts,
                                         tuple(inputs[2:]) or None))

    def forward(self, inputs):
        """Replay the forward graph on ``inputs``: (copies of its outputs,
        the replay's generation)."""
        with self._lock:
            for buf, x in zip(self._inputs, inputs):
                buf.copy_(x)
            self._fwd.replay()
            self._generation += 1
            _cuda.count(CapturedStage1Grad, "replays")
            return [o.clone() for o in self._outputs], self._generation

    def backward(self, generation, inputs, grads):
        """The gradients of ``inputs`` (None where one does not require
        grad) from ``grads``, those of the outputs of the forward replay
        ``generation`` (None: zero), which ran on ``inputs``."""
        with self._lock:
            if generation == self._generation:
                given = (g for g, d in zip(grads, self.differentiable) if d)
                for buf, g in zip(self._grad_outputs, given):
                    if g is None:
                        buf.zero_()
                    else:
                        buf.copy_(g)
                self._bwd.replay()
                return tuple(None if g is None else g.clone() for g in self._grad_inputs)
        _cuda.count(CapturedStage1Grad, "stale_backwards")
        with torch.enable_grad():
            leaves = tuple(x.detach().requires_grad_(r) for x, r in zip(inputs, self._requires))
            pairs = [(o, g) for o, g in zip(self._planes(leaves)[0], grads)
                     if g is not None and o.requires_grad]
            wrt = [x for x in leaves if x.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                           allow_unused=True) if pairs else [None] * len(wrt))
        return tuple(next(got) if r else None for r in self._requires)


class _Stage1GradReplay(torch.autograd.Function):
    """A CapturedStage1Grad's replays as one node of the caller's autograd
    graph: forward(entry, temps, n_elem, *molecule rows) -> copies of its
    planes."""

    @staticmethod
    def forward(ctx, entry, *inputs):
        outputs, ctx.generation = entry.forward(inputs)
        ctx.entry = entry
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(
            *(o for o, d in zip(outputs, entry.differentiable) if not d))
        return tuple(outputs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return (None, *ctx.entry.backward(ctx.generation, ctx.saved_tensors, grads))


#: differentiated stage-1 graphs kept at once: each pins its memory pool
#: (the planes, what the backward reads, the workspace of both)
STAGE1_GRAD_CACHE_LIMIT = 4
# (id(plan), id(consts), device, each input's shape, dtype and whether it
# requires grad) -> CapturedStage1Grad.  The ids are safe keys: the entry
# holds its plan and constants, so a live entry keeps them from being
# reused; eviction drops the oldest entry, its graphs and its pool.
_STAGE1_GRAD_CACHE = {}
_GRAD_CACHE_LOCK = threading.Lock()


def captured_stage1_grad(plan, consts, inputs) -> CapturedStage1Grad:
    """The cached CapturedStage1Grad for ``inputs`` (temps, n_elem and the
    molecular rows), captured on first use; creation is atomic, so
    concurrent callers share one capture."""
    key = (id(plan), id(consts), inputs[0].device,
           tuple((tuple(x.shape), x.dtype, x.requires_grad) for x in inputs))
    with _GRAD_CACHE_LOCK:
        entry = _STAGE1_GRAD_CACHE.get(key)
        if entry is None:
            if len(_STAGE1_GRAD_CACHE) >= STAGE1_GRAD_CACHE_LIMIT:
                _STAGE1_GRAD_CACHE.pop(next(iter(_STAGE1_GRAD_CACHE)))
            entry = _STAGE1_GRAD_CACHE[key] = CapturedStage1Grad(plan, consts, inputs)
    return entry


def model_axis(states, line_quants=None):
    """(state, quants) with the leading model axis: a batched stage-1
    result as it is, a single model's (1-D temperatures) with an axis of
    one, a list of per-model results stacked."""
    if isinstance(states, PlasmaState):
        state = states if states.t.ndim == 2 else PlasmaState(*(x[None] for x in states))
    else:
        state = PlasmaState(*(_stack(fields) for fields in zip(*states)))
    if isinstance(line_quants, (list, tuple)):
        quants = line_quants[0] and {
            key: tuple(_stack([q[key][i] for q in line_quants]) for i in range(3))
            for key in line_quants[0]
        }
    else:
        quants = line_quants and {
            key: tuple(x if x.ndim == 3 else x[None] for x in triple)
            for key, triple in line_quants.items()
        }
    return state, (quants or None)


def column_state(state):
    """A batched PlasmaState [B, ...] as B * D depth columns [..., B * D]:
    a view for ``stage_plasma_and_lines``' own output."""
    return PlasmaState(*(x.movedim(0, -2).flatten(-2) for x in state))


def validate_line_quants(line_quants):
    """NaN/inf line quantities abort the run: one reduction, one host sync.
    [B, L, D] arrays name the models at fault."""
    if not line_quants:
        return
    names, flags = [], []
    for key, triple in line_quants.items():
        for field, arr in zip(("alpha", "gamma", "doppler"), triple):
            ok = torch.isfinite(arr)
            flags.append(ok.flatten(1).all(dim=1) if arr.ndim == 3 else ok.all()[None])
            names.append((key, field, arr.ndim == 3))
    flags = torch.stack(flags).cpu()  # [sets x 3, B]
    bad = [
        f"{key}{f' (model {b})' if batched else ''}:{field}"
        for (key, field, batched), ok in zip(names, flags)
        for b in np.flatnonzero(~ok.numpy())
    ]
    if bad:
        raise ValueError(
            f"Some line quantities ({', '.join(bad)}) are nan, inf, -inf. "
            "Something went wrong!"
        )


def compute_continuum(plan: SimulationPlan, state, tracing_nus, consts, file_sigmas=None,
                      pixels=slice(None)):
    """All continuum sources -> dict of [D, n] tensors over ``tracing_nus``,
    per depth column: a batch passes its B * D columns (``column_state``).

    file_sigmas: optional, one per plan.file_sources entry, replacing the
    plan's (a batch member's own temperatures): FileSigmaRows of the depth
    columns, which the device expands from the plan's file tables
    (``consts.file_tables``), or dense [D, N] host arrays, copied to it.
    pixels: the columns of the global grid that ``tracing_nus`` holds; the
    file sigmas are cut to them.
    consts: the plan's DeviceConstants (its bf and ff columns, its file
    tables)."""
    n_nu = tracing_nus.shape[0]
    t = state.t
    out = {}
    for i, (name, sig, dplan) in enumerate(plan.file_sources):
        density = cont.species_density(dplan, state, plan.tables)
        sig = sig if file_sigmas is None else file_sigmas[i]
        repeats = t.shape[0] // len(sig)  # the plan's D columns for each of B models
        if isinstance(sig, FileSigmaRows):
            out[f"alpha_file_{name}"] = _alpha_file_rows(consts, i, sig, repeats, density,
                                                         pixels)
            continue
        sig = _tensor(np.asarray(sig)[:, pixels], t)
        _cuda.count(FileSigmaCounts, "uploads")
        if repeats > 1:
            sig = sig.repeat(repeats, 1)
        out[f"alpha_file_{name}"] = cont.calc_alpha_file(sig, density)

    if consts.bf is not None:
        level_flat, cutoffs, coefficients = consts.bf
        # the bf (D,K)x(K,N) product runs in full float32 on the card,
        # its backward too (util.matmul)
        out["alpha_bf"] = cont.calc_alpha_bf_hydrogenic(
            tracing_nus, state.level_number_density[level_flat], cutoffs, coefficients)

    if consts.ff is not None:
        slots, ion_numbers = consts.ff
        out["alpha_ff"] = cont.calc_alpha_ff_hydrogenic(
            tracing_nus,
            state.ion_number_density[slots],
            ion_numbers,
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


class FileSigmaCounts:
    """The continuum's file-opacity terms in the process
    (``util.profiling.counters``): ``rows``, tables expanded on the device
    from FileSigmaRows; ``uploads``, dense sigma arrays copied to it."""

    rows = 0
    uploads = 0


def _alpha_file_rows(consts, i, rows, repeats, density, pixels):
    """alpha_file [C, n] of plan.file_sources entry ``i`` from its rows of
    the C depth columns (the plan's D, ``repeats`` times, for B models):
    one copy of the rows to the device, the expansion there."""
    if i >= len(consts.file_tables):
        raise ValueError("rows of file sigmas need the plan's file tables; a plan "
                         "carried over from the JAX package takes dense arrays")
    packed = rows.packed()
    packed = torch.as_tensor(np.tile(packed, repeats) if repeats > 1 else packed,
                             device=density.device)
    # the factor (1e-26 k_B T ~5e-39 for H- ff) is subnormal in float32:
    # fold it into the density in float64, a normal number of the run's dtype
    scaled = (density.double() * packed[2]).to(density.dtype)
    _cuda.count(FileSigmaCounts, "rows")
    return cont.calc_alpha_file_rows(consts.file_tables[i][:, pixels], packed[0].long(),
                                     packed[1].to(density.dtype), scaled)


def model_sigmas(file_sigmas):
    """One model's file sigmas (per plan.file_sources entry, FileSigmaRows
    [D] or a [D, N] array) with the model axis of a batch of one."""
    if file_sigmas is None:
        return None
    return [s[None] if isinstance(s, FileSigmaRows) else np.asarray(s)[None]
            for s in file_sigmas]


def _stack(tensors):
    """torch.stack, without the copy for a batch of one."""
    return tensors[0][None] if len(tensors) == 1 else torch.stack(tensors)


def continuum_batch(plan: SimulationPlan, states, tracing_nus, consts, file_sigmas=None,
                    pixels=slice(None)):
    """Every continuum source of each model over ``tracing_nus`` (the
    columns ``pixels`` of the global grid), in one pass over the batch's
    B * D depth columns: dict of [B, D, n] tensors.
    states: a batched stage-1 state, or one per model (``model_axis``)
    consts: the plan's DeviceConstants
    file_sigmas: per plan.file_sources entry, FileSigmaRows [B, D] or a
    [B, D, N] host array"""
    state, _ = model_axis(states)
    n_models, n_depth = state.t.shape
    n_cols = n_models * n_depth
    sigmas = None if file_sigmas is None else [
        sig.reshape(n_cols) if isinstance(sig, FileSigmaRows)
        else np.asarray(sig).reshape(n_cols, -1) for sig in file_sigmas]
    out = compute_continuum(plan, column_state(state), tracing_nus, consts, sigmas, pixels)
    return {key: val.view(n_models, n_depth, -1) for key, val in out.items()}


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
    file_sigmas : per plan.file_sources entry, FileSigmaRows [B, D] or a
        [B, D, N] host array."""
    epsilon = None
    for a, b in ranges or [(0, consts.grid.shape[0])]:
        total = None
        for val in continuum_batch(plan, states, consts.tracing_nus[a:b], consts, file_sigmas,
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

    states, line_quants : the batch's stage 1 (``stage_plasma_and_lines``
        of [B, D] temperatures), or one result per model (``model_axis``)
    file_sigmas, ranges : as ``accuracy_epsilon``, which the accuracy
        window mode reads
    plain : prepare for the plain torch version on any device
    """
    state, quants = model_axis(states, line_quants)
    out = []
    n_nu = consts.grid.shape[0]
    epsilon = (accuracy_epsilon(plan, state, consts, file_sigmas, ranges)
               if plan.window_mode == "accuracy" else None)
    for key, label in LINE_SETS:
        if not quants or key not in quants:
            continue
        alpha, gamma, doppler = quants[key]  # [B, L, D]
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

    states : the batch's stage-1 state (or one per model: ``model_axis``)
    lines : ``prepare_lines``' result for these models (shared by the
        ranges of a segmented run)
    consts : the plan's DeviceConstants (``device_constants``)
    ray_distances : [B, G, T] host array; default the plan's, for each model
    photospheric_correction : [B] host array, a number, or None (none)
    file_sigmas : per plan.file_sources entry, FileSigmaRows [B, D] or a
        [B, D, N] host array; default the plan's, for each model
    plain : run Kernel 2's plain torch version on any device (Kernel 1's
        follows ``prepare_lines(plain=)``): the reference the kernels are
        checked against
    pixels : (a, b), the pixel range [a, b) of the grid to synthesize;
        default the whole grid
    returns F_nu [B, D, n], total [B, D, n], opacities (each [B, ...]),
        I_nus [B, D, n, T] or None, over the n pixels of the range
    """
    state, _ = model_axis(states)
    t0 = state.t
    n_models = t0.shape[0]
    a, b = (0, consts.grid.shape[0]) if pixels is None else pixels
    tracing_nus = consts.tracing_nus[a:b]
    with _stage(timings, "continuum", t0.device):
        opacities = continuum_batch(plan, state, tracing_nus, consts, file_sigmas,
                                    slice(a, b))

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
        source = blackbody_flux_at_nu(tracing_nus, t0[..., None])  # [B, D, n]
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
    file_sigmas : per plan.file_sources entry, FileSigmaRows [D] or a [D, N]
        host array replacing the plan's (a served request's own temperatures)
    """
    sigmas = model_sigmas(file_sigmas)
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
                   plain=False, timings=None, nu_segments=1, mesh=None):
    """Both device stages; returns (F_nu, totals, opacities, I_nus, state).

    device, dtype : the card in float32 unless asked otherwise; a CUDA
        device without a GPU raises
    nu_segments : K > 1 runs the spectrum as K pixel ranges one after
        another (``parallel.sharding.segmented_spectrum``): totals and
        opacities are then host NumPy arrays when the plan tracks I_nu
        (``result_options.return_radiation_field``), else None and {}
    mesh : a 'nu' ``parallel.sharding.Mesh``: stage 1 runs on ``device``,
        the spectrum sharded over the mesh
        (``parallel.sharding.shard_spectrum``); totals and opacities are
        None and {}
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
    if mesh is not None:
        from .parallel.sharding import shard_spectrum

        out = shard_spectrum(plan, state, line_quants, mesh, consts, plain=plain,
                             timings=timings)
        f_nu, i_nus = out if plan.track_individual_intensities else (out, None)
        return f_nu, None, {}, i_nus, state
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
