# Frozen copy of stardis_tpu_torch/pipeline.py at commit 9c7d618, cut to the host plan,
# stage 1 (eager) and the continuum: part of the benchmark's reference.  Keep it as it is.
"""The host plan, stage 1 and the continuum of one or more models, as the
program's ``pipeline.py`` ran them at commit 9c7d618 (no CUDA graph, no
kernel).  ``reference.spectrum`` builds the line sum and the formal
solution at chosen pixels on top of these."""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from .constants import H_CGS
from .opacities import continuum as cont
from .opacities.file_tables import sigma_file
from .opacities.line_kernel import grid_min_step, line_center_indices
from .opacities.lines import LineData, compute_line_quantities, device_line_columns, prepare_line_data
from .plasma.lte import DevicePlasmaTables, PlasmaState, device_tables, solve_lte
from .plasma.molecules import (
    DeviceMoleculeTables,
    MoleculeLineData,
    MoleculeTables,
    build_molecule_tables,
    compute_molecule_line_quantities,
    device_molecule_lines,
    device_molecule_tables,
    prepare_molecule_line_data,
)
from .plasma.tables import PlasmaTables, build_plasma_tables
from .radiation_field.solver import calculate_spherical_ray, gauss_legendre_thetas

logger = logging.getLogger(__name__)

#: speed of light in AA/s, for the file tables' wavelength grid
C_AA_PER_S = 2.99792458e18

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
    """
    single = temps.ndim == 1
    if single:
        temps, n_elem = temps[None], n_elem[None]
        if molecule_rows is not None:
            molecule_rows = tuple(x[None] for x in molecule_rows)
    n_models = temps.shape[0]
    # model-major columns: column b * D + d is depth d of model b, padded
    # with copies of the last one to a multiple of COLUMN_BLOCK
    t = temps.reshape(-1)
    n_cols = t.shape[0]
    cols = padded_columns(n_cols, t.device)
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
    state = PlasmaState(*(_split_models(x[..., :n_cols], n_models) for x in state))
    quants = {key: tuple(_split_models(x[..., :n_cols], n_models) for x in triple)
              for key, triple in quants.items()}
    if single:
        state = PlasmaState(*(x[0] for x in state))
        quants = {key: tuple(x[0] for x in triple) for key, triple in quants.items()}
    return state, (quants or None)


def column_state(state):
    """A batched PlasmaState [B, ...] as B * D depth columns [..., B * D]:
    a view for ``stage_plasma_and_lines``' own output."""
    return PlasmaState(*(x.movedim(0, -2).flatten(-2) for x in state))


def compute_continuum(plan: SimulationPlan, state, tracing_nus, consts, file_sigmas=None,
                      pixels=slice(None)):
    """All continuum sources -> dict of [D, n] tensors over ``tracing_nus``,
    per depth column: a batch passes its B * D columns (``column_state``).

    file_sigmas: optional [D, N] host arrays, one per plan.file_sources
    entry, replacing the plan's (a batch member's own temperatures).
    pixels: the columns of the global grid that ``tracing_nus`` holds; the
    file sigmas are cut to them.
    consts: the plan's DeviceConstants (its bf and ff columns)."""
    n_nu = tracing_nus.shape[0]
    t = state.t
    out = {}
    for i, (name, sig, dplan) in enumerate(plan.file_sources):
        density = cont.species_density(dplan, state, plan.tables)
        sig = sig if file_sigmas is None else file_sigmas[i]
        sig = _tensor(np.asarray(sig)[:, pixels], t)
        if sig.shape[0] != t.shape[0]:  # the plan's [D, n] for each of B models
            sig = sig.repeat(t.shape[0] // sig.shape[0], 1)
        out[f"alpha_file_{name}"] = cont.calc_alpha_file(sig, density)

    if consts.bf is not None:
        level_flat, cutoffs, coefficients = consts.bf
        # the bf (D,K)x(K,N) product runs in full float32 on the card (util.matmul)
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


