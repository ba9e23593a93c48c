"""Top-level API: run_stardis / STARDISOutput (PyTorch port of
``stardis_tpu/base.py``)."""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from . import units as u
from .atom_data import AtomData, build_builtin_atom_data
from .io.abundances import rescale_nuclide_mass_fractions
from .io.config import load_config
from .io.marcs import read_marcs_model
from .io.mesa import read_mesa_model
from .parallel.sharding import Mesh
from .pipeline import (
    build_simulation_plan,
    host_array,
    resolve_device,
    run_simulation,
)
from .plasma.molecules import molecule_number_density_table
from .radiation_field.solver import gauss_legendre_thetas

logger = logging.getLogger(__name__)


def set_num_threads(n_threads):
    """The config's ``n_threads`` check (the JAX package's
    ``set_num_threads``, reference base.py:48-81).

    The reference drives Numba's thread pool; here the card runs the
    kernels and CUDA schedules its own threads, so this validates the value
    and logs the execution mode, and changes no state: it does not call
    ``torch.set_num_threads``, since a CPU thread count changes the order
    of the CPU's reductions.  Accepted: 1 (serial), -99 (max), n > 1;
    other values raise.
    """
    if n_threads == 1:
        logger.info("Running in serial mode (the card still runs its kernels in parallel)")
    elif n_threads == -99:
        logger.info("Running with max threads (the card's default)")
    elif n_threads > 1:
        logger.info("Running with %d threads requested (advisory on the card)", n_threads)
    else:
        raise ValueError(
            "n_threads must be a positive integer, or -99 for max threads."
        )


def _load_atom_data(spec: str) -> AtomData:
    """``builtin`` / ``builtin:<Zmax>``: the generated dataset, with its
    linelist and molecular tables; a published store name
    (``atom_data.download.KNOWN_ATOM_DATA``, e.g.
    ``kurucz_cd23_chianti_H_He``): downloaded and converted on first use
    (``download_atom_data``); a path: a stardis_tpu HDF store
    (``AtomData.from_hdf``)."""
    if spec.startswith("builtin"):
        z_max = int(spec.split(":", 1)[1]) if ":" in spec else 30
        return build_builtin_atom_data(
            max_atomic_number=z_max, include_linelists=True, include_molecules=True
        )
    from .atom_data import download

    if spec in download.KNOWN_ATOM_DATA:
        return AtomData.from_hdf(download.download_atom_data(spec))
    return AtomData.from_hdf(spec)


def read_stellar_model(config, adata, fname=None):
    """One stellar model by the config's ``input_model`` rules."""
    im = config.input_model
    path = Path(fname) if fname is not None else Path(im.fname)
    if im.type == "marcs":
        raw = read_marcs_model(path, gzipped=im.gzipped)
        stellar_model = raw.to_stellar_model(
            adata,
            final_atomic_number=int(im.final_atomic_number),
            composition_source=im.composition_source,
            helium_mass_frac_Y=im.composition_Y,
            heavy_metal_mass_frac_Z=im.composition_Z,
        )
        if config.opacity.line.disable_microturbulence:
            stellar_model.microturbulence = stellar_model.microturbulence * 0.0
    elif im.type == "mesa":
        raw = read_mesa_model(path)
        if im.truncate_to_shell != -99:
            if im.truncate_to_shell < 0:
                raise ValueError(
                    f"{im.truncate_to_shell} shells requested for mesa "
                    "truncation; -99 means no truncation."
                )
            raw.truncate_model(int(im.truncate_to_shell))
        stellar_model = raw.to_stellar_model(
            adata, final_atomic_number=int(im.final_atomic_number)
        )
    else:
        raise ValueError("Model type must be 'marcs' or 'mesa'")

    rescale = im.nuclide_rescaling_dict
    rescale = rescale.to_dict() if hasattr(rescale, "to_dict") else dict(rescale)
    if rescale:
        comp = stellar_model.composition
        comp.nuclide_mass_fraction = rescale_nuclide_mass_fractions(
            comp.atomic_numbers,
            comp.nuclide_mass_fraction,
            list(rescale.keys()),
            list(rescale.values()),
        )
    return stellar_model


def parse_config_to_model(config, add_config_dict=None, atom_data=None):
    """Config + atom data + stellar model.  ``atom_data`` replaces the
    dataset the config names (e.g. one with a synthetic linelist)."""
    config = load_config(config, add_config_dict)
    adata = atom_data if atom_data is not None else _load_atom_data(config.atom_data)
    stellar_model = read_stellar_model(config, adata)
    vald_cfg = config.opacity.line.vald_linelist
    if vald_cfg.get("fname"):
        from .native import read_vald_linelist

        logger.info("Parsing VALD linelist %s", vald_cfg.fname)
        adata.linelist_atoms, is_short = read_vald_linelist(vald_cfg.fname)
        if is_short and not vald_cfg.shortlist:
            logger.info("VALD file detected as shortlist format")
            config.set_config_item("opacity.line.vald_linelist.shortlist", True)
    n_elements = len(stellar_model.composition.atomic_numbers)
    adata.prepare_atom_data(
        np.arange(1, min(n_elements, int(config.input_model.final_atomic_number)) + 1)
    )
    return config, adata, stellar_model


class Opacities:
    """Named per-source opacity tensors + total."""

    def __init__(self, opacities_dict, total_alphas):
        self.opacities_dict = opacities_dict
        self.total_alphas = total_alphas

    def calc_total_alphas(self):
        return self.total_alphas


class RadiationField:
    """Frequencies, opacities and fluxes of a finished simulation."""

    def __init__(self, frequencies, opacities, f_nu, thetas, weights, i_nus=None):
        self.frequencies = frequencies
        self.opacities = opacities
        self.F_nu = f_nu
        self.thetas = thetas
        self.I_nus_weights = weights
        self.I_nus = i_nus


class StellarPlasma:
    """Read-only view over the solved PlasmaState: every PlasmaState field
    (ion_number_density, electron_densities, ...) passes through, plus
    ``molecule_number_density``."""

    def __init__(self, state, plan):
        self._state = state
        self._plan = plan

    def __getattr__(self, name):
        if name in ("_state", "_plan"):
            raise AttributeError(name)
        return getattr(self._state, name)

    def _asdict(self):
        """The PlasmaState's fields by name, what ``util.hdf.output_to_hdf``
        writes."""
        return self._state._asdict()

    @property
    def molecule_number_density(self):
        """Molecular number densities (``names`` [M], ``values`` [M, D]);
        the coupled network when ``molecules_coupled`` is set."""
        if self._plan.molecule_tables is None:
            raise ValueError(
                "no molecular tables in this run: set "
                "opacity.line.include_molecules: true"
            )
        return molecule_number_density_table(
            self._plan.molecule_tables, self._state, coupled=self._plan.molecules_coupled
        )


class STARDISOutput:
    """Key outputs of a simulation.

    nus, lambdas : Quantity
    spectrum_nu : Quantity — F_nu at the outermost depth point [erg/s/cm^2/Hz]
    spectrum_lambda : Quantity — F_lambda at the outermost point [erg/s/cm^2/AA]
    stellar_model / stellar_plasma (a StellarPlasma) / stellar_radiation_field
    as ``result_options`` asks.
    """

    def __init__(self, result_options, stellar_model, stellar_plasma,
                 stellar_radiation_field):
        if result_options.return_model:
            self.stellar_model = stellar_model
        if result_options.return_plasma:
            self.stellar_plasma = stellar_plasma
        if result_options.return_radiation_field:
            self.stellar_radiation_field = stellar_radiation_field

        nus_hz = np.asarray(stellar_radiation_field.frequencies)
        self.nus = u.Quantity(nus_hz, u.Hz)
        self.lambdas = self.nus.to(u.AA, u.spectral())

        f_nu = host_array(stellar_radiation_field.F_nu[-1].to("cpu", torch.float64),
                          "STARDISOutput")
        self.spectrum_nu = u.Quantity(f_nu, u.erg / u.s / u.cm**2 / u.Hz)
        self.spectrum_lambda = u.Quantity(
            f_nu * nus_hz / np.asarray(self.lambdas), u.erg / u.s / u.cm**2 / u.AA
        )


def check_segments(nu_segments, mesh=None):
    """The JAX package's checks on ``nu_segments`` (an integer or "auto")
    and ``mesh`` (a 1-D 'nu' ``parallel.sharding.Mesh``), made before any
    work."""
    if isinstance(nu_segments, str) and nu_segments != "auto":
        raise ValueError(f"nu_segments must be an integer or 'auto', got {nu_segments!r}")
    if mesh is not None and nu_segments not in (1, "auto"):
        raise ValueError(
            "nu_segments and mesh are mutually exclusive: a wavelength "
            "mesh already splits the per-device footprint"
        )
    if mesh is not None and not (isinstance(mesh, Mesh) and mesh.axis_names == ("nu",)):
        raise ValueError(f"mesh must be a 1-D 'nu' parallel.sharding.Mesh, got {mesh!r}")


def resolve_segments(nu_segments, plan, dtype, device, bytes_limit=None, pool_bytes=0):
    """An integer segment count; "auto" asks the memory model
    (``util.memory.choose_nu_segments``) for this plan on this device,
    with ``bytes_limit`` and ``pool_bytes`` as it takes them."""
    if nu_segments != "auto":
        return int(nu_segments)
    from .util.memory import choose_nu_segments

    k = choose_nu_segments(plan, bytes_limit,
                           itemsize=torch.empty(0, dtype=dtype).element_size(),
                           device=device, pool_bytes=pool_bytes)
    if k > 1:
        logger.info("Auto-segmentation: %d serial wavelength segments", k)
    return k


def run_stardis(config, tracing_lambdas_or_nus, add_config_dict=None,
                device="cuda", dtype=torch.float32, atom_data=None,
                nu_segments=1, mesh=None):
    """Run a STARDIS simulation on one device, or sharded over a mesh.

    Parameters
    ----------
    config : dict, or path to a JSON config (or YAML, where PyYAML is
        installed).
    tracing_lambdas_or_nus : Quantity with length or frequency units.
    add_config_dict : optional dotted-key overrides.
    device : torch device, the card by default ("cuda" raises when no GPU
        is available); "cpu" runs the kernels' plain torch versions.
    dtype : torch.float32 (the GPU precision, default) or torch.float64.
    atom_data : optional AtomData replacing the one the config names.
    nu_segments : synthesize the grid in this many serial wavelength
        segments (``parallel.sharding.segmented_spectrum``), for grids
        beyond the card's memory; "auto" asks the memory model
        (``util.memory.choose_nu_segments``; ``STARDIS_SEGMENT_BUDGET``
        sets a budget in bytes).  Segmented == unsegmented.  With
        ``result_options.return_radiation_field`` the per-source opacity
        grids and their total are assembled on the host per segment, as
        NumPy arrays; without it they are left empty.
    mesh : a 1-D 'nu' ``parallel.sharding.Mesh`` (``make_nu_mesh``): stage 1
        on ``device``, the spectrum sharded over the mesh's devices
        (``parallel.sharding.shard_spectrum``; sharded == unsharded, bit for
        bit on a mesh of one repeated card).  Mutually exclusive with
        ``nu_segments`` > 1 ("auto" becomes 1); F_nu only: with
        ``result_options.return_radiation_field`` it raises (drive
        ``shard_spectrum`` for F_nu and I_nus), and the opacities are
        left empty.
    """
    check_segments(nu_segments, mesh)
    device = resolve_device(device, "run_stardis")
    from .util.compile_cache import enable_compilation_cache

    enable_compilation_cache()  # no-op unless STARDIS_COMPILE_CACHE is set
    if not hasattr(tracing_lambdas_or_nus, "to"):
        raise TypeError(
            "tracing_lambdas_or_nus must carry units, e.g. "
            "u.Quantity(lambdas, u.AA) with "
            "`from stardis_tpu_torch import units as u`"
        )
    tracing_nus_hz = np.atleast_1d(
        np.asarray(tracing_lambdas_or_nus.to(u.Hz, u.spectral()))
    )

    config, adata, stellar_model = parse_config_to_model(
        config, add_config_dict, atom_data=atom_data
    )
    if mesh is not None and config.result_options.return_radiation_field:
        raise ValueError(
            "result_options.return_radiation_field is not supported with mesh= (the "
            "sharded path does not assemble the per-source opacity grids): run on one "
            "device or with nu_segments, or drive parallel.sharding.shard_spectrum for "
            "sharded F_nu and I_nus"
        )
    set_num_threads(int(config.n_threads) if config.n_threads != 0 else -99)
    from .util.profiling import StageTimer

    timer = StageTimer(grid_cells=len(tracing_nus_hz) * stellar_model.no_of_depth_points)
    logger.info("Creating plasma and opacity plan")
    with timer.stage("plan"):
        plan = build_simulation_plan(config, adata, stellar_model, tracing_nus_hz)
    if mesh is None:
        nu_segments = resolve_segments(nu_segments, plan, dtype, device)
    logger.info("Solving plasma, opacities and transfer")
    with timer.stage("solve"):
        f_nu, total, opacities_dict, i_nus, state = run_simulation(
            plan, device=device, dtype=dtype, mesh=mesh,
            nu_segments=1 if mesh is not None else nu_segments,
        )
        if device.type == "cuda":  # the card's work belongs to the stage
            torch.cuda.synchronize(device)
    timer.report()

    thetas, weights = gauss_legendre_thetas(int(config.no_of_thetas))
    radiation_field = RadiationField(
        frequencies=plan.tracing_nus,
        opacities=Opacities(opacities_dict, total),
        f_nu=f_nu,
        thetas=thetas,
        weights=weights,
        i_nus=i_nus,
    )
    return STARDISOutput(
        config.result_options, stellar_model, StellarPlasma(state, plan), radiation_field
    )
