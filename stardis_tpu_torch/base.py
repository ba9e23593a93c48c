"""Top-level API: run_stardis / STARDISOutput (PyTorch port of
``stardis_tpu/base.py``, single device)."""

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
from .pipeline import (
    build_simulation_plan,
    host_array,
    not_ported,
    resolve_device,
    run_simulation,
)
from .plasma.molecules import molecule_number_density_table
from .radiation_field.solver import gauss_legendre_thetas

logger = logging.getLogger(__name__)


def _load_atom_data(spec: str) -> AtomData:
    """``builtin`` / ``builtin:<Zmax>``: the generated dataset, with its
    linelist and molecular tables."""
    if spec.startswith("builtin"):
        z_max = int(spec.split(":", 1)[1]) if ":" in spec else 30
        return build_builtin_atom_data(
            max_atomic_number=z_max, include_linelists=True, include_molecules=True
        )
    raise not_ported(f"atom data {spec!r} (HDF and downloaded stores)", "other inputs")


def read_stellar_model(config, adata, fname=None):
    """One stellar model by the config's ``input_model`` rules."""
    im = config.input_model
    path = Path(fname) if fname is not None else Path(im.fname)
    if im.type != "marcs":
        raise not_ported("MESA models", "other inputs")
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
    if config.opacity.line.vald_linelist.get("fname"):
        raise not_ported("opacity.line.vald_linelist.fname", "other inputs")
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
    and ``mesh``, made before any work; ``mesh`` itself is not ported."""
    if isinstance(nu_segments, str) and nu_segments != "auto":
        raise ValueError(f"nu_segments must be an integer or 'auto', got {nu_segments!r}")
    if mesh is not None and nu_segments not in (1, "auto"):
        raise ValueError(
            "nu_segments and mesh are mutually exclusive: a wavelength "
            "mesh already splits the per-device footprint"
        )
    if mesh is not None:
        raise not_ported("mesh=", "multi-GPU sharding")


def resolve_segments(nu_segments, plan, dtype, device):
    """An integer segment count; "auto" asks the memory model
    (``util.memory.choose_nu_segments``) for this plan on this device."""
    if nu_segments != "auto":
        return int(nu_segments)
    from .util.memory import choose_nu_segments

    k = choose_nu_segments(plan, itemsize=torch.empty(0, dtype=dtype).element_size(),
                           device=device)
    if k > 1:
        logger.info("Auto-segmentation: %d serial wavelength segments", k)
    return k


def run_stardis(config, tracing_lambdas_or_nus, add_config_dict=None,
                device="cuda", dtype=torch.float32, atom_data=None,
                nu_segments=1, mesh=None):
    """Run a STARDIS simulation on one device.

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
    mesh : not ported (ROADMAP Queue 1: multi-GPU sharding).
    """
    check_segments(nu_segments, mesh)
    device = resolve_device(device, "run_stardis")
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
    plan = build_simulation_plan(config, adata, stellar_model, tracing_nus_hz)
    f_nu, total, opacities_dict, i_nus, state = run_simulation(
        plan, device=device, dtype=dtype,
        nu_segments=resolve_segments(nu_segments, plan, dtype, device),
    )

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
