"""The benchmark's plain reference: the surface flux F_nu of a configuration's
models at chosen pixels of its grid, and the in-window Voigt evaluations
each model's line sum needs.

Everything here runs on the frozen copies beside this file (the host plan,
stage 1, the continuum, the windows and the Voigt profile, the plain formal
solution of commit 9c7d618), eagerly, in the precision it is given (float64
for the reference), on any device.  It reads only the configuration, the
atomic data and the model files the benchmark generated; it imports nothing
of the program.

The line sum at a pixel p adds, over every line l and depth d whose window
holds p (-iw <= p - centre_l < iw, the program's rule), alpha * phi(nu_p -
nu_l): the same sum as Kernel 1's at that pixel.  The formal solution is
independent per frequency, so F_nu at a set of pixels needs the opacities
at those pixels only, which is what makes a check at full size affordable.
"""

from __future__ import annotations

import numpy as np
import torch

from . import units as u
from .base import parse_config_to_model, read_stellar_model
from .opacities.file_tables import sigma_file
from .opacities.line_kernel import _voigt_in_window, window_half_widths
from .pipeline import (
    C_AA_PER_S,
    build_simulation_plan,
    column_state,
    compute_continuum,
    device_constants,
    elemental_densities,
    model_geometry,
    stage_plasma_and_lines,
)
from .plasma.molecules import build_molecule_tables
from .radiation_field.blackbody import blackbody_flux_at_nu
from .radiation_field.solver import gauss_legendre_thetas, raytrace_plain

#: (line, depth, pixel) elements one chunk of the line sum masks at once
CHUNK_ELEMENTS = 1 << 25


def tracing_nus_hz(lambdas_aa):
    """The grid in Hz, converted as a caller converts u.Quantity(AA)."""
    return np.asarray(u.Quantity(np.asarray(lambdas_aa), u.AA).to(u.Hz, u.spectral()))


class Reference:
    """The configuration's plan, built once from its template model (the
    line selection, the plasma tables and the continuum's constants do not
    depend on the model); each model then gets its own temperatures,
    densities, geometry, file cross-sections and molecular tables, as a
    run of that model alone would."""

    def __init__(self, config, atom_data, lambdas_aa, template_path, device,
                 dtype=torch.float64):
        config = dict(config)
        config["input_model"] = {**config["input_model"], "fname": str(template_path)}
        self.config, self.atom_data, model = parse_config_to_model(config, atom_data)
        self.plan = build_simulation_plan(self.config, self.atom_data, model,
                                          tracing_nus_hz(lambdas_aa))
        self.consts = device_constants(self.plan, dtype, device)
        self.thetas, _ = gauss_legendre_thetas(int(self.config.no_of_thetas))
        self.device, self.dtype = torch.device(device), dtype

    def model(self, path, t_scale=1.0):
        """The model in ``path``, its temperatures times ``t_scale``."""
        m = read_stellar_model(self.config, self.atom_data, path)
        if t_scale != 1.0:
            m.temperatures = m.temperatures * float(t_scale)
        return m

    def stage1(self, models):
        """(state, quants) of the models, [B, ...]: the frozen stage 1."""
        plan = self.plan
        temps = np.stack([np.asarray(m.temperatures, dtype=np.float64) for m in models])
        n_elem = np.stack([elemental_densities(m, plan.tables) for m in models])
        rows = None
        if plan.molecule_tables is not None:
            tabs = [build_molecule_tables(self.atom_data, plan.tables, t) for t in temps]
            rows = tuple(self._tensor(np.stack([getattr(t, name) for t in tabs]))
                         for name in ("k_density", "partition_function"))
        return stage_plasma_and_lines(plan, self._tensor(temps), self._tensor(n_elem),
                                      self.consts, rows)

    def windows(self, quants):
        """{line set: (alpha, gamma, doppler, iw)}, each [B, L, D]."""
        n_nu = self.consts.grid.shape[0]
        return {key: (*triple, window_half_widths(*triple, self.plan.d_nu, n_nu,
                                                  self.plan.window_mode))
                for key, triple in (quants or {}).items()}

    def line_sums(self, models, pixels):
        """Each line set's opacity at the grid's ``pixels``: {line set: [B,
        D, P] float64 host array}, the line sum with the reference's own
        line quantities and windows."""
        pix = torch.as_tensor(np.asarray(pixels, dtype=np.int64), device=self.device)
        _state, quants = self.stage1(models)
        return {key: kappa.double().cpu().numpy()
                for key, kappa in self._line_opacity(quants, pix).items()}

    def _line_opacity(self, quants, pix):
        """{line set: [B, D, P] tensor}: ``line_sum_at`` of each set."""
        consts = self.consts
        return {key: line_sum_at(consts.grid, *consts.lines[key], alpha, gamma, doppler, iw,
                                 pix)
                for key, (alpha, gamma, doppler, iw) in self.windows(quants).items()}

    def surface_flux(self, models, pixels, line_sums=None):
        """F_nu at the surface, [B, P] float64 host array, of ``models`` at
        the grid's ``pixels`` (indices into the descending frequency grid).
        A dict ``line_sums`` receives what ``line_sums`` returns for them,
        the line opacities this flux was computed with."""
        plan, consts = self.plan, self.consts
        pix = torch.as_tensor(np.asarray(pixels, dtype=np.int64), device=self.device)
        n_models, n_pix = len(models), len(pix)
        state, quants = self.stage1(models)
        nus = consts.tracing_nus[pix]
        temps = state.t  # [B, D]
        n_depth = temps.shape[1]
        sigmas = None
        if plan.file_sources:
            lam = C_AA_PER_S / plan.tracing_nus[np.asarray(pixels)]
            sigmas = [np.concatenate([sigma_file(lam, np.asarray(m.temperatures, np.float64),
                                                 self.config.opacity.file[name], name)
                                      for m in models])
                      for name, _sig, _dplan in plan.file_sources]
        opac = compute_continuum(plan, column_state(state), nus, consts, sigmas)
        total = None
        for val in opac.values():
            total = val if total is None else total + val
        total = total.view(n_models, n_depth, n_pix)
        for key, kappa in self._line_opacity(quants, pix).items():
            total = total + kappa
            if line_sums is not None:
                line_sums[key] = kappa.double().cpu().numpy()
        source = blackbody_flux_at_nu(nus, temps[..., None])
        geo = [model_geometry(m, self.thetas) for m in models]
        rays = self._tensor(np.stack([g[0] for g in geo]))
        corr = None if geo[0][2] is None else [g[2] for g in geo]
        f_nu, _ = raytrace_plain(total, source, rays, self._tensor(plan.weights),
                                 inward_rays=plan.inward_rays, photospheric_correction=corr)
        return f_nu[:, -1].double().cpu().numpy()

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=self.device).to(
            self.dtype)


def line_sum_at(grid, line_nu, centers, alpha, gamma, doppler, iw, pixels):
    """sum over (line, depth) windows holding each pixel of alpha * phi, at
    ``pixels`` only: [B, D, P].  grid [N] and line_nu [L] share one
    reference frequency; alpha, gamma, doppler, iw [B, L, D]."""
    n_models, n_lines, n_depth = alpha.shape
    out = torch.zeros((n_models, n_depth, len(pixels)), dtype=alpha.dtype,
                      device=alpha.device)
    chunk = max(1, CHUNK_ELEMENTS // max(1, n_depth * len(pixels)))
    centers = centers.to(torch.int64)
    nu_p = grid[pixels]
    for l0 in range(0, n_lines, chunk):
        sl = slice(l0, min(n_lines, l0 + chunk))
        off = pixels[None, :] - centers[sl, None]  # [C, P]
        dnu = nu_p[None, :] - line_nu[sl, None]  # [C, P]
        for b in range(n_models):
            half = iw[b, sl].to(torch.int64)[:, :, None]  # [C, D, 1]
            within = (off[:, None, :] >= -half) & (off[:, None, :] < half)
            li, di, pi = within.nonzero(as_tuple=True)
            phi = _voigt_in_window(dnu[li, pi], doppler[b, sl][li, di], gamma[b, sl][li, di])
            out[b].index_put_((di, pi), phi * alpha[b, sl][li, di], accumulate=True)
    return out
