"""Gradients through the port: ``torch.autograd`` through stage 1, the line
sum (Kernel 1b's plain version, an explicit chunked backward) and the
formal solution (autograd of the plain version, Kernel 2b's reference),
against ``jax.grad`` / ``jax.vjp`` of the JAX package on the same plans, in
float64 on the CPU.

* the electron density's gradient with respect to T (the implicit Newton
  step) against jax.grad at 1e-10 and a central difference at 1e-4;
* dsum(F_nu[surface])/dT[d] against jax.grad (JAX windows from
  ``line_window_tiers``) at 1e-8 of the largest component: builtin TARDIS
  lines (tests/test_differentiability.py's config), synthetic VALD lines,
  accuracy windows, and the spherical giant with three file tables and
  pairwise or coupled molecules;
* run_batch of 2 members, each against its single-model gradient, and a
  segmented run (K = 3) against the unsegmented one, at 1e-12;
* Kernel 1b's plain version against autograd of the plain forward at 1e-12
  of each depth's largest gradient and against jax.vjp of the JAX line sum
  on its window tiers at 1e-10, on lines whose in-window pairs fall in all
  four Humlicek regions; the region derivatives against autograd at 1e-13;
* Kernel 2b's plain version (autograd of raytrace_plain) against jax.vjp
  of the JAX raytrace, plane-parallel and spherical (zero chords, the
  gap-0 wrap), with a gradient on I_nu too, at 1e-9 of each frequency
  column's largest gradient (1e-6 where tau crosses the Taylor threshold:
  ``TRACE_BOUND``); there both, against the same formulas in 40 digits,
  the port within twice JAX's own distance from exact arithmetic;
* host copies of tensors that carry a gradient raise.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from bench_lines import synth_linelist as jax_synth_linelist  # noqa: E402
from stardis_tpu import parse_config_to_model, units as ju  # noqa: E402
from stardis_tpu.atom_data import build_builtin_atom_data as jax_atom_data  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.opacities import line_kernel as jlk  # noqa: E402
from stardis_tpu.pipeline import (  # noqa: E402
    build_simulation_plan,
    line_window_tiers,
    stage_plasma_and_lines,
    stage_spectrum,
)
from stardis_tpu.plasma.lte import device_tables as jax_device_tables  # noqa: E402
from stardis_tpu.plasma.lte import solve_lte as jax_solve_lte  # noqa: E402
from stardis_tpu.plasma.tables import build_plasma_tables as jax_plasma_tables  # noqa: E402
from stardis_tpu.radiation_field import solver as jsolver  # noqa: E402
from stardis_tpu_torch import pipeline as tpipe  # noqa: E402
from stardis_tpu_torch.atom_data import build_builtin_atom_data  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_opacity_tables  # noqa: E402
from stardis_tpu_torch.opacities import line_kernel as tlk  # noqa: E402
from stardis_tpu_torch.opacities import voigt as tvoigt  # noqa: E402
from stardis_tpu_torch.opacities.lines import synth_molecule_linelist  # noqa: E402
from stardis_tpu_torch.parallel import batch as tbatch  # noqa: E402
from stardis_tpu_torch.parallel import sharding as tshard  # noqa: E402
from stardis_tpu_torch.plasma.lte import device_tables, solve_lte  # noqa: E402
from stardis_tpu_torch.plasma.tables import build_plasma_tables  # noqa: E402
from stardis_tpu_torch.radiation_field import solver as tsolver  # noqa: E402

CPU = {"device": "cpu", "dtype": torch.float64}
BROADENING = ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_to_max(ours, ref):
    """max |ours - ref| / max |ref|."""
    return float(np.abs(np.asarray(ours) - np.asarray(ref)).max() / np.abs(ref).max())


def _col_err(ours, ref, axis=0):
    """max over the other axes of max_axis |ours - ref| / max_axis |ref|."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    diff = np.abs(ours - ref).max(axis=axis)
    scale = np.abs(ref).max(axis=axis)
    assert (diff[scale == 0] == 0).all()
    return float((diff[scale > 0] / scale[scale > 0]).max())


# ----------------------------------------------------------------------
# stage 1: the electron density
# ----------------------------------------------------------------------

def test_electron_density_gradient_matches_jax_and_finite_difference():
    """The port of test_differentiability.py:23: d n_e / dT through the
    bisection and the implicit Newton step (torch.func.jvp)."""
    n_elem = np.array([[1e17], [8.5e15]])
    jt = jax_device_tables(jax_plasma_tables(jax_atom_data(max_atomic_number=2)))
    tt = device_tables(build_plasma_tables(build_builtin_atom_data(max_atomic_number=2)))

    def ne_jax(t):
        return jax_solve_lte(jnp.asarray([t]), jnp.asarray(n_elem), jt).electron_densities[0]

    def ne_port(t):
        return solve_lte(t.reshape(1), torch.from_numpy(n_elem), tt).electron_densities[0]

    t0 = 6000.0
    ref = float(jax.grad(ne_jax)(t0))
    t = torch.tensor(t0, dtype=torch.float64, requires_grad=True)
    ne_port(t).backward()
    grad = t.grad.item()
    with torch.no_grad():
        fd = (ne_port(torch.tensor(t0 + 0.5, dtype=torch.float64))
              - ne_port(torch.tensor(t0 - 0.5, dtype=torch.float64))).item()
    assert grad > 0
    np.testing.assert_allclose(grad, ref, rtol=1e-10)
    np.testing.assert_allclose(grad, fd, rtol=1e-4)


# ----------------------------------------------------------------------
# the spectrum's gradient with respect to the temperatures
# ----------------------------------------------------------------------

def _config(model, kind):
    """The test configs: "builtin" (test_differentiability.py's), "vald",
    "accuracy", and "giant" (spherical, file tables and molecules)."""
    if kind == "builtin":
        return {
            "stardis_config_version": 1.0, "atom_data": "builtin:5",
            "input_model": {"type": "marcs", "fname": model, "final_atomic_number": 5},
            "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}},
                        "line": {"disable": False, "broadening": ["radiation"]}},
            "no_of_thetas": 3, "result_options": {},
        }
    line = {"disable": False, "broadening": BROADENING,
            "vald_linelist": {"use_linelist": True, "use_vald_broadening": True},
            "window_mode": "accuracy" if kind in ("accuracy", "giant") else "reference"}
    return {
        "stardis_config_version": 1.0, "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": model, "final_atomic_number": 30},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"], "line": line},
        "no_of_thetas": 3, "result_options": {},
    }


N_LINES, N_MOL_LINES = 150, 80
LINE_RANGE = (6499.0, 6504.0)


def _jax_plan(tmp_path, kind, coupled=False, lams=None):
    model = str(tmp_path / "model.mod")
    if kind == "giant":
        write_marcs_file(model, teff=4000.0, logg=2.0, spherical=True, radius_cm=2e12)
    else:
        write_marcs_file(model)
    cfg = _config(model, kind)
    if kind == "giant":
        cfg["opacity"]["file"] = write_opacity_tables(tmp_path)
        cfg["opacity"]["rayleigh"] = ["H", "H2"]
        cfg["opacity"]["line"].update(include_molecules=True, molecules_coupled=coupled)
    if lams is None:
        lams = (np.arange(6560.0, 6570.0, 0.2) if kind == "builtin"
                else np.arange(6500.0, 6503.0, 0.05))
    path = tmp_path / "c.yml"
    path.write_text(yaml.safe_dump(cfg))
    config, adata, model_j = parse_config_to_model(str(path))
    if kind != "builtin":
        jax_synth_linelist(adata, N_LINES, *LINE_RANGE)
    if kind == "giant":
        port_data = build_builtin_atom_data(30, include_linelists=True, include_molecules=True)
        synth_molecule_linelist(port_data, N_MOL_LINES, *LINE_RANGE)
        adata.linelist_molecules = pd.DataFrame(dict(port_data.linelist_molecules.columns))
    nus = np.asarray(ju.Quantity(lams, ju.AA).to(ju.Hz, ju.spectral()))
    return cfg, build_simulation_plan(config, adata, model_j, nus)


def _jax_flux_grad(plan):
    """jax.grad of sum(F_nu[surface]) with respect to T, on windows from
    line_window_tiers at the plan's temperatures."""
    n_elem = jnp.asarray(plan.n_elem)
    temps0 = jnp.asarray(plan.temperatures)
    state, lq = stage_plasma_and_lines(plan, temps0, n_elem)
    window = line_window_tiers(plan, lq, state)

    def flux_sum(t):
        s, q = stage_plasma_and_lines(plan, t, n_elem)
        return jnp.sum(stage_spectrum(plan, s, q, window=window)[0][-1])

    return np.asarray(jax.jit(jax.grad(flux_sum))(temps0))


def _port_flux_grad(tplan, temps=None, segments=None):
    """d sum(F_nu[surface]) / dT of the port on the CPU (stage_spectrum, or
    segmented_spectrum in ``segments`` ranges)."""
    consts = tpipe.device_constants(tplan, torch.float64, "cpu")
    t = torch.tensor(tplan.temperatures if temps is None else temps, requires_grad=True)
    state, lq = tpipe.stage_plasma_and_lines(tplan, t, torch.tensor(tplan.n_elem), consts)
    if segments is None:
        f_nu = tpipe.stage_spectrum(tplan, state, lq, consts)[0]
    else:
        f_nu = tshard.segmented_spectrum(tplan, state, lq, segments, consts)
    f_nu[-1].sum().backward()
    return t.grad.numpy()


@pytest.mark.parametrize("kind, coupled", [
    ("builtin", False), ("vald", False), ("accuracy", False), ("giant", False),
    ("giant", True),
], ids=["builtin", "vald", "accuracy", "giant_pairwise", "giant_coupled"])
def test_flux_gradient_matches_jax(tmp_path, kind, coupled):
    _, plan = _jax_plan(tmp_path, kind, coupled)
    if kind == "giant":
        assert plan.inward_rays and len(plan.file_sources) == 3
        assert plan.molecule_line_data.n_lines > 20 and plan.molecules_coupled == coupled
    ref = _jax_flux_grad(plan)
    ours = _port_flux_grad(tpipe.plan_from_reference(plan))
    assert np.isfinite(ours).all() and np.abs(ref).max() > 0
    assert _rel_to_max(ours, ref) <= 1e-8


def test_segmented_gradient_equals_unsegmented(tmp_path):
    """segmented_spectrum (K = 3 ranges of 60 pixels) carries the gradient:
    each range's Kernel 1b sums over its own pixels only."""
    _, plan = _jax_plan(tmp_path, "vald")
    tplan = tpipe.plan_from_reference(plan)
    whole = _port_flux_grad(tplan)
    parts = _port_flux_grad(tplan, segments=3)
    assert _rel_to_max(parts, whole) <= 1e-12


def test_batch_gradient_members_match_single_runs(tmp_path):
    """run_batch of two plane-parallel models with tensor temperatures that
    require grad: each member's gradient equals its single-model one."""
    from stardis_tpu_torch.base import parse_config_to_model as t_parse
    from stardis_tpu_torch.base import read_stellar_model

    paths = []
    for teff in (5200.0, 6100.0):
        paths.append(str(tmp_path / f"m{int(teff)}.mod"))
        write_marcs_file(paths[-1], teff=teff)
    cfg = _config(paths[0], "builtin")
    config, adata, model0 = t_parse(cfg)
    models = [model0, read_stellar_model(config, adata, paths[1])]
    nus = ju.Quantity(np.arange(6560.0, 6570.0, 0.2), ju.AA).to(ju.Hz, ju.spectral()).value
    plan, batch = tbatch.make_batch(config, adata, models, nus)
    temps = torch.tensor(batch.temperatures, requires_grad=True)
    f_nu = tbatch.run_batch(plan, dataclasses.replace(batch, temperatures=temps), **CPU)
    f_nu[:, -1].sum().backward()
    for b, model in enumerate(models):
        single = tpipe.build_simulation_plan(config, adata, model, nus)
        np.testing.assert_allclose(single.temperatures, batch.temperatures[b])
        ref = _port_flux_grad(single)
        assert _rel_to_max(temps.grad[b].numpy(), ref) <= 1e-12, f"member {b}"


def test_host_copies_of_gradients_raise(tmp_path):
    """segmented_spectrum(collect_opacities=True) and STARDISOutput copy to
    host NumPy arrays: under autograd they raise instead of cutting the
    graph."""
    from stardis_tpu_torch.base import STARDISOutput

    _, plan = _jax_plan(tmp_path, "vald")
    tplan = tpipe.plan_from_reference(plan)
    consts = tpipe.device_constants(tplan, torch.float64, "cpu")
    t = torch.tensor(tplan.temperatures, requires_grad=True)
    state, lq = tpipe.stage_plasma_and_lines(tplan, t, torch.tensor(tplan.n_elem), consts)
    with pytest.raises(RuntimeError, match="carry no gradient"):
        tshard.segmented_spectrum(tplan, state, lq, 2, consts, collect_opacities=True)
    f_nu = tshard.segmented_spectrum(tplan, state, lq, 2, consts)
    assert f_nu.requires_grad

    class Field:
        frequencies = tplan.tracing_nus
        F_nu = f_nu

    class Options:
        return_model = return_plasma = return_radiation_field = False

    with pytest.raises(RuntimeError, match="STARDISOutput"):
        STARDISOutput(Options(), None, None, Field())


# ----------------------------------------------------------------------
# Kernel 1b's plain version
# ----------------------------------------------------------------------

def test_region_derivatives_match_autograd():
    """d Re w / dx, dy of each Humlicek region's formula (and of the
    region-I rational alone) against autograd of faddeeva_real, on random
    points of all four regions and on the region boundaries."""
    rng = np.random.default_rng(1)
    xb = np.array([15.0, -15.0, 5.5, -5.5, 3.0, -3.0, 1.0, 0.0, 10.0, 0.0])
    yb = np.array([0.0, 0.0, 0.0, 0.0, 0.195 * 3.0 - 0.176, 0.195 * 3.0 - 0.176,
                   0.195 - 0.176, 5.5, 5.0, 15.0])
    x = np.concatenate([rng.uniform(-30, 30, 3000), rng.uniform(-6, 6, 3000), xb])
    y = np.concatenate([rng.uniform(0, 20, 3000), rng.uniform(0, 1.2, 3000), yb])
    s = np.abs(x) + y
    regions = [s > 15, (s <= 15) & (s > 5.5), (s <= 5.5) & (y >= 0.195 * np.abs(x) - 0.176),
               (s <= 5.5) & (y < 0.195 * np.abs(x) - 0.176)]
    assert all(r.sum() > 100 for r in regions)
    for fn, grad_fn in ((tvoigt.faddeeva_real, tvoigt.faddeeva_real_grad),
                        (tvoigt.faddeeva_real_region1, tvoigt.faddeeva_real_region1_grad)):
        xt = torch.tensor(x, requires_grad=True)
        yt = torch.tensor(y, requires_grad=True)
        value = fn(xt, yt)
        ref = torch.autograd.grad(value.sum(), (xt, yt))
        re, dx, dy = grad_fn(xt.detach(), yt.detach())
        assert torch.equal(re, value.detach())
        for ours, theirs in zip((dx, dy), ref):
            np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=1e-13,
                                       atol=1e-13 * float(theirs.abs().max()))


def _line_setup(n_lines=40, n_depth=9, n_nu=400, seed=2):
    """Lines on a 400-pixel grid with Doppler widths of 1-3 pixels and both
    narrow (y ~ 1e-3) and wide (y ~ 3) damping, strong enough that windows
    reach far wings: in-window pairs fall in all four Humlicek regions."""
    rng = np.random.default_rng(seed)
    nus = np.linspace(4.6e14, 4.59e14, n_nu)
    step = nus[0] - nus[1]
    line_nu = np.sort(rng.uniform(nus.min(), nus.max(), n_lines))
    doppler = rng.uniform(1.0, 3.0, (n_lines, n_depth)) * step
    y = np.where(rng.random((n_lines, 1)) < 0.5, 1e-3, 3.0) * rng.uniform(0.5, 1.5, (n_lines, n_depth))
    gamma = y * np.sqrt(np.pi) * np.pi * doppler
    alpha = 10.0 ** rng.uniform(-3, 1, (n_lines, n_depth))
    return nus, line_nu, alpha, gamma, doppler


def _prepared(nus, line_nu, alpha, gamma, doppler):
    nu_ref = float(nus[len(nus) // 2])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))  # noqa: E731
    a, g, d = (t(v).requires_grad_() for v in (alpha, gamma, doppler))
    iw = tlk.window_half_widths(a, g, d, tlk.grid_min_step(nus), len(nus))
    centers = torch.from_numpy(tlk.line_center_indices(nus, line_nu))
    return t(nus - nu_ref), t(line_nu - nu_ref), centers, a, g, d, iw


def _regions_in_window(nus, line_nu, gamma, doppler, iw):
    centers = tlk.line_center_indices(nus, line_nu)
    p = np.arange(len(nus))
    counts = np.zeros(4, dtype=int)
    for li in range(len(line_nu)):
        for d in range(gamma.shape[1]):
            sel = (p - centers[li] >= -iw[li, d]) & (p - centers[li] < iw[li, d])
            x = (nus[sel] - line_nu[li]) / doppler[li, d]
            y = gamma[li, d] / (np.sqrt(np.pi) * np.pi) / doppler[li, d]
            s = np.abs(x) + y
            counts += [np.sum(s > 15), np.sum((s <= 15) & (s > 5.5)),
                       np.sum((s <= 5.5) & (y >= 0.195 * np.abs(x) - 0.176)),
                       np.sum((s <= 5.5) & (y < 0.195 * np.abs(x) - 0.176))]
    return counts


@pytest.mark.parametrize("p_begin, n_out", [(0, 400), (130, 150)], ids=["whole", "range"])
def test_line_backward_matches_autograd_of_plain(p_begin, n_out):
    setup = _line_setup()
    grid, line_nu, centers, a, g, d, iw = _prepared(*setup)
    assert (_regions_in_window(setup[0], setup[1], setup[3], setup[4], iw.numpy()) > 50).all()
    rng = np.random.default_rng(3)
    g_out = torch.from_numpy(rng.standard_normal((a.shape[1], n_out)))
    out = tlk.accumulate_line_opacity_plain(grid, line_nu, centers, a, g, d, iw,
                                            p_begin=p_begin, n_out=n_out)
    ref = torch.autograd.grad(out, (a, g, d), g_out)
    ours = tlk.accumulate_line_opacity_plain_backward(
        g_out, grid, line_nu, centers, a.detach(), g.detach(), d.detach(), iw,
        budget=1 << 14, p_begin=p_begin, n_out=n_out)
    for o, r in zip(ours, ref):
        assert _col_err(o.numpy(), r.numpy(), axis=0) <= 1e-12  # per depth, over lines
    # the autograd Function around line_opacity_range runs the same backward
    prepared = tlk.prepare_line_opacity(grid, line_nu, centers, a, g, d, iw)
    via = torch.autograd.grad(tlk.line_opacity_range(prepared, p_begin, n_out), (a, g, d),
                              g_out)
    for o, r in zip(via, ref):
        assert _col_err(o.numpy(), r.numpy(), axis=0) <= 1e-12


def test_line_backward_matches_jax_vjp_on_tiers():
    """Against jax.vjp of accumulate_line_opacity_blocked on its window
    tiers (the JAX package's gradient of its line sum)."""
    nus, line_nu, alpha, gamma, doppler = _line_setup()
    grid, lnu, centers, a, g, d, iw = _prepared(nus, line_nu, alpha, gamma, doppler)
    nu_ref = float(nus[len(nus) // 2])
    d_nu = jlk.grid_min_step(nus)
    win = np.asarray(jlk.window_pixels(*map(jnp.asarray, (alpha, gamma, doppler)), d_nu))
    blocked = jlk.assign_window_tiers_blocked(win, len(nus), block=4)
    j_centers = jnp.asarray(jlk.line_center_indices(nus, line_nu))

    def jax_sum(al, ga, do):
        return jlk.accumulate_line_opacity_blocked(
            jnp.asarray(nus - nu_ref), jnp.asarray(line_nu - nu_ref), j_centers, al, ga, do,
            blocked=blocked, d_nu=d_nu, chunk=16)

    g_out = np.random.default_rng(4).standard_normal((alpha.shape[1], len(nus)))
    out, vjp = jax.vjp(jax_sum, *map(jnp.asarray, (alpha, gamma, doppler)))
    ref = [np.asarray(v) for v in vjp(jnp.asarray(g_out))]
    ours = tlk.accumulate_line_opacity_plain_backward(
        torch.from_numpy(g_out), grid, lnu, centers, a.detach(), g.detach(), d.detach(), iw)
    for o, r in zip(ours, ref):
        assert np.isfinite(r).all()
        assert _col_err(o.numpy(), r, axis=0) <= 1e-10


# ----------------------------------------------------------------------
# Kernel 2b's plain version
# ----------------------------------------------------------------------

def _trace_inputs(kind, n_depth=30, n_nu=40, n_theta=6, seed=5):
    """Inputs of the formal solution, one per ``kind``:

    * "solar": plane-parallel, opacity rising 9 decades inward, per-gap tau
      from ~1e-3 (middle regime) to saturated;
    * "giant": spherical shells thick enough that outer chords miss inner
      shells (zero chords), the gap-0 wrap reading an S[G] that differs
      from S[G-1];
    * "spanning_plane", "spanning_giant": the same with the opacity columns
      scaled over 12 decades, so per-gap tau also visits the Taylor regime
      down to ~1e-17.
    """
    rng = np.random.default_rng(seed)
    depth = np.linspace(1.0, 0.0, n_depth)[:, None]
    alphas = 10.0 ** (-11.0 + 10.0 * depth) * (1.0 + 50.0 * rng.random((1, n_nu)) ** 8)
    if kind.startswith("spanning"):
        alphas = alphas * np.logspace(0, -12, n_nu)[None, :]
    source = 1e-5 * (1.0 + 3.0 * depth) ** 4 * (1.0 + 0.3 * rng.random((n_depth, n_nu)))
    thetas, weights = tsolver.gauss_legendre_thetas(n_theta)
    spherical = kind.endswith("giant")
    if spherical:
        radii = 1e12 + np.linspace(0.0, 2.5e11, n_depth)
        ray = tsolver.calculate_spherical_ray(thetas, radii)
        assert (ray == 0).any() and (ray[0] > 0).any()
        correction = 1.3
    else:
        ray = np.full((n_depth - 1, 1), 2e8) / np.cos(thetas)[None, :]
        correction = None
    g_flux = rng.standard_normal((n_depth, n_nu))
    g_int = rng.standard_normal((n_depth, n_nu, n_theta))
    return alphas, source, ray, weights, correction, spherical, g_flux, g_int


#: per-frequency-column bound of the plain backward against jax.vjp.  On
#: columns whose tau crosses the Taylor threshold neither package's float64
#: gradient is within 1e-9 of the exact value of the shared formula: just
#: above tau = 5e-4, w2 = 2 w1 - tau^2 e cancels two terms of size tau^2 to
#: leave tau^3 / 3 and carries up to 2e-6 relative error, and the inward
#: sweep's gap-0 wrap multiplies by tau[0] / tau[G-1] ~ 5e9.
#: ``test_trace_backward_against_exact_arithmetic`` holds both to a
#: 40-digit evaluation there (ROADMAP Queue 3)
TRACE_BOUND = {"solar": 1e-9, "giant": 1e-9, "spanning_plane": 1e-6,
               "spanning_giant": 1e-6}


@pytest.mark.parametrize("track", [False, True], ids=["F", "F_and_I"])
@pytest.mark.parametrize("kind", list(TRACE_BOUND))
def test_trace_backward_matches_jax_vjp(kind, track):
    alphas, source, ray, weights, corr, spherical, g_flux, g_int = _trace_inputs(kind)

    def jax_trace(al, so):
        return jsolver.raytrace(al, so, jnp.asarray(ray), jnp.asarray(weights),
                                inward_rays=spherical, photospheric_correction=corr,
                                track_individual_intensities=True)

    _, vjp = jax.vjp(jax_trace, jnp.asarray(alphas), jnp.asarray(source))
    g_i = g_int if track else np.zeros_like(g_int)
    ref = [np.asarray(v) for v in vjp((jnp.asarray(g_flux), jnp.asarray(g_i)))]
    t = torch.from_numpy
    ours = tsolver.raytrace_plain_backward(
        t(alphas), t(source), t(ray), t(weights), t(g_flux), t(g_int) if track else None,
        inward_rays=spherical, photospheric_correction=corr)
    for o, r in zip(ours, ref):
        assert np.isfinite(r).all()
        assert _col_err(o.numpy(), r, axis=0) <= TRACE_BOUND[kind]  # per frequency


def _exact_trace_loss(alphas, source, ray, weights, corr, spherical, g_flux, g_int):
    """sum(g_flux corr F) + sum(g_int I) of one frequency column, the JAX
    raytrace's formulas (weights by regime, log-midpoint tau, the inward
    sweep with its gap-0 wrap, zero chords) evaluated in mpmath."""
    mp = pytest.importorskip("mpmath").mp
    one = mp.mpf(1)

    def weights_of(tau):
        if tau < jsolver.TAU_TAYLOR:
            return (tau * (1 - tau / 2), tau ** 2 * (one / 2 - tau / 3),
                    tau ** 3 * (one / 3 - tau / 4))
        if tau >= jsolver.TAU_SATURATED:
            return one, one, 2 * one
        e = mp.exp(-tau)
        w1 = 1 - e - tau * e
        return 1 - e, w1, 2 * w1 - tau * tau * e

    def safe(x):
        return one if x == 0 else x

    n_gaps = len(alphas) - 1
    s = source
    loss = mp.mpf(0)
    for th, w_theta in enumerate(weights):
        taus = [mp.exp((mp.log(alphas[g + 1]) + mp.log(alphas[g])) / 2) * mp.mpf(ray[g, th])
                for g in range(n_gaps)]
        w = [weights_of(t) for t in taus]
        intensity = mp.mpf(0)
        if spherical:
            for g in range(n_gaps - 1, -1, -1):  # the wrap: taus[-1], s[n_gaps] at g = 0
                tg, tm, sm = taus[g], taus[g - 1], s[g - 1] if g else s[n_gaps]
                den = safe(tg + tm)
                second = w[g][1] * ((s[g] - sm) * (tg / safe(tm))
                                    - (s[g] - s[g + 1]) * (tm / safe(tg))) / den
                third = w[g][2] * ((sm - s[g]) / safe(tm) + (s[g + 1] - s[g]) / safe(tg)) / den
                if tg != 0 and tm != 0:
                    intensity = (1 - w[g][0]) * intensity + w[g][0] * s[g] + second + third
        levels = [intensity]
        for k in range(n_gaps):
            if taus[k] == 0:
                levels.append(intensity)
                continue
            if k < n_gaps - 1:
                tk, tp = taus[k], taus[k + 1]
                second = w[k][1] * ((s[k + 1] - s[k + 2]) * (tk / safe(tp))
                                    - (s[k + 1] - s[k]) * (tp / safe(tk))) / safe(tk + tp)
                third = w[k][2] * ((s[k + 2] - s[k + 1]) / safe(tp)
                                   + (s[k] - s[k + 1]) / safe(tk)) / safe(tk + tp)
                intensity = (1 - w[k][0]) * intensity + w[k][0] * s[k + 1] + second + third
            else:
                third = w[k][2] * (s[k] - s[k + 1]) / taus[k] ** 2
                intensity = (1 - w[k][0]) * intensity + w[k][0] * s[k + 1] + third
            levels.append(intensity)
        for d, level in enumerate(levels):
            loss += (mp.mpf(g_flux[d]) * mp.mpf(corr or 1) * mp.mpf(w_theta)
                     + mp.mpf(g_int[d, th])) * level
    return loss


@pytest.mark.parametrize("kind", ["spanning_plane", "spanning_giant"])
def test_trace_backward_against_exact_arithmetic(kind):
    """On the spanning inputs' column where the port and jax.vjp part most,
    both against differences of the same formulas in 40 digits (one-sided
    at 1e-20 relative in alpha; the loss is linear in the source): the port
    is as close to the exact gradient as JAX is, and JAX itself misses it
    by more than 1e-9 (why TRACE_BOUND is 1e-6 there)."""
    mp = pytest.importorskip("mpmath").mp
    alphas, source, ray, weights, corr, spherical, g_flux, g_int = _trace_inputs(kind)

    def jax_trace(al, so):
        return jsolver.raytrace(al, so, jnp.asarray(ray), jnp.asarray(weights),
                                inward_rays=spherical, photospheric_correction=corr,
                                track_individual_intensities=True)

    _, vjp = jax.vjp(jax_trace, jnp.asarray(alphas), jnp.asarray(source))
    ref = [np.asarray(v) for v in vjp((jnp.asarray(g_flux), jnp.asarray(g_int)))]
    t = torch.from_numpy
    ours = [o.numpy() for o in tsolver.raytrace_plain_backward(
        t(alphas), t(source), t(ray), t(weights), t(g_flux), t(g_int),
        inward_rays=spherical, photospheric_correction=corr)]
    col = int(np.argmax(np.abs(ours[0] - ref[0]).max(0) / np.abs(ref[0]).max(0)))
    with mp.workdps(40):
        a0 = [mp.mpf(x) for x in alphas[:, col]]
        s0 = [mp.mpf(x) for x in source[:, col]]

        def loss(a, s):
            return _exact_trace_loss(a, s, ray, weights, corr, spherical,
                                     g_flux[:, col], g_int[:, col])

        at = loss(a0, s0)
        exact = np.zeros((2, len(a0)))
        for which, base in enumerate((a0, s0)):
            for d in range(len(base)):
                h = base[d] * mp.mpf(10) ** -20
                up = list(base)
                up[d] += h
                exact[which, d] = float((loss(*((up, s0) if which == 0 else (a0, up))) - at) / h)
    for o, r, e in zip(ours, ref, exact):
        port_err = _rel_to_max(o[:, col], e)
        jax_err = _rel_to_max(r[:, col], e)
        assert _rel_to_max(o[:, col], r[:, col]) > 1e-9  # the column the bound is for
        assert jax_err > 1e-9
        assert port_err <= 2.0 * jax_err
