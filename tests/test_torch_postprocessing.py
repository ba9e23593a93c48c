"""Post-processing: ``stardis_tpu_torch.postprocessing`` against the JAX
package's ``postprocessing`` (host and device functions) and scipy, in
float64 on the CPU, mirroring tests/test_postprocessing_and_output.py:
values and gradients (v sin i, limb darkening, sigma), v_rot = 0, negative
v_rot, sigma = 0, and float32 against float64; then a small run of the
stellar-parameter fit of examples/fit_stellar_parameters.py (temperature
scale and v sin i) through the port's stages, its loss and gradient at the
start against JAX's value_and_grad at 1e-8, and a few Adam steps."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stardis_tpu import postprocessing as jpp  # noqa: E402
from stardis_tpu import units as ju  # noqa: E402
from stardis_tpu_torch import postprocessing as tpp  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402

VEL_PIX = 4.566  # km/s: 0.1 AA at 6565 AA


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spectrum(n=401, seed=0):
    """A spike on a continuum plus a random ripple, so edges matter."""
    lam = np.linspace(6500.0, 6540.0, n)
    flux = 1.0 + 0.1 * np.random.default_rng(seed).random(n)
    flux[n // 2] = 2.0
    return lam, flux


@pytest.mark.parametrize("v_rot", [12.0, 30.0, 7.3, -23.0])
def test_rotation_matches_host_and_jax(v_rot):
    lam, flux = _spectrum()
    _, host = jpp.rotation_broadening(ju.Quantity(VEL_PIX, ju.km / ju.s), lam, flux,
                                      v_rot=ju.Quantity(v_rot, ju.km / ju.s))
    _, ours_host = tpp.rotation_broadening(tu.Quantity(VEL_PIX, tu.km / tu.s), lam, flux,
                                           v_rot=tu.Quantity(v_rot, tu.km / tu.s))
    np.testing.assert_array_equal(np.asarray(ours_host.value), np.asarray(host.value))
    jax_dev = np.asarray(jpp.rotation_broadening_jax(VEL_PIX, jnp.asarray(flux), v_rot))
    ours = tpp.rotation_broadening_torch(VEL_PIX, torch.from_numpy(flux), v_rot).numpy()
    np.testing.assert_allclose(ours, np.asarray(host.value), rtol=1e-12)
    np.testing.assert_allclose(ours, jax_dev, rtol=1e-12)
    # a wider static support adds exact zeros that the normalisation removes
    half = int(round(abs(v_rot) / VEL_PIX)) + 7
    wide = tpp.rotation_broadening_torch(VEL_PIX, torch.from_numpy(flux), v_rot,
                                         half_width_pix=half).numpy()
    np.testing.assert_allclose(wide, np.asarray(host.value), rtol=1e-12)


@pytest.mark.parametrize("kw", [{"sigma_aa": 0.25}, {"resolution": 30000.0}])
def test_instrumental_matches_host_and_jax(kw):
    lam, flux = _spectrum()
    _, host = jpp.instrumental_broadening(lam, flux, **kw)
    _, ours_host = tpp.instrumental_broadening(lam, flux, **kw)
    np.testing.assert_array_equal(np.asarray(ours_host.value), np.asarray(host.value))
    sigma_pix = kw.get("sigma_aa", np.mean(lam) / kw.get("resolution", 1.0)
                       / (2.0 * np.sqrt(2.0 * np.log(2.0)))) / (lam[1] - lam[0])
    ours = tpp.instrumental_broadening_torch(torch.from_numpy(flux), sigma_pix).numpy()
    jax_dev = np.asarray(jpp.instrumental_broadening_jax(jnp.asarray(flux), sigma_pix))
    np.testing.assert_allclose(ours, np.asarray(host.value), rtol=1e-10)
    np.testing.assert_allclose(ours, jax_dev, rtol=1e-12)


def test_host_guards_match_jax():
    lam, flux = _spectrum()
    with pytest.raises(ValueError, match="uniform"):
        tpp.instrumental_broadening(lam ** 2, flux, sigma_aa=0.2)
    with pytest.raises(ValueError, match="either"):
        tpp.instrumental_broadening(lam, flux)
    _, same = tpp.rotation_broadening(VEL_PIX, lam, flux, v_rot=0.0)
    np.testing.assert_array_equal(np.asarray(same.value), flux)


def _rotation_loss_torch(flux, target, v, ld):
    model = tpp.rotation_broadening_torch(VEL_PIX, flux, v, limb_darkening=ld,
                                          half_width_pix=16)
    return torch.sum((model - target) ** 2)


@pytest.mark.parametrize("v_rot", [30.0, 0.0, -19.0])
def test_rotation_gradient_matches_jax(v_rot):
    """d loss / d(v sin i, limb darkening) against jax.grad at 1e-10, and a
    central difference at 1e-4 (away from v_rot = 0, where both are 0)."""
    lam, flux = _spectrum()
    target_j = jpp.rotation_broadening_jax(VEL_PIX, jnp.asarray(flux), 23.0, half_width_pix=16)

    def loss_j(v, ld):
        model = jpp.rotation_broadening_jax(VEL_PIX, jnp.asarray(flux), v, limb_darkening=ld,
                                            half_width_pix=16)
        return jnp.sum((model - target_j) ** 2)

    ref = [float(g) for g in jax.grad(loss_j, argnums=(0, 1))(v_rot, 0.6)]
    f, target = torch.from_numpy(flux), torch.from_numpy(np.array(target_j))
    v = torch.tensor(v_rot, dtype=torch.float64, requires_grad=True)
    ld = torch.tensor(0.6, dtype=torch.float64, requires_grad=True)
    _rotation_loss_torch(f, target, v, ld).backward()
    ours = [v.grad.item(), ld.grad.item()]
    assert np.isfinite(ours).all()
    # at v_rot = 0 the kernel is an exact delta: JAX's limb-darkening
    # derivative there is rounding (~5e-17), the port's exactly 0
    np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-14)
    if v_rot == 0.0:
        assert ours[0] == 0.0
        return
    eps = 1e-4
    with torch.no_grad():
        fd = [(_rotation_loss_torch(f, target, v_rot + eps, 0.6)
               - _rotation_loss_torch(f, target, v_rot - eps, 0.6)).item() / (2 * eps),
              (_rotation_loss_torch(f, target, v_rot, 0.6 + eps)
               - _rotation_loss_torch(f, target, v_rot, 0.6 - eps)).item() / (2 * eps)]
    np.testing.assert_allclose(ours, fd, rtol=1e-4)


@pytest.mark.parametrize("sigma", [2.5, 0.0, -2.5])
def test_instrumental_gradient_matches_jax(sigma):
    lam, flux = _spectrum()

    def loss_j(s):
        return jnp.sum(jpp.instrumental_broadening_jax(jnp.asarray(flux), s, radius_pix=24) ** 2)

    def loss_t(s):
        return torch.sum(tpp.instrumental_broadening_torch(torch.from_numpy(flux), s,
                                                           radius_pix=24) ** 2)

    ref = float(jax.grad(loss_j)(sigma))
    s = torch.tensor(sigma, dtype=torch.float64, requires_grad=True)
    loss_t(s).backward()
    assert np.isfinite(s.grad.item())
    np.testing.assert_allclose(s.grad.item(), ref, rtol=1e-10, atol=1e-300)
    out = tpp.instrumental_broadening_torch(torch.from_numpy(flux), sigma, radius_pix=24)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jpp.instrumental_broadening_jax(jnp.asarray(flux), sigma, radius_pix=24)), rtol=1e-12)
    if sigma == 0.0:
        np.testing.assert_allclose(out.numpy(), flux, rtol=1e-12)
        return
    eps = 1e-4
    with torch.no_grad():
        fd = (loss_t(sigma + eps) - loss_t(sigma - eps)).item() / (2 * eps)
    np.testing.assert_allclose(s.grad.item(), fd, rtol=1e-4)


def test_zero_rotation_is_identity():
    """v sin i = 0 returns the flux unchanged (default zero support and a
    wide static support), as the JAX functions do."""
    _, flux = _spectrum()
    f = torch.from_numpy(flux)
    np.testing.assert_allclose(tpp.rotation_broadening_torch(VEL_PIX, f, 0.0).numpy(), flux,
                               rtol=1e-12)
    np.testing.assert_allclose(
        tpp.rotation_broadening_torch(VEL_PIX, f, 0.0, half_width_pix=12).numpy(), flux,
        rtol=1e-12)
    np.testing.assert_allclose(tpp.instrumental_broadening_torch(f, 0.0).numpy(), flux,
                               rtol=1e-12)


def test_float32_matches_float64():
    """The port's float32 broadening against its float64 (the JAX test's
    bound: 2e-6 of the largest value)."""
    _, flux = _spectrum()
    f64 = torch.from_numpy(flux)
    f32 = f64.float()
    for fn in (lambda f: tpp.rotation_broadening_torch(VEL_PIX, f, 23.0, half_width_pix=12),
               lambda f: tpp.instrumental_broadening_torch(f, 2.5, radius_pix=24)):
        r64, r32 = fn(f64).numpy(), fn(f32).double().numpy()
        scale = np.abs(r64).max()
        np.testing.assert_allclose(r32 / scale, r64 / scale, atol=2e-6)


def test_padding_repeats_the_edge():
    """numpy's "symmetric" padding, also for supports wider than the
    spectrum."""
    x = torch.arange(5.0, dtype=torch.float64)
    for half in (2, 5, 7, 12):
        np.testing.assert_array_equal(tpp._symmetric_pad(x, half).numpy(),
                                      np.pad(x.numpy(), half, mode="symmetric"))


# ----------------------------------------------------------------------
# the fit of examples/fit_stellar_parameters.py, small, on the CPU
# ----------------------------------------------------------------------

HALF = 24  # static rotation support, as the example's


def test_fit_loss_and_gradient_match_jax(tmp_path):
    """Loss of the continuum-normalised, rotation-broadened surface spectrum
    against an 'observed' one made at (1.021, 11 km/s), at the start (1.0,
    5 km/s): the port's loss and gradient against JAX's value_and_grad at
    1e-8; then four Adam steps of the example's optimiser lower the loss."""
    from stardis_tpu import parse_config_to_model
    from stardis_tpu.constants import C_KMS
    from stardis_tpu.io.synthetic import write_marcs_file
    from stardis_tpu.pipeline import (
        build_simulation_plan,
        line_window_tiers,
        stage_plasma_and_lines,
        stage_spectrum,
    )
    from stardis_tpu_torch import pipeline as tpipe

    write_marcs_file(str(tmp_path / "sun.mod"))
    config = {
        "stardis_config_version": 1.0, "atom_data": "builtin:5",
        "input_model": {"type": "marcs", "fname": str(tmp_path / "sun.mod"),
                        "final_atomic_number": 5},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
                    "line": {"disable": False, "broadening": ["radiation"]}},
        "no_of_thetas": 3, "result_options": {},
    }
    (tmp_path / "c.yml").write_text(yaml.safe_dump(config))
    config, adata, model = parse_config_to_model(str(tmp_path / "c.yml"))
    lams = np.arange(6558.0, 6568.0, 0.05)
    nus = np.asarray(ju.Quantity(lams, ju.AA).to(ju.Hz, ju.spectral()))
    plan = build_simulation_plan(config, adata, model, nus)
    vel_pix = float(0.05 / lams.mean() * C_KMS)

    # the port
    tplan = tpipe.plan_from_reference(plan)
    consts = tpipe.device_constants(tplan, torch.float64, "cpu")
    temps0 = torch.tensor(tplan.temperatures)
    n_elem0 = torch.tensor(tplan.n_elem)

    def spectrum(scale, v_rot):
        state, lq = tpipe.stage_plasma_and_lines(tplan, temps0 * scale, n_elem0 / scale, consts)
        surface = tpipe.stage_spectrum(tplan, state, lq, consts)[0][-1]
        broadened = tpp.rotation_broadening_torch(vel_pix, surface, v_rot, half_width_pix=HALF)
        return broadened / broadened.mean()

    with torch.no_grad():
        observed = spectrum(1.021, 11.0)

    params = torch.tensor([1.0, 5.0], dtype=torch.float64, requires_grad=True)
    loss = torch.mean((spectrum(params[0], params[1]) - observed) ** 2)
    loss.backward()

    # JAX on the same observed spectrum, windows at the start's quantities
    temps_j, n_elem_j = jnp.asarray(plan.temperatures), jnp.asarray(plan.n_elem)
    window = line_window_tiers(plan, *reversed(stage_plasma_and_lines(plan, temps_j, n_elem_j)))

    def loss_j(p):
        state, lq = stage_plasma_and_lines(plan, temps_j * p[0], n_elem_j / p[0])
        surface = stage_spectrum(plan, state, lq, window=window)[0][-1]
        broadened = jpp.rotation_broadening_jax(vel_pix, surface, p[1], half_width_pix=HALF)
        return jnp.mean((broadened / broadened.mean() - jnp.asarray(observed.numpy())) ** 2)

    value, grad = jax.jit(jax.value_and_grad(loss_j))(jnp.asarray([1.0, 5.0]))
    np.testing.assert_allclose(loss.item(), float(value), rtol=1e-8)
    np.testing.assert_allclose(params.grad.numpy(), np.asarray(grad), rtol=1e-8)

    # the example's Adam, four steps
    pscale = torch.tensor([1.0, 300.0], dtype=torch.float64)
    m = v = torch.zeros(2, dtype=torch.float64)
    p = params.detach().clone()
    losses = []
    for i in range(4):
        p.requires_grad_()
        val = torch.mean((spectrum(p[0], p[1]) - observed) ** 2)
        (g,) = torch.autograd.grad(val, p)
        losses.append(val.item())
        g = g * pscale
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat, vhat = m / (1 - 0.9 ** (i + 1)), v / (1 - 0.999 ** (i + 1))
        p = (p - 3e-2 / (1.0 + 0.05 * i) * pscale * mhat / (torch.sqrt(vhat) + 1e-12)).detach()
    with torch.no_grad():
        losses.append(torch.mean((spectrum(p[0], p[1]) - observed) ** 2).item())
    assert losses[-1] < 0.5 * losses[0], losses
