"""Spherical geometry: the port against the JAX package in float64.

* ``calculate_spherical_ray`` exactly;
* the plain inward sweep (a Python loop over gaps) against JAX
  ``single_theta_trace(inward_rays=True)`` (an associative scan) and the
  NumPy loop oracle of tests/test_rt_solver.py, with no inward sweep, a
  chord that misses the inner shells (zero tau) and a ray straight
  through: 1e-12 against the oracle, 1e-7 against the scan (the bound the
  JAX package's own test allows its reassociated sum);
* the batched raytrace (per-model rays and corrections) at 1e-10;
* a spherical giant end to end, F_nu and I_nu at 1e-9.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import stardis_tpu  # noqa: E402
import stardis_tpu_torch  # noqa: E402
from stardis_tpu import units as ju  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.radiation_field import solver as jsolver  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.radiation_field import solver as tsolver  # noqa: E402
from test_rt_solver import _setup, numpy_reference_trace  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_calculate_spherical_ray_matches_jax():
    thetas, _ = tsolver.gauss_legendre_thetas(7)
    for radii in (np.array([1.0, 2.0, 3.0, 4.0]), 1e12 + np.linspace(0.0, 8e10, 30)):
        ours = tsolver.calculate_spherical_ray(thetas, radii)
        np.testing.assert_array_equal(ours, jsolver.calculate_spherical_ray(thetas, radii))
    assert (ours == 0).any() and (ours > 0).any()


@pytest.mark.parametrize("inward", ["none", "chord", "through"])
def test_inward_trace_matches_jax_and_oracle(inward):
    alphas, source, dist = _setup()
    taus = np.array(jsolver.compute_taus(jnp.asarray(alphas), jnp.asarray(dist)))
    if inward == "chord":
        taus[:2] = 0.0  # a chord that misses the inner shells
    flag = inward != "none"
    ours = tsolver.single_theta_trace(
        torch.from_numpy(source), torch.from_numpy(taus), inward_rays=flag
    ).numpy()
    oracle = numpy_reference_trace(dist, source, taus, inward_rays=flag)
    np.testing.assert_allclose(ours, oracle, rtol=1e-12, atol=1e-300)
    scan = np.asarray(
        jsolver.single_theta_trace(jnp.asarray(source), jnp.asarray(taus), inward_rays=flag)
    )
    np.testing.assert_allclose(ours, scan, rtol=1e-7, atol=1e-300)


def test_batched_spherical_raytrace_matches_jax():
    """Two models, each with its own spherical chords (some zero) and
    correction, through one batched call."""
    rng = np.random.default_rng(4)
    n_depth, n_nu = 24, 30
    thetas, weights = tsolver.gauss_legendre_thetas(5)
    alphas, sources, rays, corrs = [], [], [], []
    for b in range(2):
        alphas.append(10 ** rng.uniform(-12, -6, (n_depth, n_nu)))
        sources.append(10 ** rng.uniform(-6, -4, (n_depth, n_nu)))
        radii = 1e12 + np.linspace(0.0, 1e11 * (b + 1), n_depth)
        rays.append(tsolver.calculate_spherical_ray(thetas, radii))
        corrs.append(1.0 + 0.1 * (b + 1))
    assert (np.stack(rays) == 0).any()
    t = lambda a: torch.from_numpy(np.stack(a))  # noqa: E731
    f, i = tsolver.raytrace(t(alphas), t(sources), t(rays), torch.from_numpy(weights),
                            inward_rays=True, photospheric_correction=np.asarray(corrs),
                            track_individual_intensities=True)
    for b in range(2):
        f_ref, i_ref = jsolver.raytrace(
            jnp.asarray(alphas[b]), jnp.asarray(sources[b]), jnp.asarray(rays[b]),
            jnp.asarray(weights), inward_rays=True, photospheric_correction=corrs[b],
            track_individual_intensities=True,
        )
        np.testing.assert_allclose(f[b].numpy(), np.asarray(f_ref), rtol=1e-10, atol=1e-300)
        np.testing.assert_allclose(i[b].numpy(), np.asarray(i_ref), rtol=1e-10, atol=1e-300)


def test_spherical_giant_end_to_end_matches_jax(tmp_path):
    model = str(tmp_path / "giant.mod")
    write_marcs_file(model, teff=4000.0, logg=2.0, spherical=True, radius_cm=2e12)
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:8",
        "input_model": {"type": "marcs", "fname": model, "final_atomic_number": 8},
        "opacity": {
            "bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H", "H2"],
            "line": {"disable": False, "broadening": ["radiation", "linear_stark"]},
        },
        "no_of_thetas": 5,
        "result_options": {"return_radiation_field": True, "return_model": True},
    }
    path = tmp_path / "c.yml"
    path.write_text(yaml.safe_dump(cfg))
    lams = np.arange(6555.0, 6575.0, 0.1)
    ref = stardis_tpu.run_stardis(str(path), ju.Quantity(lams, ju.AA))
    ours = stardis_tpu_torch.run_stardis(copy.deepcopy(cfg), tu.Quantity(lams, tu.AA),
                                         device="cpu", dtype=torch.float64)
    assert ours.stellar_model.spherical
    rf, rf_ref = ours.stellar_radiation_field, ref.stellar_radiation_field
    np.testing.assert_allclose(rf.F_nu.numpy(), np.asarray(rf_ref.F_nu), rtol=1e-9, atol=1e-300)
    np.testing.assert_allclose(rf.I_nus.numpy(), np.asarray(rf_ref.I_nus), rtol=1e-9,
                               atol=1e-300)
    assert (np.asarray(ours.spectrum_nu) > 0).all()
