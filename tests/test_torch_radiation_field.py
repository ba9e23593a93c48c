"""``stardis_tpu_torch.radiation_field.create_stellar_radiation_field``
against the JAX package's, for the caller's frequencies ascending,
descending and shuffled, with and without I_nu: F_nu and I_nu at 1e-9
relative, the total and every per-source opacity at 1e-9; and against the
port's own ``run_stardis`` on the same configuration, its outputs permuted
to the caller's order, bit for bit."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import torch  # noqa: E402

from stardis_tpu.base import parse_config_to_model as jax_parse  # noqa: E402
from stardis_tpu.radiation_field import (  # noqa: E402
    create_stellar_radiation_field as jax_create,
)
from stardis_tpu_torch import run_stardis  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.base import parse_config_to_model  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu_torch.radiation_field import (  # noqa: E402
    RadiationField,
    create_stellar_radiation_field,
)

RTOL = 1e-9
LAMBDA = (5885.0, 5900.0, 0.1)  # AA: Na D and the builtin list's metal lines
ORDERS = ("ascending", "descending", "shuffled")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_radiation_field") / "sun.mod"
    write_marcs_file(path)
    return path


def config(model_path, with_i):
    return {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": str(model_path), "final_atomic_number": 30},
        "opacity": {
            "bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
            "disable_electron_scattering": False,
            "line": {"disable": False,
                     "broadening": ["radiation", "linear_stark", "quadratic_stark",
                                    "van_der_waals"],
                     "vald_linelist": {"use_linelist": True, "use_vald_broadening": True}},
        },
        "no_of_thetas": 6,
        "result_options": {"return_radiation_field": with_i},
    }


def caller_nus(order):
    nus = np.sort(np.asarray(tu.Quantity(np.arange(*LAMBDA), tu.AA).to(tu.Hz, tu.spectral())))
    if order == "descending":
        return nus[::-1].copy()
    if order == "shuffled":
        return np.random.default_rng(14).permutation(nus)
    return nus


def assert_close(ours, ref, what):
    ref = np.asarray(ref, dtype=np.float64)
    assert ours.shape == ref.shape, what
    np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=0.0, err_msg=what)


@pytest.mark.parametrize("with_i", [False, True], ids=["F_nu", "F_nu and I_nu"])
@pytest.mark.parametrize("order", ORDERS)
def test_matches_jax(model_path, order, with_i, tmp_path):
    nus = caller_nus(order)
    cfg = config(model_path, with_i)
    c, adata, model = parse_config_to_model(cfg)
    ours = create_stellar_radiation_field(nus, model, adata, c, device="cpu",
                                          dtype=torch.float64)
    yml = tmp_path / "config.yml"
    yml.write_text(yaml.safe_dump(cfg))
    j_config, j_adata, j_model = jax_parse(str(yml))
    ref = jax_create(nus, j_model, j_adata, j_config)
    assert isinstance(ours, RadiationField)
    np.testing.assert_array_equal(ours.frequencies, nus)
    assert_close(ours.F_nu, ref.F_nu, "F_nu")
    assert_close(ours.opacities.total_alphas, ref.opacities.total_alphas, "total")
    assert sorted(ours.opacities.opacities_dict) == sorted(ref.opacities.opacities_dict)
    for key, value in ours.opacities.opacities_dict.items():
        assert_close(value, ref.opacities.opacities_dict[key], key)
    if with_i:
        assert_close(ours.I_nus, ref.I_nus, "I_nu")
    else:
        assert ours.I_nus is None and ref.I_nus is None
    np.testing.assert_allclose(ours.thetas, ref.thetas, rtol=1e-15)
    np.testing.assert_allclose(ours.I_nus_weights, ref.I_nus_weights, rtol=1e-15)


@pytest.mark.parametrize("order", ORDERS)
def test_equals_run_stardis_permuted(model_path, order):
    """The same configuration through run_stardis (its grid descending),
    permuted to the caller's order: equal bit for bit."""
    nus = caller_nus(order)
    cfg = config(model_path, True)
    c, adata, model = parse_config_to_model(cfg)
    ours = create_stellar_radiation_field(nus, model, adata, c, device="cpu",
                                          dtype=torch.float64)
    run = run_stardis(cfg, tu.Quantity(nus, tu.Hz), device="cpu", dtype=torch.float64)
    field = run.stellar_radiation_field
    grid = np.asarray(field.frequencies)
    perm = torch.as_tensor(np.searchsorted(-grid, -nus))
    np.testing.assert_array_equal(grid[perm.numpy()], nus)
    assert torch.equal(ours.F_nu, field.F_nu[:, perm])
    assert torch.equal(ours.opacities.total_alphas, field.opacities.total_alphas[:, perm])
    assert torch.equal(ours.I_nus, field.I_nus[:, perm])
    for key, value in field.opacities.opacities_dict.items():
        if value.dim() == 2 and value.shape[1] == len(nus):
            value = value[:, perm]
        assert torch.equal(ours.opacities.opacities_dict[key], value), key


def test_refuses_a_missing_card(model_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    c, adata, model = parse_config_to_model(config(model_path, False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_stellar_radiation_field(caller_nus("ascending"), model, adata, c)
