"""MESA models in stardis_tpu_torch against the JAX package: the synthetic
MESA writer byte for byte, the reader's metadata and shell table exactly,
truncation, ``to_stellar_model`` exactly, ``truncate_to_shell``'s checks,
and ``run_stardis`` on the CPU in float64 against JAX's at rtol 1e-9 (the
config of tests/test_mesa.py, and 80 shells with lines)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import torch  # noqa: E402

import stardis_tpu  # noqa: E402
import stardis_tpu_torch  # noqa: E402
from stardis_tpu import units as ju  # noqa: E402
from stardis_tpu.atom_data import build_builtin_atom_data as jax_atom_data  # noqa: E402
from stardis_tpu.io.mesa import read_mesa_model as jax_read_mesa  # noqa: E402
from stardis_tpu.io.synthetic import write_mesa_file as jax_write_mesa  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.atom_data import build_builtin_atom_data  # noqa: E402
from stardis_tpu_torch.io.mesa import read_mesa_model  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_mesa_file  # noqa: E402

RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesa_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_mesa") / "star.mod"
    write_mesa_file(path, teff=5777.0, n_shells=80)
    return path


@pytest.mark.parametrize("kwargs", [{}, {"teff": 4500.0, "logg": 2.5, "n_shells": 37}])
def test_mesa_writer_bytes_match_jax(tmp_path, kwargs):
    write_mesa_file(tmp_path / "ours.mod", **kwargs)
    jax_write_mesa(tmp_path / "ref.mod", **kwargs)
    assert (tmp_path / "ours.mod").read_bytes() == (tmp_path / "ref.mod").read_bytes()


def _assert_model_equal(ours, ref):
    np.testing.assert_array_equal(ours.zone, ref.data.index.values)
    assert list(ours.data) == list(ref.data.columns)
    for col in ref.data.columns:
        np.testing.assert_array_equal(ours.data[col], ref.data[col].values, err_msg=col)


def test_reader_matches_jax_exactly(mesa_path):
    ours, ref = read_mesa_model(mesa_path), jax_read_mesa(mesa_path)
    assert list(ours.metadata) == list(ref.metadata)
    for key, value in ref.metadata.items():
        mine = ours.metadata[key]
        if hasattr(value, "unit"):
            assert str(mine.unit) == str(value.unit), key
            assert float(mine.value) == float(value.value), key
        else:
            assert mine == value and type(mine) is type(value), key
    assert ours.metadata["Number of Shells"] == 80 and len(ours) == 80
    _assert_model_equal(ours, ref)


def test_reader_takes_an_unnamed_zone_column(mesa_path, tmp_path):
    """MESA's own files leave the zone column unnamed in the header."""
    lines = mesa_path.read_text().splitlines()
    lines[23] = lines[23].replace("zone", "    ")
    path = tmp_path / "unnamed.mod"
    path.write_text("\n".join(lines) + "\n")
    ours, ref = read_mesa_model(path), jax_read_mesa(path)
    assert list(ours.data) == ["lnd", "lnT", "lnR", "L", "dq"]
    _assert_model_equal(ours, ref)


@pytest.mark.parametrize("shells", [30, 1, 80, 200])
def test_truncation_matches_jax(mesa_path, shells):
    ours, ref = read_mesa_model(mesa_path), jax_read_mesa(mesa_path)
    ours.truncate_model(shells)
    ref.truncate_model(shells)
    assert len(ours) == min(shells, 80)
    _assert_model_equal(ours, ref)


@pytest.mark.parametrize("z_max, truncate", [(30, None), (5, 30)])
def test_to_stellar_model_matches_jax_exactly(mesa_path, z_max, truncate):
    ours = read_mesa_model(mesa_path).to_stellar_model(
        build_builtin_atom_data(30), truncate_to_shell_number=truncate,
        final_atomic_number=z_max)
    ref = jax_read_mesa(mesa_path).to_stellar_model(
        jax_atom_data(30), truncate_to_shell_number=truncate, final_atomic_number=z_max)
    assert ours.no_of_depth_points == ref.no_of_depth_points == (truncate or 80)
    np.testing.assert_array_equal(np.asarray(ours.temperatures), np.asarray(ref.temperatures))
    np.testing.assert_array_equal(np.asarray(ours.geometry.r), np.asarray(ref.geometry.r))
    np.testing.assert_array_equal(np.asarray(ours.composition.density),
                                  np.asarray(ref.composition.density))
    mf = ref.composition.nuclide_mass_fraction
    np.testing.assert_array_equal(ours.composition.atomic_numbers, mf.index.values)
    np.testing.assert_array_equal(ours.composition.nuclide_mass_fraction, mf.values)
    np.testing.assert_array_equal(ours.composition.elemental_number_density,
                                  ref.composition.elemental_number_density.values)
    assert ours.spherical is ref.spherical is False


def _config(mesa_path, with_lines):
    if with_lines:
        line = {"disable": False,
                "broadening": ["radiation", "linear_stark", "quadratic_stark",
                               "van_der_waals"],
                "vald_linelist": {"use_linelist": True, "use_vald_broadening": True}}
        return {
            "stardis_config_version": 1.0, "atom_data": "builtin:30",
            "input_model": {"type": "mesa", "fname": str(mesa_path),
                            "final_atomic_number": 30},
            "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
                        "line": line},
            "no_of_thetas": 10,
            "result_options": {"return_model": True, "return_plasma": True},
        }
    # tests/test_mesa.py's end-to-end config
    return {
        "stardis_config_version": 1.0, "atom_data": "builtin:5",
        "input_model": {"type": "mesa", "fname": str(mesa_path),
                        "final_atomic_number": 5, "truncate_to_shell": 40},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}},
                    "line": {"disable": False, "broadening": []}},
        "no_of_thetas": 3,
        "result_options": {"return_model": True},
    }


@pytest.mark.parametrize("with_lines", [False, True], ids=["test_mesa_config", "80_shells_lines"])
def test_run_stardis_matches_jax(mesa_path, tmp_path, with_lines):
    cfg = _config(mesa_path, with_lines)
    path = tmp_path / "mesa.yml"
    path.write_text(yaml.safe_dump(cfg))
    lams = np.arange(5885.0, 5900.0, 0.05) if with_lines else np.arange(6560, 6570, 0.1)
    ref = stardis_tpu.run_stardis(str(path), ju.Quantity(lams, ju.AA))
    ours = stardis_tpu_torch.run_stardis(cfg, tu.Quantity(lams, tu.AA), device="cpu",
                                         dtype=torch.float64)
    flux = np.asarray(ours.spectrum_nu)
    assert np.isfinite(flux).all() and (flux > 0).all()
    np.testing.assert_allclose(flux, np.asarray(ref.spectrum_nu), rtol=RTOL)
    np.testing.assert_allclose(np.asarray(ours.spectrum_lambda),
                               np.asarray(ref.spectrum_lambda), rtol=RTOL)
    assert ours.stellar_model.no_of_depth_points == ref.stellar_model.no_of_depth_points
    assert ours.stellar_model.no_of_depth_points == (80 if with_lines else 40)
    if with_lines:
        np.testing.assert_allclose(ours.stellar_plasma.electron_densities.numpy(),
                                   np.asarray(ref.stellar_plasma.electron_densities),
                                   rtol=RTOL)


@pytest.mark.parametrize("shells", [-5, -1])
def test_truncate_to_shell_errors_match_jax(mesa_path, tmp_path, shells):
    cfg = _config(mesa_path, False)
    cfg["input_model"]["truncate_to_shell"] = shells
    path = tmp_path / "mesa.yml"
    path.write_text(yaml.safe_dump(cfg))
    lam = np.arange(6560.0, 6561.0, 0.5)
    message = f"{shells} shells requested for mesa truncation; -99 means no truncation."
    with pytest.raises(ValueError) as ref:
        stardis_tpu.run_stardis(str(path), ju.Quantity(lam, ju.AA))
    with pytest.raises(ValueError) as ours:
        stardis_tpu_torch.run_stardis(cfg, tu.Quantity(lam, tu.AA), device="cpu",
                                      dtype=torch.float64)
    assert str(ours.value) == str(ref.value) == message


def test_no_truncation_by_default(mesa_path):
    cfg = _config(mesa_path, False)
    cfg["input_model"].pop("truncate_to_shell")
    _, _, model = stardis_tpu_torch.parse_config_to_model(cfg)
    assert model.no_of_depth_points == 80
