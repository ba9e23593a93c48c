"""stardis_tpu_torch against the JAX package's committed golden stores
(tests/golden/), read with the port's ``util.regression.RegressionData``:
solar_halpha (tests/test_golden_regression.py's run) and every array of
solar_nad_plasma (tests/test_golden_plasma.py's) on the CPU in float64 at
the stores' rtol 1e-6, and in float32 at ``util.regression``'s float32
bars (the bars chip_smoke.py holds the card's float32 run to); the
kurucz-scale store carsus_scale.npz through the port's ``AtomData.from_hdf``
of the store that the JAX package's synthetic_carsus and converter write
(as tests/test_carsus_scale.py does); and RegressionData's own modes."""

import hashlib
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("h5py")
import torch  # noqa: E402

import stardis_tpu_torch  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.atom_data import AtomData  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu_torch.util.regression import (  # noqa: E402
    GOLDEN_RTOL,
    RegressionData,
    f32_kind,
    f32_ratio,
    golden_arrays,
)

GOLDEN_DIR = Path(__file__).parent / "golden"
STORES = ("solar_halpha", "solar_nad_plasma")
N_CARSUS_LINES = 150_000


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
    path = tmp_path_factory.mktemp("torch_golden") / "sun.mod"
    write_marcs_file(path)
    return path


@pytest.fixture(scope="module")
def port_arrays(model_path):
    """{(store, dtype): arrays} of the port's CPU runs."""
    return {(key, dtype): golden_arrays(key, model_path, "cpu", dtype)
            for key in STORES for dtype in (torch.float64, torch.float32)}


@pytest.mark.parametrize("key", STORES)
def test_float64_matches_golden_store(port_arrays, key):
    arrays = port_arrays[key, torch.float64]
    rd = RegressionData(GOLDEN_DIR, key, rtol=GOLDEN_RTOL)
    assert sorted(arrays) == sorted(rd.keys())
    for name, value in arrays.items():
        rd.sync_ndarray(name, value)


@pytest.mark.parametrize("key", STORES)
def test_float32_within_its_bars(port_arrays, key):
    arrays = port_arrays[key, torch.float32]
    rd = RegressionData(GOLDEN_DIR, key, rtol=GOLDEN_RTOL)
    assert sorted(arrays) == sorted(rd.keys())
    ratios = {name: f32_ratio(name, value, rd[name]) for name, value in arrays.items()}
    bad = {name: (f32_kind(name), r) for name, r in ratios.items() if not r <= 1.0}
    assert not bad, f"float32 arrays beyond their bars (kind, worst err / bound): {bad}"
    for name in ("F_nu", "ion_number_density", "phi", "electron_densities"):
        if name in arrays:
            assert arrays[name].dtype == np.float32, name


def test_float32_bars_catch_a_wrong_array():
    """Each kind of bar fails an array off by more than it allows."""
    ref = RegressionData(GOLDEN_DIR, "solar_nad_plasma")
    for name, scale in (("F_nu", 1 + 2e-3), ("partition_function", 1 + 3e-4),
                        ("ion_number_density", 1 + 2e-4), ("chi", 1 + 1e-5)):
        assert f32_ratio(name, ref[name], ref[name]) == 0.0
        assert f32_ratio(name, ref[name] * scale, ref[name]) > 1.0, name


@pytest.fixture(scope="module")
def carsus_store(tmp_path_factory):
    """The kurucz-scale carsus store of tests/test_carsus_scale.py, written
    and converted by the JAX package into a temporary directory."""
    from stardis_tpu.atom_data.convert import main as convert_main
    from stardis_tpu.atom_data.synthetic_carsus import build_carsus_frames, write_store

    base = tmp_path_factory.mktemp("torch_carsus_scale")
    carsus_path, native_path = base / "carsus_synth.h5", base / "native.h5"
    write_store(build_carsus_frames(n_lines=N_CARSUS_LINES), carsus_path)
    assert convert_main([str(carsus_path), str(native_path)]) == 0
    return native_path


def test_carsus_scale_store_matches_golden(carsus_store, model_path):
    adata = AtomData.from_hdf(carsus_store)
    assert len(adata.lines) == N_CARSUS_LINES and len(adata.linelist_atoms) == 120_000
    config = {
        "stardis_config_version": 1.0,
        "atom_data": str(carsus_store),
        "input_model": {"type": "marcs", "fname": str(model_path), "final_atomic_number": 30},
        "opacity": {
            "bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
            "disable_electron_scattering": False,
            "line": {
                "disable": False,
                "broadening": ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"],
                "vald_linelist": {"use_linelist": True, "use_vald_broadening": True},
            },
        },
        "no_of_thetas": 10,
        "result_options": {"return_plasma": True},
    }
    out = stardis_tpu_torch.run_stardis(
        config, tu.Quantity(np.arange(5150.0, 5170.0, 0.02), tu.AA), device="cpu",
        dtype=torch.float64)
    wl = adata.linelist_atoms.wavelength
    n_window = int(((wl >= 5150.0) & (wl <= 5170.0)).sum())
    assert n_window > 200
    flux = np.asarray(out.spectrum_nu)
    assert np.isfinite(flux).all() and (flux > 0).all()
    rd = RegressionData(GOLDEN_DIR, "carsus_scale", rtol=GOLDEN_RTOL)
    assert sorted(rd.keys()) == ["electron_densities", "n_lines_in_window", "nus",
                                 "spectrum_nu"]
    rd.sync_ndarray("nus", np.asarray(out.nus))
    rd.sync_ndarray("spectrum_nu", flux)
    rd.sync_scalar("n_lines_in_window", n_window)
    rd.sync_ndarray("electron_densities", out.stellar_plasma.electron_densities.numpy())


def _digest(directory):
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(Path(directory).iterdir())}


def test_regression_data_modes(tmp_path):
    before = _digest(GOLDEN_DIR)
    with pytest.raises(FileNotFoundError, match="missing"):
        RegressionData(GOLDEN_DIR, "no_such_store")
    with pytest.raises(FileNotFoundError):
        RegressionData(tmp_path, "solar_halpha")
    values = np.linspace(1.0, 2.0, 7)
    with RegressionData(tmp_path / "new", "store", generate=True) as rd:
        assert rd.sync_ndarray("values", values) is not None
        rd.sync_scalar("count", 7)
    assert sorted(p.name for p in (tmp_path / "new").iterdir()) == ["store.npz"]
    rd = RegressionData(tmp_path / "new", "store", rtol=1e-6)
    rd.sync_ndarray("values", values * (1 + 5e-7))
    rd.sync_scalar("count", 7)
    with pytest.raises(AssertionError, match="store/values"):
        rd.sync_ndarray("values", values * (1 + 2e-6))
    assert _digest(GOLDEN_DIR) == before
