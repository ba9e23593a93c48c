"""``python -m stardis_tpu_torch`` against ``python -m stardis_tpu``, on the
CPU (--cpu, float64): the ASCII tables of one-shot runs (unsegmented, 3
segments and 'auto') and of grid scans at 1e-9; --set overrides; the
errors on bad arguments; --output (HDF5) read back against the JAX CLI's
file."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import torch  # noqa: E402

from stardis_tpu.__main__ import main as jax_main  # noqa: E402
from stardis_tpu.grid import load_grid as jax_load_grid  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu_torch.__main__ import main  # noqa: E402
from stardis_tpu_torch.grid import load_grid  # noqa: E402

LAMBDA = "6560:6570:0.1"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def configs(tmp_path):
    """tests/test_cli.py's config as JSON (the port) and YAML (JAX)."""
    model = tmp_path / "sun.mod"
    write_marcs_file(model)
    config = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:5",
        "input_model": {"type": "marcs", "fname": str(model), "final_atomic_number": 5},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
                    "line": {"disable": False, "broadening": ["radiation"]}},
        "no_of_thetas": 4,
        "result_options": {},
    }
    (tmp_path / "config.json").write_text(json.dumps(config))
    (tmp_path / "config.yml").write_text(yaml.safe_dump(config))
    return str(tmp_path / "config.json"), str(tmp_path / "config.yml")


@pytest.mark.parametrize("segments", ["1", "3", "auto"])
def test_ascii_table_matches_jax_cli(configs, tmp_path, capsys, segments):
    ours, ref = tmp_path / "ours.txt", tmp_path / "ref.txt"
    extra = ["--segments", segments, "--set", "opacity.rayleigh=[]"]
    assert jax_main([configs[1], "--lambda", LAMBDA, "--cpu", "--ascii", str(ref), *extra]) == 0
    assert main([configs[0], "--lambda", LAMBDA, "--cpu", "--ascii", str(ours), *extra]) == 0
    out = capsys.readouterr().out
    assert "synthesized 100 points" in out and "on cpu" in out
    table, table_ref = np.loadtxt(ours), np.loadtxt(ref)
    assert table.shape == (100, 2)
    np.testing.assert_array_equal(table[:, 0], table_ref[:, 0])
    np.testing.assert_allclose(table[:, 1], table_ref[:, 1], rtol=1e-9)


def test_grid_scan_matches_jax_cli(configs, tmp_path, capsys):
    model_dir = tmp_path / "models"
    model_dir.mkdir()
    for teff in (5000.0, 5777.0, 6500.0):
        write_marcs_file(model_dir / f"t{int(teff)}.mod", teff=teff)
    (model_dir / "README.txt").write_text("not a model")
    args = ["--lambda", "6560:6566:0.1", "--cpu", "--grid", str(model_dir), "--batch-size", "2"]
    assert jax_main([configs[1], *args, "--scan-out", str(tmp_path / "ref")]) == 0
    assert main([configs[0], *args, "--scan-out", str(tmp_path / "ours")]) == 0
    out = capsys.readouterr().out
    assert "grid scan complete: 3 models" in out and "2 chunk(s) computed" in out
    spectra, nus, labels = load_grid(tmp_path / "ours")
    ref, ref_nus, _ = jax_load_grid(tmp_path / "ref")
    assert spectra.shape == (3, 60) and labels[0]["fname"].endswith("t5000.mod")
    np.testing.assert_allclose(spectra, ref, rtol=1e-9)
    np.testing.assert_array_equal(nus, ref_nus)
    assert main([configs[0], *args, "--scan-out", str(tmp_path / "ours")]) == 0
    assert "0 chunk(s) computed (+2 resumed)" in capsys.readouterr().out


def test_bad_arguments_raise(configs, tmp_path):
    cfg = configs[0]
    for bad in ("6560", "6570:6560:0.1"):
        with pytest.raises(SystemExit):
            main([cfg, "--lambda", bad, "--cpu"])
    with pytest.raises(SystemExit, match="integer or 'auto'"):
        main([cfg, "--lambda", LAMBDA, "--cpu", "--segments", "every"])
    with pytest.raises(SystemExit, match="scan-out"):
        main([cfg, "--lambda", LAMBDA, "--cpu", "--grid", str(tmp_path)])
    with pytest.raises(SystemExit, match="not supported with --grid"):
        main([cfg, "--lambda", LAMBDA, "--cpu", "--grid", str(tmp_path),
              "--scan-out", str(tmp_path / "o"), "--segments", "auto"])
    with pytest.raises(SystemExit, match="--set expects"):
        main([cfg, "--lambda", LAMBDA, "--cpu", "--set", "opacity.rayleigh"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([cfg, "--lambda", LAMBDA])


def test_output_writes_hdf_read_back(configs, tmp_path, capsys):
    """--output writes the spectra to HDF5; read back, they equal the JAX
    CLI's file at 1e-9 and the ASCII table's columns."""
    h5py = pytest.importorskip("h5py")
    ours, ref, table = tmp_path / "ours.h5", tmp_path / "ref.h5", tmp_path / "t.txt"
    assert jax_main([configs[1], "--lambda", LAMBDA, "--cpu", "--output", str(ref)]) == 0
    assert main([configs[0], "--lambda", LAMBDA, "--cpu", "--output", str(ours),
                 "--ascii", str(table)]) == 0
    assert f"wrote {ours}" in capsys.readouterr().out
    with h5py.File(ours, "r") as f, h5py.File(ref, "r") as g:
        assert f.attrs["format"] == g.attrs["format"] == "stardis_tpu_output_v1"
        assert sorted(f["spectrum"]) == sorted(g["spectrum"]) == [
            "lambdas", "nus", "spectrum_lambda", "spectrum_nu"]
        for name in f["spectrum"]:
            np.testing.assert_allclose(f["spectrum"][name][()], g["spectrum"][name][()],
                                       rtol=1e-9, err_msg=name)
        lam, f_lam = f["spectrum/lambdas"][()], f["spectrum/spectrum_lambda"][()]
    np.testing.assert_array_equal(np.loadtxt(table), np.column_stack([lam, f_lam]))
