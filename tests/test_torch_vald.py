"""VALD text line lists in stardis_tpu_torch against the JAX package: the
native (C++) and Python parsers on the samples of tests/test_native_vald.py
(copied here) and on 10,000-line long and short files, column by column
against JAX's frame; which parser ran (``native.LAST_PARSER``); shortlist
detection setting the config flag; and an ``opacity.line.vald_linelist.
fname`` run on the CPU in float64 against JAX's at rtol 1e-9 and against
the same lines handed over in memory bit for bit."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import torch  # noqa: E402

import stardis_tpu  # noqa: E402
import stardis_tpu_torch  # noqa: E402
from stardis_tpu import units as ju  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.native import _read_python as jax_read_python  # noqa: E402
from stardis_tpu.native import read_vald_linelist as jax_read_vald  # noqa: E402
from stardis_tpu_torch import native  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.atom_data import build_builtin_atom_data  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_vald_linelist  # noqa: E402
from stardis_tpu_torch.opacities.lines import synth_linelist  # noqa: E402

RTOL = 1e-9
N_FILE_LINES = 10_000

VALD_LONG_SAMPLE = """\
                                                                   Lande factors      Damping parameters
Elm Ion      WL_air(A)   log gf* E_low(eV) J lo  E_up(eV) J up  lower  upper   mean   Rad.  Stark  Waals
'Fe 1',      6494.9804,  -1.273,  2.4040, 1.0,  4.3123, 2.0,  0.805,  1.316,  1.110, 8.200, -6.160, -7.790,
'Ca 1',      6493.7810,  -0.109,  2.5213, 2.0,  4.4300, 3.0,  1.100,  1.200,  1.150, 7.800, -5.900, -7.500,
'Si 2',      6500.1000,   0.250,  8.1210, 0.5, 10.0280, 1.5,  0.000,  1.330,  0.660, 8.500, -5.200, -7.200,
'XX 1',      6500.0000,   0.000,  0.0000, 0.0,  1.0000, 1.0,  0.0,    0.0,    0.0,   0.0,   0.0,    0.0,
 References: 1. Kurucz
"""

VALD_SHORT_SAMPLE = """\
Elm Ion       WL_air(A)  Excit(eV) log gf* Rad.   Stark   Waals
'Fe 1',       6494.9804,  2.4040, -1.273, 8.200, -6.160, -7.790,
'Ca 1',       6493.7810,  2.5213, -0.109, 7.800, -5.900, -7.500,
 References
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: (path, is_short)}: the two samples and the 10,000-line long
    and short files of a synthetic list, plus that list."""
    tmp = tmp_path_factory.mktemp("torch_vald")
    (tmp / "long_sample.txt").write_text(VALD_LONG_SAMPLE)
    (tmp / "short_sample.txt").write_text(VALD_SHORT_SAMPLE)
    lines = synth_linelist(build_builtin_atom_data(30), N_FILE_LINES).linelist_atoms
    write_vald_linelist(tmp / "long.txt", lines)
    write_vald_linelist(tmp / "short.txt", lines, shortlist=True)
    paths = {"long_sample": (tmp / "long_sample.txt", False),
             "short_sample": (tmp / "short_sample.txt", True),
             "long": (tmp / "long.txt", False), "short": (tmp / "short.txt", True)}
    return paths, lines


def _assert_table_matches_frame(table, frame):
    assert list(table.columns) == list(frame.columns)
    assert len(table) == len(frame)
    for col in frame.columns:
        ref = frame[col].values
        assert table[col].dtype == ref.dtype, col
        np.testing.assert_array_equal(table[col], ref, err_msg=col)


@pytest.mark.parametrize("name", ["long_sample", "short_sample", "long", "short"])
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_parsers_match_jax_frame(files, name, use_native):
    paths, _ = files
    path, short = paths[name]
    table, is_short = native.read_vald_linelist(path, use_native=use_native)
    assert native.LAST_PARSER == ("native" if use_native else "python")
    frame, ref_short = (jax_read_vald(path, use_native=True) if use_native
                        else jax_read_python(str(path)))
    assert is_short is ref_short is short
    _assert_table_matches_frame(table, frame)
    assert table["atomic_number"].dtype == table["ion_charge"].dtype == np.int64
    if short:
        assert not {"j_lo", "e_up", "j_up"} & set(table.columns)


def test_long_sample_values(files):
    paths, _ = files
    table, _ = native.read_vald_linelist(paths["long_sample"][0])
    assert len(table) == 3  # 'XX 1' skipped (unknown species)
    np.testing.assert_array_equal(table["atomic_number"], [26, 20, 14])
    np.testing.assert_array_equal(table["ion_charge"], [0, 0, 1])
    assert table["wavelength"][0] == 6494.9804 and table["waals"][0] == -7.79


@pytest.mark.parametrize("name", ["long", "short"])
def test_files_give_back_the_lines_bit_for_bit(files, name):
    """17 significant digits round-trip: both parsers return the written
    list's own columns."""
    paths, lines = files
    for use_native in (True, False):
        table, _ = native.read_vald_linelist(paths[name][0], use_native=use_native)
        for col in table.columns:
            np.testing.assert_array_equal(table[col], lines[col], err_msg=col)


def test_fallback_when_the_build_fails(files, monkeypatch, caplog):
    paths, _ = files

    def broken():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(native, "_load_library", broken)
    table, is_short = native.read_vald_linelist(paths["long_sample"][0])
    assert native.LAST_PARSER == "python" and not is_short and len(table) == 3
    assert "native VALD parser unavailable" in caplog.text


def _config(model_path, vald_path):
    return {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": str(model_path), "final_atomic_number": 30},
        "opacity": {
            "bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
            "line": {
                "disable": False,
                "broadening": ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"],
                "vald_linelist": {"use_linelist": True, "use_vald_broadening": True,
                                  "fname": str(vald_path)},
            },
        },
        "no_of_thetas": 10,
    }


@pytest.mark.parametrize("name", ["long", "short", "long_sample", "short_sample"])
def test_shortlist_detection_sets_the_config_flag(files, tmp_path, name):
    paths, _ = files
    path, short = paths[name]
    model = tmp_path / "sun.mod"
    write_marcs_file(model)
    cfg = _config(model, path)
    yml = tmp_path / "c.yml"
    yml.write_text(yaml.safe_dump(cfg))
    config, adata, _ = stardis_tpu_torch.parse_config_to_model(cfg)
    ref_config, ref_adata, _ = stardis_tpu.parse_config_to_model(str(yml))
    assert native.LAST_PARSER == "native"
    assert (config.opacity.line.vald_linelist.shortlist
            is ref_config.opacity.line.vald_linelist.shortlist is short)
    _assert_table_matches_frame(adata.linelist_atoms, ref_adata.linelist_atoms)


@pytest.mark.parametrize("name", ["long", "short"])
def test_vald_file_run_matches_jax(files, tmp_path, name):
    paths, lines = files
    model = tmp_path / "sun.mod"
    write_marcs_file(model)
    cfg = _config(model, paths[name][0])
    yml = tmp_path / "c.yml"
    yml.write_text(yaml.safe_dump(cfg))
    lams = np.arange(6500.0, 6505.0, 0.01)
    ref = stardis_tpu.run_stardis(str(yml), ju.Quantity(lams, ju.AA))
    ours = stardis_tpu_torch.run_stardis(cfg, tu.Quantity(lams, tu.AA), device="cpu",
                                         dtype=torch.float64)
    flux = np.asarray(ours.spectrum_nu)
    assert np.isfinite(flux).all() and (flux > 0).all()
    np.testing.assert_allclose(flux, np.asarray(ref.spectrum_nu), rtol=RTOL)
    if name == "long":
        # the same lines handed over in memory: the same bits
        cfg["opacity"]["line"]["vald_linelist"].pop("fname")
        adata = build_builtin_atom_data(30, include_linelists=True,
                                        include_molecules=True)
        adata.linelist_atoms = lines
        mem = stardis_tpu_torch.run_stardis(cfg, tu.Quantity(lams, tu.AA), device="cpu",
                                            dtype=torch.float64, atom_data=adata)
        np.testing.assert_array_equal(flux, np.asarray(mem.spectrum_nu))
