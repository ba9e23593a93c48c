"""The carsus tools of stardis_tpu_torch (``atom_data.synthetic_carsus``,
``atom_data.table_format``, ``atom_data.convert``) against the JAX
package's: the synthetic kurucz-scale tables equal JAX's frames column by
column, exactly; stores of both pandas layouts (and a mixed one) written
by either package read by the other to the same tables; the converter's
units, derived columns and missing-level NaN; the port's ``convert``
output read by JAX's ``AtomData.from_hdf`` equal to JAX's converter's,
table for table, exactly, for a small store and the 150,000-line one; the
verify report; and the kurucz-scale store run through the port against
tests/golden/carsus_scale.npz.  JAX's pandas frames are flattened to NumPy
columns here; the port sees no pandas."""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
pd = pytest.importorskip("pandas")
import torch  # noqa: E402

from stardis_tpu.atom_data import convert as jcv  # noqa: E402
from stardis_tpu.atom_data import synthetic_carsus as jsc  # noqa: E402
from stardis_tpu.atom_data import table_format as jtf  # noqa: E402
from stardis_tpu.atom_data.base import AtomData as JaxAtomData  # noqa: E402
from stardis_tpu_torch import run_stardis  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.atom_data import convert as cv  # noqa: E402
from stardis_tpu_torch.atom_data import synthetic_carsus as sc  # noqa: E402
from stardis_tpu_torch.atom_data import table_format as tf  # noqa: E402
from stardis_tpu_torch.atom_data.base import AtomData, Table  # noqa: E402
from stardis_tpu_torch.constants import AMU_CGS, C_CGS, EV_TO_ERG  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu_torch.util.regression import (  # noqa: E402
    GOLDEN_LAMBDAS,
    GOLDEN_RTOL,
    RegressionData,
    f32_ratio,
    golden_arrays,
    golden_config,
)

GOLDEN_DIR = Path(__file__).parent / "golden"
SMALL = {"z_max": 8, "n_lines": 5_000, "n_vald_lines": 4_000, "levels_per_ion": 40}
FRAME_CASES = {
    "small": SMALL,
    "small, no molecules": dict(SMALL, include_molecules=False),
    "defaults": {},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# pandas <-> Table, in the test only


def to_table(obj):
    """A JAX-side DataFrame / Series as the port's Table: named index
    levels as leading columns, a Series as one value column."""
    series = isinstance(obj, pd.Series)
    frame = obj.to_frame("values" if obj.name is None else obj.name) if series else obj
    named = [n for n in frame.index.names if n is not None]
    flat = frame.reset_index(drop=not named)
    return Table({c: np.asarray(flat[c]) for c in flat.columns}, index_cols=named,
                 series=series)


def assert_columns_equal(ours, ref, what):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, what
    if ours.dtype.kind in "OUS" or ref.dtype.kind in "OUS":
        assert [str(v) for v in ours] == [str(v) for v in ref], what
    else:
        assert ours.dtype == ref.dtype, (what, ours.dtype, ref.dtype)
        np.testing.assert_array_equal(ours, ref, err_msg=what)


def assert_tables_equal(ours, ref, what=""):
    assert list(ours.columns) == list(ref.columns), what
    assert ours.index_cols == ref.index_cols, what
    assert ours.series == ref.series, what
    for col in ref.columns:
        assert_columns_equal(ours[col], ref[col], f"{what}/{col}")


def assert_frames_equal(ours: dict, ref: dict):
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert_tables_equal(ours[key], ref[key], key)


def assert_jax_frames_equal(ours: dict, ref: dict):
    assert sorted(ours) == sorted(ref)
    for key, obj in ref.items():
        if isinstance(obj, pd.Series):
            pd.testing.assert_series_equal(ours[key], obj, check_exact=True)
        else:
            pd.testing.assert_frame_equal(ours[key], obj, check_exact=True)


def jax_toy_frames():
    """tests/test_convert.py's carsus-shaped frames (u, eV, AA)."""
    atom_data = pd.DataFrame(
        {"symbol": ["H", "He"], "name": ["hydrogen", "helium"], "mass": [1.00794, 4.002602]},
        index=pd.Index([1, 2], name="atomic_number"))
    ionization_data = pd.Series(
        [13.598434, 24.587387, 54.417760],
        index=pd.MultiIndex.from_tuples([(1, 1), (2, 1), (2, 2)],
                                        names=["atomic_number", "ion_number"]),
        name="ionization_energy")
    levels = pd.DataFrame(
        {"energy": [0.0, 10.1988, 0.0, 0.0, 19.8196], "g": [2, 8, 1, 1, 3],
         "metastable": [True, False, True, True, False]},
        index=pd.MultiIndex.from_tuples(
            [(1, 0, 0), (1, 0, 1), (1, 1, 0), (2, 0, 0), (2, 0, 1)],
            names=["atomic_number", "ion_number", "level_number"]))
    lines = pd.DataFrame({"atomic_number": [1], "ion_number": [0], "level_number_lower": [0],
                          "level_number_upper": [1], "wavelength": [1215.67], "gf": [0.8324]})
    linelist_atoms = pd.DataFrame(
        {"atomic_number": [26], "ion_charge": [0], "wavelength": [5250.2], "log_gf": [-4.9],
         "e_low": [0.121], "e_up": [2.48], "j_lo": [0.0], "j_up": [1.0], "rad": [7.8],
         "stark": [-6.2], "waals": [-7.8]})
    return {"atom_data": atom_data, "ionization_data": ionization_data, "levels": levels,
            "lines": lines, "linelist_atoms": linelist_atoms}


def toy_frames():
    return {k: to_table(v) for k, v in jax_toy_frames().items()}


def assert_atom_data_equal(ours: AtomData, ref: JaxAtomData):
    """The port's AtomData equal to JAX's, table for table, exactly (NaN
    equal to NaN)."""
    assert_tables_equal(ours.atom_data, Table(to_table(ref.atom_data).columns), "atom_data")
    ion = to_table(ref.ionization_data)
    assert_tables_equal(ours.ionization_data, Table(ion.columns), "ionization_data")
    assert_tables_equal(ours.levels, Table(to_table(ref.levels).columns), "levels")
    for col in ref.lines.columns:
        np.testing.assert_array_equal(ours.lines[col], np.asarray(ref.lines[col]),
                                      err_msg=f"lines/{col}")
        assert ours.lines[col].dtype == ref.lines[col].dtype, col
    assert list(ours.lines.columns) == list(ref.lines.columns)
    for name in ("linelist_atoms", "linelist_molecules"):
        if getattr(ref, name) is None:
            assert getattr(ours, name) is None
        else:
            assert_tables_equal(getattr(ours, name), to_table(getattr(ref, name)), name)
    if ref.molecule_data is None:
        assert ours.molecule_data is None
        return
    md, rmd = ours.molecule_data, ref.molecule_data
    eq, pf, de = (rmd.equilibrium_constants, rmd.partition_functions.loc[md.names],
                  rmd.dissociation_energies.loc[md.names])
    assert md.names == list(eq.index)
    np.testing.assert_array_equal(md.equilibrium_temperatures, eq.columns.astype(float))
    np.testing.assert_array_equal(md.log_equilibrium_constants, eq.values)
    np.testing.assert_array_equal(md.partition_temperatures, pf.columns.astype(float))
    np.testing.assert_array_equal(md.partition_functions, pf.values)
    assert md.ion1 == list(de.Ion1) and md.ion2 == list(de.Ion2)
    np.testing.assert_array_equal(md.dissociation_energies, de.dissociation_energy.values)


# ---------------------------------------------------------------------------
# the synthetic kurucz-scale tables


@pytest.mark.parametrize("case", FRAME_CASES)
def test_build_carsus_frames_equal_jax(case):
    kw = FRAME_CASES[case]
    ref = {k: to_table(v) for k, v in jsc.build_carsus_frames(**kw).items()}
    assert_frames_equal(sc.build_carsus_frames(**kw), ref)


# ---------------------------------------------------------------------------
# both store layouts, both ways


def write_port(layout, frames, path):
    if layout == "fixed":
        sc.write_store(frames, path)
    elif layout == "table":
        tf.write_table_store(frames, path)
    else:  # mixed: the element tables fixed, the rest in the table layout
        sc.write_store({k: frames[k] for k in ("atom_data", "ionization_data")}, path)
        with h5py.File(path, "a") as f:
            for logical, table in frames.items():
                if logical not in ("atom_data", "ionization_data"):
                    tf.write_table(f, tf.DEFAULT_KEYS.get(logical, logical), table)


def write_jax(layout, frames, path):
    if layout == "fixed":
        jsc.write_store(frames, path)
    elif layout == "table":
        jtf.write_table_store(frames, path)
    else:
        jsc.write_store({k: frames[k] for k in ("atom_data", "ionization_data")}, path)
        keys = dict(tf.DEFAULT_KEYS)
        with h5py.File(path, "a") as f:
            for logical, obj in frames.items():
                if logical in ("atom_data", "ionization_data"):
                    continue
                key = keys.get(logical, logical)
                if isinstance(obj.index, pd.MultiIndex):
                    jtf._write_table(f, key, obj.reset_index(), "index",
                                     levels=list(obj.index.names))
                else:
                    jtf._write_table(f, key, obj, obj.index.name or "index")


@pytest.fixture(scope="module")
def small_frames():
    return jsc.build_carsus_frames(**SMALL), sc.build_carsus_frames(**SMALL)


@pytest.mark.parametrize("layout", ["fixed", "table", "mixed"])
def test_store_written_by_the_port_reads_in_jax_as_its_own(layout, small_frames, tmp_path):
    jax_frames, frames = small_frames
    write_port(layout, frames, tmp_path / "ours.h5")
    write_jax(layout, jax_frames, tmp_path / "ref.h5")
    ours = jsc.read_fixed_store(tmp_path / "ours.h5")
    ref = jsc.read_fixed_store(tmp_path / "ref.h5")
    assert_jax_frames_equal(ours, ref)
    if layout == "fixed":  # a fixed store reads back as the frames written
        for logical, obj in jax_frames.items():
            key = tf.DEFAULT_KEYS[logical]
            if isinstance(obj, pd.Series):
                pd.testing.assert_series_equal(ours[key], obj, check_exact=True,
                                               check_index_type=False)
            else:
                pd.testing.assert_frame_equal(ours[key], obj, check_exact=True,
                                              check_index_type=False)


@pytest.mark.parametrize("layout", ["fixed", "table", "mixed"])
def test_store_written_by_jax_reads_in_the_port_as_its_own(layout, small_frames, tmp_path):
    jax_frames, frames = small_frames
    write_jax(layout, jax_frames, tmp_path / "ref.h5")
    write_port(layout, frames, tmp_path / "ours.h5")
    ref = sc.read_fixed_store(tmp_path / "ref.h5")
    assert_frames_equal(ref, sc.read_fixed_store(tmp_path / "ours.h5"))
    assert_frames_equal(ref, {tf.DEFAULT_KEYS[k]: v for k, v in frames.items()})


def test_unpickler_refuses_globals(tmp_path):
    """A pickled global in a store attr constructs nothing; bookkeeping
    attrs still decode, as JAX's do."""
    canary = tmp_path / "owned"

    class Evil:
        def __reduce__(self):
            import os

            return (os.system, (f"touch {canary}",))

    out = tf._unpickle_attr(pickle.dumps(Evil()))
    assert not canary.exists(), "pickle payload executed"
    assert not isinstance(out, list)
    good = pickle.dumps([(1, ["a", "b"])], 0)
    assert tf._unpickle_attr(good) == jtf._unpickle_attr(good) == [(1, ["a", "b"])]


# ---------------------------------------------------------------------------
# conversion


def test_convert_frames_units_and_derived_columns():
    adata = cv.convert_frames(toy_frames())
    assert_atom_data_equal(adata, jcv.convert_frames(jax_toy_frames()))
    np.testing.assert_allclose(adata.atom_data.mass[0], 1.00794 * AMU_CGS, rtol=1e-12)
    np.testing.assert_allclose(adata.ionization_energy(1, 1), 13.598434 * EV_TO_ERG,
                               rtol=1e-12)
    np.testing.assert_allclose(adata.levels.energy[1], 10.1988 * EV_TO_ERG, rtol=1e-12)
    np.testing.assert_allclose(adata.lines.nu[0], C_CGS / 1215.67e-8, rtol=1e-12)
    np.testing.assert_allclose(adata.lines.f_lu[0], 0.8324 / 2.0, rtol=1e-12)
    assert 4e8 < adata.lines.A_ul[0] < 8e8  # Ly-alpha A_ul ~ 6.26e8 1/s
    assert adata.linelist_atoms.waals[0] == -7.8


def test_convert_frames_already_cgs_left_alone():
    jax_frames = jax_toy_frames()
    jax_frames["atom_data"]["mass"] = jax_frames["atom_data"]["mass"] * AMU_CGS
    jax_frames["ionization_data"] = jax_frames["ionization_data"] * EV_TO_ERG
    jax_frames["levels"]["energy"] = jax_frames["levels"]["energy"] * EV_TO_ERG
    adata = cv.convert_frames({k: to_table(v) for k, v in jax_frames.items()})
    assert_atom_data_equal(adata, jcv.convert_frames(jax_frames))
    np.testing.assert_allclose(adata.atom_data.mass[0], 1.00794 * AMU_CGS, rtol=1e-12)


@pytest.mark.parametrize("variant", ["f_lu and A_ul", "f_lu only", "wavelength_cm and nu",
                                     "missing level", "no metastable"])
def test_convert_frames_line_variants(variant):
    """The line table's variants as JAX converts them: f_lu and A_ul taken
    as they are; A_ul derived from f_lu; wavelength_cm and nu taken; a
    line whose lower level is missing gets g = NaN, so NaN f_lu and A_ul;
    levels without a metastable column."""
    jax_frames = jax_toy_frames()
    lines = jax_frames["lines"]
    if variant == "f_lu and A_ul":
        jax_frames["lines"] = lines.drop(columns="gf").assign(f_lu=[0.4162], A_ul=[6.2e8])
    elif variant == "f_lu only":
        jax_frames["lines"] = lines.drop(columns="gf").assign(f_lu=[0.4162])
    elif variant == "wavelength_cm and nu":
        jax_frames["lines"] = lines.drop(columns="wavelength").assign(
            wavelength_cm=[1215.67e-8], nu=[2.466e15])
    elif variant == "missing level":
        jax_frames["lines"] = pd.concat([lines, lines.assign(level_number_lower=[7])],
                                        ignore_index=True)
    else:
        jax_frames["levels"] = jax_frames["levels"].drop(columns="metastable")
    ref = jcv.convert_frames(jax_frames)
    ours = cv.convert_frames({k: to_table(v) for k, v in jax_frames.items()})
    assert_atom_data_equal(ours, ref)
    if variant == "missing level":
        assert np.isnan(ours.lines.f_lu[1]) and np.isnan(ours.lines.A_ul[1])
        assert np.isfinite(ours.lines.f_lu[0])
    if variant == "no metastable":
        assert not ours.levels.metastable.any()


def test_load_carsus_store_missing_tables_error(tmp_path):
    path = tmp_path / "empty.h5"
    with h5py.File(path, "w") as f:
        f.create_group("unrelated")
    with pytest.raises(ValueError, match="lacks required tables"):
        cv.load_carsus_store(path)


@pytest.fixture(scope="module")
def full_stores(tmp_path_factory):
    """The 150,000-line store written and converted by each package."""
    base = tmp_path_factory.mktemp("torch_carsus_full")
    write_jax("fixed", jsc.build_carsus_frames(), base / "ref.h5")
    write_port("fixed", sc.build_carsus_frames(), base / "ours.h5")
    assert jcv.main([str(base / "ref.h5"), str(base / "ref_native.h5")]) == 0
    assert cv.main([str(base / "ours.h5"), str(base / "ours_native.h5")]) == 0
    return base


def assert_jax_atom_data_equal(ours: JaxAtomData, ref: JaxAtomData):
    for name in ("atom_data", "levels", "lines", "linelist_atoms", "linelist_molecules"):
        if getattr(ref, name) is None:
            assert getattr(ours, name) is None
        else:
            pd.testing.assert_frame_equal(getattr(ours, name), getattr(ref, name),
                                          check_exact=True)
    pd.testing.assert_series_equal(ours.ionization_data, ref.ionization_data, check_exact=True)
    assert (ours.molecule_data is None) == (ref.molecule_data is None)
    if ref.molecule_data is not None:
        for name in ("equilibrium_constants", "partition_functions", "dissociation_energies"):
            pd.testing.assert_frame_equal(getattr(ours.molecule_data, name),
                                          getattr(ref.molecule_data, name), check_exact=True)


@pytest.mark.parametrize("size", ["toy", "small", "150k lines"])
def test_convert_cli_output_equals_jax_converter(size, small_frames, full_stores, tmp_path):
    """The port's converter CLI on the port's store, read by JAX's
    from_hdf, equals JAX's converter on JAX's store, table for table."""
    if size == "150k lines":
        base = full_stores
    else:
        base = tmp_path
        jax_frames, frames = ((jax_toy_frames(), toy_frames()) if size == "toy"
                              else small_frames)
        write_jax("fixed", jax_frames, base / "ref.h5")
        write_port("fixed", frames, base / "ours.h5")
        assert jcv.main([str(base / "ref.h5"), str(base / "ref_native.h5")]) == 0
        assert cv.main([str(base / "ours.h5"), str(base / "ours_native.h5")]) == 0
    ref = JaxAtomData.from_hdf(base / "ref_native.h5")
    assert_jax_atom_data_equal(JaxAtomData.from_hdf(base / "ours_native.h5"), ref)
    ours = AtomData.from_hdf(base / "ours_native.h5")
    assert_atom_data_equal(ours, ref)
    assert cv.verify_report(ours) == jcv.verify_report(ref)


def test_verify_report_and_expected_tables(tmp_path, capsys):
    """The port's verify report equals JAX's; --verify passes against a
    matching table and fails against a wrong one; --record pins the exact
    block, which then binds."""
    src = tmp_path / "toy_store.h5"
    sc.write_store(toy_frames(), src)
    report = cv.verify_report(cv.convert_frames(cv.load_carsus_store(src)))
    assert report == jcv.verify_report(jcv.convert_frames(jax_toy_frames()))
    assert report["levels_per_species"]["1_0"] == 2
    assert abs(report["ionization_ev"]["1_1"] - 13.5984) < 1e-3
    good = {"name": "toy", "z_range": [1, 2], "ionization_ev": {"1_1": 13.5984, "2_2": 54.4178},
            "mass_u": {"1": 1.008, "2": 4.0026},
            "totals": {"n_levels": [1, 100], "n_lines": [1, 10]}}
    assert cv.verify_against_expected(report, good) == []
    bad = cv.verify_against_expected(report, dict(good, ionization_ev={"1_1": 10.0}))
    assert bad and "ionization 1_1" in bad[0]
    exp, rec = tmp_path / "exp.json", tmp_path / "rec.json"
    exp.write_text(json.dumps(good))
    assert cv.main([str(src), str(tmp_path / "n.h5"), "--verify", "--expected", str(exp),
                    "--record", str(rec)]) == 0
    assert "verify: PASSED" in capsys.readouterr().out
    recorded = json.loads(rec.read_text())
    assert recorded["exact"]["n_lines"] == 1
    recorded["exact"]["checksum_f_lu"] += 1.0
    exp.write_text(json.dumps(recorded))
    assert cv.main([str(src), str(tmp_path / "n2.h5"), "--verify", "--expected",
                    str(exp)]) == 1
    bundled = cv._builtin_expected("kurucz_cd23_chianti_H_He.h5")
    assert bundled == jcv._builtin_expected("kurucz_cd23_chianti_H_He.h5")
    assert bundled["z_range"] == [1, 30]


def test_synthetic_carsus_cli(tmp_path, capsys):
    path = tmp_path / "synth.h5"
    assert sc.main([str(path), "3000"]) == 0
    assert "3000 lines" in capsys.readouterr().out
    frames = sc.read_fixed_store(path)
    ref = jsc.build_carsus_frames(n_lines=3000)
    assert len(frames["lines"]) == 3000
    assert_tables_equal(frames["levels"], to_table(ref["levels"]), "levels")
    assert sc.main([]) == 2


# ---------------------------------------------------------------------------
# the kurucz-scale store end to end


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_carsus_model") / "sun.mod"
    write_marcs_file(path)
    return path


@pytest.fixture(scope="module")
def file_route(full_stores, model_path):
    """carsus_scale's run on the port's converted store, read from its
    file (CPU, float64)."""
    native = full_stores / "ours_native.h5"
    cfg = golden_config("carsus_scale", model_path, atom_data=native)
    out = run_stardis(cfg, tu.Quantity(np.arange(*GOLDEN_LAMBDAS["carsus_scale"]), tu.AA),
                      device="cpu", dtype=torch.float64)
    wl = AtomData.from_hdf(native).linelist_atoms.wavelength
    return {"nus": np.asarray(out.nus), "spectrum_nu": np.asarray(out.spectrum_nu),
            "n_lines_in_window": np.asarray(int(((wl >= 5150.0) & (wl <= 5170.0)).sum())),
            "electron_densities": out.stellar_plasma.electron_densities.numpy()}


def test_port_store_meets_carsus_scale_golden(file_route):
    rd = RegressionData(GOLDEN_DIR, "carsus_scale", rtol=GOLDEN_RTOL)
    assert sorted(rd.keys()) == sorted(file_route)
    assert int(file_route["n_lines_in_window"]) > 200
    assert np.isfinite(file_route["spectrum_nu"]).all() and (file_route["spectrum_nu"] > 0).all()
    for name, value in file_route.items():
        rd.sync_ndarray(name, value)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_in_memory_golden_configuration(file_route, model_path, dtype):
    """util.regression's carsus_scale configuration, on atom data built in
    memory: float64 equal to the file route bit for bit, float32 within
    util.regression's float32 bars of the golden store."""
    arrays = golden_arrays("carsus_scale", model_path, "cpu", dtype)
    assert sorted(arrays) == sorted(file_route)
    if dtype == torch.float64:
        for name, value in file_route.items():
            np.testing.assert_array_equal(arrays[name], value, err_msg=name)
        return
    rd = RegressionData(GOLDEN_DIR, "carsus_scale", rtol=GOLDEN_RTOL)
    ratios = {name: f32_ratio(name, value, rd[name]) for name, value in arrays.items()}
    assert all(r <= 1.0 for r in ratios.values()), ratios


def test_host_surface_imports_no_jax_pandas_h5py():
    """The new modules import, and the kurucz-scale tables build and
    convert in memory, without jax, stardis_tpu, pandas or h5py."""
    import subprocess
    import sys

    code = """
import sys
import stardis_tpu_torch.atom_data.download, stardis_tpu_torch.atom_data.table_format
import stardis_tpu_torch.radiation_field.base, stardis_tpu_torch.util.profiling
import stardis_tpu_torch.util.compile_cache
from stardis_tpu_torch.atom_data.convert import convert_frames
from stardis_tpu_torch.atom_data.synthetic_carsus import build_carsus_frames
adata = convert_frames(build_carsus_frames(n_lines=2000, n_vald_lines=1000))
assert len(adata.lines) == 2000 and adata.molecule_data is not None
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'stardis_tpu', 'pandas', 'h5py')]
print(bad); sys.exit(1 if bad else 0)
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).parent.parent)
    assert res.returncode == 0, res.stdout + res.stderr
