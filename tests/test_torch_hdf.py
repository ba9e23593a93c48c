"""HDF5 in stardis_tpu_torch against the JAX package: ``AtomData.from_hdf``
of a store written by JAX's ``to_hdf`` (builtin:30 with line lists and
molecules) table by table, exactly; the port's ``to_hdf`` read back by
JAX's ``from_hdf``, exactly; ``run_stardis`` with ``atom_data: <path>``
against JAX's at rtol 1e-9; ``util.hdf.output_to_hdf`` against JAX's file
(dataset paths, shapes, dtype kinds, attributes; values at rtol 1e-9); and
the command line's ``--output`` bit for bit against ``run_stardis`` then
``output_to_hdf``."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
h5py = pytest.importorskip("h5py")
pd = pytest.importorskip("pandas")
import torch  # noqa: E402

import stardis_tpu  # noqa: E402
import stardis_tpu_torch  # noqa: E402
from stardis_tpu import units as ju  # noqa: E402
from stardis_tpu.atom_data import build_builtin_atom_data as jax_atom_data  # noqa: E402
from stardis_tpu.atom_data.base import AtomData as JaxAtomData  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.util.hdf import output_to_hdf as jax_output_to_hdf  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.__main__ import main  # noqa: E402
from stardis_tpu_torch.atom_data import AtomData, build_builtin_atom_data  # noqa: E402
from stardis_tpu_torch.opacities.lines import synth_molecule_linelist  # noqa: E402
from stardis_tpu_torch.util.hdf import output_to_hdf  # noqa: E402

RTOL = 1e-9
N_MOL_LINES = 300
LAMBDA_RANGE = (5888.0, 5892.0)  # AA: Na D and the builtin list's metal lines


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_store(tmp_path_factory):
    """JAX's builtin:30 atom data with its line list, molecular tables and
    a synthetic molecular line list, written by JAX's ``to_hdf``."""
    ours = synth_molecule_linelist(
        build_builtin_atom_data(30, include_linelists=True, include_molecules=True),
        N_MOL_LINES, *LAMBDA_RANGE)
    ref = jax_atom_data(30, include_linelists=True, include_molecules=True)
    ref.linelist_molecules = pd.DataFrame(dict(ours.linelist_molecules.columns))
    path = tmp_path_factory.mktemp("torch_hdf") / "builtin30.h5"
    ref.to_hdf(path)
    return path, JaxAtomData.from_hdf(path), ours


def _assert_same_as_jax(ours, ref):
    """Every table of the port's AtomData against the JAX one's frames."""
    np.testing.assert_array_equal(ours.atom_data.atomic_number, ref.atom_data.index.values)
    assert list(ours.atom_data.symbol) == list(ref.atom_data.symbol)
    np.testing.assert_array_equal(ours.atom_data.mass, ref.atom_data.mass.values)
    for names, ours_t, ref_idx, ref_cols in (
        (("atomic_number", "ion_number"), ours.ionization_data,
         ref.ionization_data.index, {"ionization_energy": ref.ionization_data.values}),
        (("atomic_number", "ion_number", "level_number"), ours.levels, ref.levels.index,
         {c: ref.levels[c].values for c in ref.levels.columns}),
    ):
        for name in names:
            np.testing.assert_array_equal(ours_t[name], ref_idx.get_level_values(name))
        for name, values in ref_cols.items():
            assert ours_t[name].dtype == values.dtype, name
            np.testing.assert_array_equal(ours_t[name], values, err_msg=name)
    for ours_t, ref_t in ((ours.lines, ref.lines), (ours.linelist_atoms, ref.linelist_atoms),
                          (ours.linelist_molecules, ref.linelist_molecules)):
        assert list(ours_t.columns) == list(ref_t.columns)
        for col in ref_t.columns:
            values = ref_t[col].values
            if values.dtype.kind == "O":
                assert list(ours_t[col]) == list(values), col
            else:
                assert ours_t[col].dtype == values.dtype, col
                np.testing.assert_array_equal(ours_t[col], values, err_msg=col)
    md, rmd = ours.molecule_data, ref.molecule_data
    eq, pf, de = rmd.equilibrium_constants, rmd.partition_functions, rmd.dissociation_energies
    assert md.names == list(eq.index)
    np.testing.assert_array_equal(md.equilibrium_temperatures, eq.columns.values)
    np.testing.assert_array_equal(md.log_equilibrium_constants, eq.values)
    np.testing.assert_array_equal(md.partition_temperatures, pf.columns.values)
    np.testing.assert_array_equal(md.partition_functions, pf.loc[md.names].values)
    assert md.ion1 == list(de.loc[md.names].Ion1) and md.ion2 == list(de.loc[md.names].Ion2)
    np.testing.assert_array_equal(md.dissociation_energies,
                                  de.loc[md.names].dissociation_energy.values)


def test_from_hdf_reads_jax_store_exactly(jax_store):
    path, ref, _ = jax_store
    _assert_same_as_jax(AtomData.from_hdf(path), ref)


def test_to_hdf_is_read_back_by_jax_exactly(jax_store, tmp_path):
    _, ref, ours = jax_store
    path = tmp_path / "ours.h5"
    ours.to_hdf(path)
    _assert_same_as_jax(AtomData.from_hdf(path), ref)
    back = JaxAtomData.from_hdf(path)
    for name in ("atom_data", "levels", "lines", "linelist_atoms", "linelist_molecules"):
        pd.testing.assert_frame_equal(getattr(back, name), getattr(ref, name), check_exact=True)
    pd.testing.assert_series_equal(back.ionization_data, ref.ionization_data, check_exact=True)
    for name in ("equilibrium_constants", "partition_functions", "dissociation_energies"):
        pd.testing.assert_frame_equal(getattr(back.molecule_data, name),
                                      getattr(ref.molecule_data, name), check_exact=True)


def test_from_hdf_refuses_other_files_and_store_names(tmp_path, jax_store, monkeypatch):
    """Another file's format is refused; a published store's name is not
    read as a path but fetched by ``download_atom_data`` (stubbed here with
    the JAX store's path: the tests reach no network) and read from there."""
    path = tmp_path / "other.h5"
    with h5py.File(path, "w") as f:
        f.attrs["format"] = "something else"
    with pytest.raises(ValueError, match="not a stardis_tpu atom-data file"):
        AtomData.from_hdf(path)
    from stardis_tpu_torch.atom_data import download
    from stardis_tpu_torch.base import _load_atom_data

    store, ref, _ = jax_store
    fetched = []
    monkeypatch.setattr(download, "download_atom_data",
                        lambda spec: fetched.append(spec) or str(store))
    _assert_same_as_jax(_load_atom_data("kurucz_cd23_chianti_H_He"), ref)
    assert fetched == ["kurucz_cd23_chianti_H_He"]


def _config(model_path, atom_data):
    return {
        "stardis_config_version": 1.0,
        "atom_data": str(atom_data),
        "input_model": {"type": "marcs", "fname": str(model_path), "final_atomic_number": 30},
        "opacity": {
            "bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
            "line": {
                "disable": False,
                "broadening": ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"],
                "vald_linelist": {"use_linelist": True, "use_vald_broadening": True},
                "include_molecules": True,
            },
        },
        "no_of_thetas": 6,
        "result_options": {"return_model": True, "return_plasma": True,
                           "return_radiation_field": True},
    }


@pytest.fixture(scope="module")
def runs(jax_store, tmp_path_factory):
    """JAX's and the port's run on the HDF store, and their output files."""
    path, _, _ = jax_store
    tmp = tmp_path_factory.mktemp("torch_hdf_runs")
    model = tmp / "sun.mod"
    write_marcs_file(model)
    cfg = _config(model, path)
    yml = tmp / "c.yml"
    yml.write_text(yaml.safe_dump(cfg))
    lams = np.arange(*LAMBDA_RANGE, 0.01)
    ref = stardis_tpu.run_stardis(str(yml), ju.Quantity(lams, ju.AA))
    ours = stardis_tpu_torch.run_stardis(cfg, tu.Quantity(lams, tu.AA), device="cpu",
                                         dtype=torch.float64)
    jax_output_to_hdf(ref, tmp / "ref.h5")
    output_to_hdf(ours, tmp / "ours.h5")
    return cfg, lams, ref, ours, tmp


def test_hdf_atom_data_run_matches_jax(runs):
    _, _, ref, ours, _ = runs
    flux = np.asarray(ours.spectrum_nu)
    assert np.isfinite(flux).all() and (flux > 0).all()
    np.testing.assert_allclose(flux, np.asarray(ref.spectrum_nu), rtol=RTOL)
    key = "molecule_alpha_line_at_nu"
    np.testing.assert_allclose(
        ours.stellar_radiation_field.opacities.opacities_dict[key].numpy(),
        np.asarray(ref.stellar_radiation_field.opacities.opacities_dict[key]),
        rtol=RTOL, atol=1e-300)


def _datasets(path):
    """{dataset path: (array, attrs of its group)} and {group path: attrs}."""
    out, groups = {}, {}
    with h5py.File(path, "r") as f:
        groups["/"] = dict(f.attrs)

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[()]
            else:
                groups[name] = dict(obj.attrs)

        f.visititems(visit)
    return out, groups


def test_output_file_matches_jax(runs):
    _, _, _, _, tmp = runs
    ours, ours_groups = _datasets(tmp / "ours.h5")
    ref, ref_groups = _datasets(tmp / "ref.h5")
    assert sorted(ours) == sorted(ref)
    assert ours_groups == ref_groups
    assert ours_groups["/"]["format"] == "stardis_tpu_output_v1"
    assert ours_groups["stellar_model/nuclide_mass_fraction"] == {"pandas": "frame"}
    for name, value in ref.items():
        mine = ours[name]
        assert mine.shape == value.shape, name
        assert mine.dtype.kind == value.dtype.kind, name
        np.testing.assert_allclose(mine, value, rtol=RTOL, atol=0, err_msg=name)
    assert "stellar_plasma/electron_densities" in ours
    assert "radiation_field/opacities/alpha_line_at_nu" in ours


def test_cli_output_equals_run_then_writer(runs, tmp_path, capsys):
    cfg, _, _, _, tmp = runs
    cfg_path = tmp_path / "c.json"
    cfg_path.write_text(json.dumps(cfg))
    out = tmp_path / "cli.h5"
    assert main([str(cfg_path), "--lambda", "5888:5892:0.01", "--cpu", "--output",
                 str(out)]) == 0
    assert f"wrote {out}" in capsys.readouterr().out
    cli, cli_groups = _datasets(out)
    direct, direct_groups = _datasets(tmp / "ours.h5")
    assert sorted(cli) == sorted(direct) and cli_groups == direct_groups
    for name, value in direct.items():
        np.testing.assert_array_equal(cli[name], value, err_msg=name)
