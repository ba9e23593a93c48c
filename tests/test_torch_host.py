"""The port's NumPy host phase against the JAX package's, exactly: config
defaults, builtin atom data, MARCS model, plasma tables, selected lines,
quadrature and geometry of ``build_simulation_plan``; and ``synth_linelist``
against ``bench_lines.synth_linelist``.  Also: the port, a MESA + VALD-text
run included, imports neither jax, stardis_tpu, pandas, PyYAML,
jsonschema, triton nor h5py."""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")

import torch  # noqa: E402

import bench_lines  # noqa: E402
import stardis_tpu  # noqa: E402
from stardis_tpu import units as ju  # noqa: E402
from stardis_tpu.atom_data import build_builtin_atom_data as jax_atom_data  # noqa: E402
from stardis_tpu.io.config import load_config as jax_load_config  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.pipeline import build_simulation_plan as jax_build_plan  # noqa: E402
from stardis_tpu_torch import pipeline as tpipe  # noqa: E402
from stardis_tpu_torch.atom_data import build_builtin_atom_data  # noqa: E402
from stardis_tpu_torch.base import parse_config_to_model  # noqa: E402
from stardis_tpu_torch.io.config import load_config  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_marcs_file as t_write_marcs  # noqa: E402
from stardis_tpu_torch.opacities.lines import synth_linelist  # noqa: E402

BROADENING = ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(model_path, atom, z_max, vald):
    line = {"disable": False, "broadening": BROADENING}
    if vald:
        line["vald_linelist"] = {"use_linelist": True, "use_vald_broadening": True}
    return {
        "stardis_config_version": 1.0,
        "atom_data": atom,
        "input_model": {"type": "marcs", "fname": model_path, "final_atomic_number": z_max},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"], "line": line},
        "no_of_thetas": 20,
    }


def _assert_same(a, b, name):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        assert a == b, name


@pytest.fixture(scope="module", params=["tardis", "vald", "solar_lines", "asplund_rescaled"])
def plans(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host")
    model = str(tmp / "sun.mod")
    write_marcs_file(model)
    kind = request.param
    small = kind in ("tardis", "asplund_rescaled")
    cfg = _config(model, "builtin:2" if small else "builtin:30", 2 if small else 30,
                  vald=not small)
    if kind == "asplund_rescaled":
        cfg["input_model"].update(composition_source="asplund_2020",
                                  nuclide_rescaling_dict={"He": 2.0})
        cfg["opacity"]["line"]["disable_microturbulence"] = True
    path = tmp / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    lams = {"tardis": np.arange(6540.0, 6590.0, 0.2),
            "asplund_rescaled": np.arange(6540.0, 6590.0, 0.2),
            "vald": np.arange(6500.0, 6600.0, 0.01),
            "solar_lines": np.arange(5880.0, 5900.0, 0.05)}[kind]
    nus = np.asarray(ju.Quantity(lams, ju.AA).to(ju.Hz, ju.spectral()))

    config, adata, model_j = stardis_tpu.parse_config_to_model(str(path))
    t_config, t_adata, model_t = parse_config_to_model(cfg)
    if kind == "vald":  # the Sim100AA grid and 100k-line list
        bench_lines.synth_linelist(adata, 100_000)
        synth_linelist(t_adata, 100_000)
    ref = jax_build_plan(config, adata, model_j, nus)
    ours = tpipe.build_simulation_plan(t_config, t_adata, model_t, nus)
    return ref, ours


def test_plan_arrays_match_exactly(plans):
    ref, ours = plans
    for name in ("tracing_nus", "temperatures", "n_elem", "ray_distances", "weights",
                 "ff_slots", "ff_ion_numbers", "microturbulence_cgs", "d_nu",
                 "rayleigh_species", "broadening_flags", "use_vald_broadening",
                 "disable_electron_scattering", "photospheric_correction",
                 "track_individual_intensities"):
        _assert_same(getattr(ref, name), getattr(ours, name), name)


def test_plan_tables_match_exactly(plans):
    ref, ours = plans
    for f in dataclasses.fields(ours.tables):
        _assert_same(getattr(ref.tables, f.name), getattr(ours.tables, f.name), f.name)
    for f in dataclasses.fields(ours.bf):
        _assert_same(getattr(ref.bf, f.name), getattr(ours.bf, f.name), f.name)


def test_plan_line_data_matches_exactly(plans):
    ref, ours = plans
    assert ours.line_data.n_lines > 0
    for f in dataclasses.fields(ours.line_data):
        a, b = getattr(ref.line_data, f.name), getattr(ours.line_data, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
        else:
            _assert_same(a, b, f.name)


def test_plan_from_reference_round_trip(plans):
    ref, ours = plans
    carried = tpipe.plan_from_reference(ref)
    for f in dataclasses.fields(ours):
        a, b = getattr(carried, f.name), getattr(ours, f.name)
        if dataclasses.is_dataclass(b):
            for g in dataclasses.fields(b):
                x, y = getattr(a, g.name), getattr(b, g.name)
                if x is None or y is None:
                    assert x is None and y is None
                elif g.name == "level_flat_index":
                    assert x == y
                else:
                    _assert_same(x, y, f"{f.name}.{g.name}")
        else:
            _assert_same(a, b, f.name)


def test_synth_linelist_matches_bench_lines():
    ours = synth_linelist(build_builtin_atom_data(30), 5000, seed=11).linelist_atoms
    ref = bench_lines.synth_linelist(jax_atom_data(30), 5000, seed=11).linelist_atoms
    assert list(ours.columns) == list(ref.columns)
    for col in ref.columns:
        np.testing.assert_array_equal(ours[col], ref[col].values, err_msg=col)


def test_builtin_atom_data_matches_exactly():
    ours = build_builtin_atom_data(30, include_linelists=True)
    ref = jax_atom_data(30, include_linelists=True)
    np.testing.assert_array_equal(ours.atom_data.mass, ref.atom_data.mass.values)
    np.testing.assert_array_equal(ours.ionization_data.ionization_energy,
                                  ref.ionization_data.values)
    idx = ref.levels.index
    for name in ("atomic_number", "ion_number", "level_number"):
        np.testing.assert_array_equal(ours.levels[name], idx.get_level_values(name))
    for name in ("energy", "g", "metastable"):
        np.testing.assert_array_equal(ours.levels[name], ref.levels[name].values)
    for name in ref.lines.columns:
        np.testing.assert_array_equal(ours.lines[name], ref.lines[name].values)
    for name in ref.linelist_atoms.columns:
        np.testing.assert_array_equal(ours.linelist_atoms[name],
                                      ref.linelist_atoms[name].values, err_msg=name)


def test_config_defaults_and_validation_match(tmp_path):
    cfg = _config("sun.mod", "builtin:2", 2, vald=True)
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    json_path = tmp_path / "config.json"
    json_path.write_text(json.dumps(cfg))
    ref = jax_load_config(str(path), {"no_of_thetas": 7}).to_dict()
    for source in (cfg, str(path), str(json_path)):
        assert load_config(source, {"no_of_thetas": 7}).to_dict() == ref
    for bad in ({"opacity": {"bogus": 1}}, {"no_of_thetas": 2.5},
                {"opacity": {"rayleigh": ["Fe"]}}):
        broken = {**cfg, **bad}
        with pytest.raises(ValueError):
            load_config(broken)
    missing = dict(cfg)
    del missing["atom_data"]
    with pytest.raises(ValueError, match="required"):
        load_config(missing)


def test_synthetic_marcs_file_is_identical(tmp_path):
    write_marcs_file(tmp_path / "a.mod")
    t_write_marcs(tmp_path / "b.mod")
    assert (tmp_path / "a.mod").read_text() == (tmp_path / "b.mod").read_text()


def test_port_imports_no_jax_pandas_yaml(tmp_path):
    """The port's modules, the new inputs' and the sharded paths' among
    them, and a MESA model with a VALD text line list run on the CPU, alone
    and on a ["cpu"] * 2 mesh, import none of jax, stardis_tpu, pandas,
    PyYAML, jsonschema, triton or h5py."""
    code = f"""
import sys
import numpy as np
import torch
import stardis_tpu_torch, stardis_tpu_torch.pipeline
import stardis_tpu_torch.native, stardis_tpu_torch.io.mesa
import stardis_tpu_torch.util.hdf, stardis_tpu_torch.util.regression
import stardis_tpu_torch.parallel.distributed
from stardis_tpu_torch.parallel.sharding import Mesh
from stardis_tpu_torch import units as u
from stardis_tpu_torch.atom_data import build_builtin_atom_data
from stardis_tpu_torch.io.synthetic import write_mesa_file, write_vald_linelist
from stardis_tpu_torch.opacities.lines import synth_linelist
tmp = {str(tmp_path)!r}
write_mesa_file(tmp + "/star.mod")
lines = synth_linelist(build_builtin_atom_data(30), 300, 6500.0, 6502.0).linelist_atoms
write_vald_linelist(tmp + "/lines.txt", lines)
cfg = {{"stardis_config_version": 1.0, "atom_data": "builtin:30",
        "input_model": {{"type": "mesa", "fname": tmp + "/star.mod", "final_atomic_number": 30}},
        "opacity": {{"bf": {{"H_I": {{}}}}, "line": {{"disable": False, "broadening": ["radiation"],
                     "vald_linelist": {{"use_linelist": True, "fname": tmp + "/lines.txt"}}}}}},
        "no_of_thetas": 3}}
lam = u.Quantity(np.arange(6500.0, 6502.0, 0.05), u.AA)
out = stardis_tpu_torch.run_stardis(cfg, lam, device="cpu", dtype=torch.float64)
assert np.isfinite(np.asarray(out.spectrum_nu)).all()
sharded = stardis_tpu_torch.run_stardis(cfg, lam, device="cpu", dtype=torch.float64,
                                        mesh=Mesh(["cpu"] * 2, ("nu",)))
assert np.allclose(np.asarray(sharded.spectrum_nu), np.asarray(out.spectrum_nu),
                   rtol=1e-12, atol=0)
assert stardis_tpu_torch.native.LAST_PARSER == "native"
bad = [m for m in sys.modules if m.split('.')[0] in
       ('jax', 'stardis_tpu', 'pandas', 'yaml', 'jsonschema', 'triton', 'h5py')]
print(bad); sys.exit(1 if bad else 0)
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
