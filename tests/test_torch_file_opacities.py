"""File opacities: the port's NumPy readers against the JAX package's
pandas readers, and a run with all three tables end to end, float64.

* ``sigma_file`` for the Wishart (Hminus_bf), Bell & Berrington
  (Hminus_ff, header tokens ending in commas) and Stancil (H2plus_bf,
  implicit exponents) formats at 1e-12, on the tables of
  tests/test_spherical_and_files.py and on the port's own synthetic tables,
  with temperatures and wavelengths inside, exactly on and outside each
  table's axes: the port interpolates a table in wavelength once
  (``FileTable``) and per depth between two of its rows, where the JAX
  package interpolates bilinearly at every point; the zeros fall on the
  same points and the "outside interpolation range" warning fires alike;
* the plane-parallel sun with the three tables, F_nu and each
  alpha_file_* opacity at 1e-9.
"""

import copy
import logging
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import torch  # noqa: E402

import stardis_tpu  # noqa: E402
import stardis_tpu_torch  # noqa: E402
from stardis_tpu import units as ju  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.opacities.file_tables import sigma_file as j_sigma_file  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_opacity_tables  # noqa: E402
from stardis_tpu_torch.opacities import continuum as tcont  # noqa: E402
from stardis_tpu_torch.opacities.file_tables import read_file_table, sigma_file  # noqa: E402
from test_spherical_and_files import (  # noqa: E402
    _write_h2plus_bf_table,
    _write_hminus_bf_table,
    _write_hminus_ff_table,
)

SOURCES = ("Hminus_bf", "Hminus_ff", "H2plus_bf")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def table_sets(tmp_path_factory):
    jax_dir = tmp_path_factory.mktemp("jax_tables")
    writers = {"Hminus_bf": _write_hminus_bf_table, "Hminus_ff": _write_hminus_ff_table,
               "H2plus_bf": _write_h2plus_bf_table}
    jax_tables = {}
    for name, write in writers.items():
        jax_tables[name] = str(jax_dir / f"{name}.dat")
        write(jax_tables[name])
    port_tables = write_opacity_tables(tmp_path_factory.mktemp("port_tables"))
    return {"jax_writers": jax_tables, "port_writer": port_tables,
            "descending": _descending_tables(port_tables, tmp_path_factory.mktemp("desc"))}


def _descending_tables(tables, directory):
    """The port writer's two 2-D tables with both axes in descending order
    (scipy's interpolator, which the JAX package uses, takes either)."""
    out = {}
    for name in ("Hminus_ff", "H2plus_bf"):
        header, *body = [line for line in Path(tables[name]).read_text().splitlines()
                         if not line.startswith("#")]
        first, *axis = header.split()
        rows = [[r.split()[0], *r.split()[1:][::-1]] for r in body[::-1]]
        if name == "Hminus_ff":  # header tokens end in commas but the last
            axis = [t.strip(",") for t in axis][::-1]
            header = " ".join([first] + [t + "," for t in axis[:-1]] + axis[-1:])
        else:
            header = " ".join([first] + axis[::-1])
        out[name] = str(directory / f"{name}.dat")
        Path(out[name]).write_text("\n".join([header] + [" ".join(r) for r in rows]) + "\n")
    return out


#: (wavelengths [AA], temperatures [K]) of each case.  Both writers'
#: tables span 3000-12000 AA (H- bf 2000-15000 AA), T 3000-12000 K (H2+ bf)
#: and theta = 5040 / T 0.5-2.5 (H- ff: T 2016-10080 K)
CASES = {
    # the first case: a mix of both sides of every axis
    "": (np.linspace(2500.0, 14000.0, 180),
         np.array([2800.0, 3500.0, 4500.0, 6000.0, 9000.0, 13000.0])),
    # strictly inside every axis: no zero, no warning
    "inside": (np.linspace(3100.0, 11900.0, 97), np.array([3500.0, 4500.0, 6000.0, 9000.0])),
    # every temperature strictly between two of the table's, some
    # wavelengths outside: the zeros come from the wavelength interpolation
    # alone, in both rows that a depth reads
    "lambda_outside": (np.linspace(2500.0, 14000.0, 61),
                       np.array([3500.0, 4500.0, 6000.0, 9000.0])),
    # exactly on the axes' samples and ends (theta 2.5, 2.0, 1.5, 1.0, 0.5)
    "on_axis": (np.array([2000.0, 3000.0, 3600.0, 6000.0, 11400.0, 12000.0, 15000.0]),
                np.array([2016.0, 2520.0, 3000.0, 3360.0, 5000.0, 5040.0, 8000.0,
                          10080.0, 12000.0])),
    # outside every axis, beside one depth and one wavelength inside
    "outside": (np.array([1000.0, 1999.0, 6000.0, 15001.0, 20000.0]),
                np.array([1500.0, 2015.0, 4000.0, 12001.0, 20000.0])),
}
PARITY = [pytest.param(writer, source, case, id="-".join(filter(None, (writer, source, case))))
          for case in CASES for writer in ("jax_writers", "port_writer") for source in SOURCES]
PARITY += [pytest.param("descending", source, "", id=f"descending-{source}")
           for source in ("Hminus_ff", "H2plus_bf")]


@pytest.mark.parametrize("writer,source,case", PARITY)
def test_sigma_file_matches_jax(table_sets, writer, source, case, caplog):
    path = table_sets[writer][source]
    lambdas, temps = CASES[case]
    with caplog.at_level(logging.WARNING):
        ours = sigma_file(lambdas, temps, path, source)
    warned = [r.name.startswith("stardis_tpu_torch") for r in caplog.records
              if "outside interpolation range" in r.getMessage()]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        ref = j_sigma_file(lambdas, temps, path, source)
    ref_warned = [r.name.startswith("stardis_tpu.") for r in caplog.records
                  if "outside interpolation range" in r.getMessage()]
    assert ours.shape == (len(temps), len(lambdas)) and (ours > 0).any()
    np.testing.assert_array_equal(ours == 0, ref == 0)
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)
    assert warned == ref_warned == ([True] if source != "Hminus_bf" and (ref == 0).any()
                                    else [])
    if case == "inside":
        assert (ref > 0).all()


def test_file_table_rows_expand_to_sigma_file(table_sets):
    """``FileTable.rows_at`` of a [B, D] batch, sliced by model and by
    pixel range, expands to ``sigma_file`` of each model bit for bit."""
    lambdas, temps = CASES[""]
    batch = np.stack([temps, temps[::-1] * 0.97, temps * 1.02])
    for source in SOURCES:
        path = table_sets["port_writer"][source]
        rows = read_file_table(path, source, lambdas).rows_at(batch)
        assert rows.lo.shape == batch.shape and len(rows) == 3
        dense = rows.dense()
        for b in range(3):
            np.testing.assert_array_equal(dense[b], sigma_file(lambdas, batch[b], path, source))
        np.testing.assert_array_equal(rows[1:3].dense(slice(40, 90)), dense[1:3, :, 40:90])
        np.testing.assert_array_equal(rows.reshape(-1).dense(), dense.reshape(-1, len(lambdas)))
        packed = rows.packed()
        assert packed.shape == (3, batch.size) and packed.dtype == np.float64
        np.testing.assert_array_equal(packed[0], rows.lo.reshape(-1))


def test_sigma_file_rejects_unknown_source(table_sets):
    with pytest.raises(ValueError, match="Unknown opacity_source"):
        sigma_file(np.ones(3), np.ones(2), table_sets["port_writer"]["Hminus_bf"], "He_bf")


def test_file_opacities_end_to_end_match_jax(table_sets, tmp_path):
    model = str(tmp_path / "sun.mod")
    write_marcs_file(model)
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:5",
        "input_model": {"type": "marcs", "fname": model, "final_atomic_number": 5},
        "opacity": {
            "file": dict(table_sets["port_writer"]),
            "bf": {"H_I": {}}, "ff": {"H_I": {}},
            "line": {"disable": False, "broadening": ["radiation"]},
        },
        "no_of_thetas": 3,
        "result_options": {"return_radiation_field": True},
    }
    path = tmp_path / "c.yml"
    path.write_text(yaml.safe_dump(cfg))
    lams = np.arange(6560.0, 6570.0, 0.1)
    ref = stardis_tpu.run_stardis(str(path), ju.Quantity(lams, ju.AA))
    ours = stardis_tpu_torch.run_stardis(copy.deepcopy(cfg), tu.Quantity(lams, tu.AA),
                                         device="cpu", dtype=torch.float64)
    rf, rf_ref = ours.stellar_radiation_field, ref.stellar_radiation_field
    np.testing.assert_allclose(rf.F_nu.numpy(), np.asarray(rf_ref.F_nu), rtol=1e-9, atol=1e-300)
    for name in SOURCES:
        key = f"alpha_file_{name}"
        np.testing.assert_allclose(rf.opacities.opacities_dict[key].numpy(),
                                   np.asarray(rf_ref.opacities.opacities_dict[key]),
                                   rtol=1e-9, atol=1e-300, err_msg=key)
    assert list(rf.opacities.opacities_dict)[:3] == [f"alpha_file_{n}" for n in SOURCES]
    sig = torch.ones(2, 3, dtype=torch.float64)
    np.testing.assert_array_equal(
        tcont.calc_alpha_file(sig, torch.tensor([2.0, 5.0], dtype=torch.float64)).numpy(),
        [[2.0] * 3, [5.0] * 3],
    )
