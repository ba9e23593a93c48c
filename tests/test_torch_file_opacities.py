"""File opacities: the port's NumPy readers against the JAX package's
pandas readers, and a run with all three tables end to end, float64.

* ``sigma_file`` for the Wishart (Hminus_bf), Bell & Berrington
  (Hminus_ff, header tokens ending in commas) and Stancil (H2plus_bf,
  implicit exponents) formats at 1e-12, on the tables of
  tests/test_spherical_and_files.py and on the port's own synthetic tables;
* the plane-parallel sun with the three tables, F_nu and each
  alpha_file_* opacity at 1e-9.
"""

import copy

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
from stardis_tpu_torch.opacities.file_tables import sigma_file  # noqa: E402
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
    return {"jax_writers": jax_tables,
            "port_writer": write_opacity_tables(tmp_path_factory.mktemp("port_tables"))}


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("writer", ["jax_writers", "port_writer"])
def test_sigma_file_matches_jax(table_sets, source, writer):
    path = table_sets[writer][source]
    lambdas = np.linspace(2500.0, 14000.0, 180)
    temps = np.array([2800.0, 3500.0, 4500.0, 6000.0, 9000.0, 13000.0])
    ours = sigma_file(lambdas, temps, path, source)
    ref = j_sigma_file(lambdas, temps, path, source)
    assert ours.shape == (len(temps), len(lambdas)) and (ours > 0).any()
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)


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
