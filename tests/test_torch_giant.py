"""The slice with every new branch on at once: the spherical cool giant
(Teff 4000 K, log g 2, R 2e12 cm) with molecules and molecular lines, the
three file-opacity tables, Rayleigh H and H2, VALD broadening and accuracy
windows, through the port's own host phase against the JAX package, F_nu
and I_nu at 1e-9 in float64; pairwise and coupled molecules."""

import copy

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import torch  # noqa: E402

import stardis_tpu  # noqa: E402
import stardis_tpu_torch  # noqa: E402
from bench_lines import synth_linelist as jax_synth_linelist  # noqa: E402
from stardis_tpu import units as ju  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.pipeline import build_simulation_plan, run_simulation  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.atom_data import build_builtin_atom_data  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_opacity_tables  # noqa: E402
from stardis_tpu_torch.opacities.lines import synth_linelist, synth_molecule_linelist  # noqa: E402

N_LINES, N_MOL_LINES = 300, 200
LINE_RANGE = (6499.0, 6506.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("coupled", [False, True], ids=["pairwise", "coupled"])
def test_giant_with_every_branch_matches_jax(tmp_path, coupled):
    model = str(tmp_path / "giant.mod")
    write_marcs_file(model, teff=4000.0, logg=2.0, spherical=True, radius_cm=2e12)
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": model, "final_atomic_number": 30},
        "opacity": {
            "file": write_opacity_tables(tmp_path),
            "bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H", "H2"],
            "line": {
                "disable": False,
                "broadening": ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"],
                "vald_linelist": {"use_linelist": True, "use_vald_broadening": True},
                "include_molecules": True,
                "molecules_coupled": coupled,
                "window_mode": "accuracy",
            },
        },
        "no_of_thetas": 4,
        "result_options": {"return_radiation_field": True, "return_plasma": True},
    }
    lams = np.arange(6500.0, 6505.0, 0.05)

    atom_data = build_builtin_atom_data(30, include_linelists=True, include_molecules=True)
    synth_linelist(atom_data, N_LINES, *LINE_RANGE)
    synth_molecule_linelist(atom_data, N_MOL_LINES, *LINE_RANGE)
    ours = stardis_tpu_torch.run_stardis(copy.deepcopy(cfg), tu.Quantity(lams, tu.AA),
                                         atom_data=atom_data)

    path = tmp_path / "c.yml"
    path.write_text(yaml.safe_dump(cfg))
    config, adata, model_j = stardis_tpu.parse_config_to_model(str(path))
    jax_synth_linelist(adata, N_LINES, *LINE_RANGE)
    adata.linelist_molecules = pd.DataFrame(dict(atom_data.linelist_molecules.columns))
    nus = np.asarray(ju.Quantity(lams, ju.AA).to(ju.Hz, ju.spectral()))
    plan = build_simulation_plan(config, adata, model_j, nus)
    assert plan.inward_rays and plan.window_mode == "accuracy"
    assert plan.molecule_line_data.n_lines > 50 and len(plan.file_sources) == 3
    f_ref, _, opac_ref, i_ref, _, _ = run_simulation(plan)

    rf = ours.stellar_radiation_field
    np.testing.assert_allclose(rf.F_nu.numpy(), np.asarray(f_ref), rtol=1e-9, atol=1e-300)
    np.testing.assert_allclose(rf.I_nus.numpy(), np.asarray(i_ref), rtol=1e-9, atol=1e-300)
    key = "molecule_alpha_line_at_nu"
    np.testing.assert_allclose(rf.opacities.opacities_dict[key].numpy(),
                               np.asarray(opac_ref[key]), rtol=1e-9, atol=1e-300)
    assert ours.stellar_plasma.molecule_number_density.values.shape[1] == 56
