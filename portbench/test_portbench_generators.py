"""The frozen input generators give the same draws for the same seed."""

import numpy as np

from portbench import bench, inputs
from portbench.reference.atom_data.builtin import build_builtin_atom_data
from portbench.reference.opacities.lines import synth_linelist, synth_molecule_linelist


def test_line_lists_repeat_for_a_seed():
    def lists(seed):
        adata = build_builtin_atom_data(30, include_linelists=True, include_molecules=True)
        synth_linelist(adata, 500, seed=seed)
        synth_molecule_linelist(adata, 200, seed=seed + 4)
        return adata.linelist_atoms.columns, adata.linelist_molecules.columns

    a, b, c = lists(7), lists(7), lists(8)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert not np.array_equal(a[0]["wavelength"], c[0]["wavelength"])


def test_models_and_traffic_repeat_for_a_seed(tmp_path):
    config = bench.load_json("configs", "giant_mol")
    paths = [inputs.write_model(config, tmp_path / f"m{i}.mod", t_scale=1.02, teff=3900.0)
             for i in range(2)]
    assert open(paths[0]).read() == open(paths[1]).read()
    base = open(inputs.write_model(config, tmp_path / "b.mod", teff=3900.0)).read()
    assert base != open(paths[0]).read()

    def draws(seed):
        return bench.stratified(np.random.default_rng(bench.seed_words(seed, 0)), 64, 0.97, 1.03)

    big = 2**31 + 12345
    assert np.array_equal(draws(big), draws(big))
    assert not np.array_equal(draws(big), draws(big + 1))
    d = draws(big)
    assert d.min() >= 0.97 and d.max() < 1.03
    # one draw in each of the 64 strata
    assert np.array_equal(np.sort(np.floor((d - 0.97) / 0.06 * 64)), np.arange(64))


def test_scaled_temperatures(tmp_path):
    from portbench.reference.io.marcs import read_marcs_model

    config = bench.load_json("configs", "sim100aa_sun")
    a = read_marcs_model(inputs.write_model(config, tmp_path / "a.mod")).data["t"]
    b = read_marcs_model(inputs.write_model(config, tmp_path / "b.mod", t_scale=1.03)).data["t"]
    assert np.allclose(b, a * 1.03, atol=0.05)
