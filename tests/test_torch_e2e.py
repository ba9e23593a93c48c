"""The slice end to end: ``stardis_tpu_torch.run_stardis`` on the CPU in
float64 against the JAX package on the same configs, F_nu at rtol 1e-9.

Configs: builtin:2 with TARDIS H lines on 250 lambda (the e2e-oracle
config), and builtin:30 on 1,000 lambda (6500-6510 AA at 0.01 AA) with
2,000 synthetic lines and VALD broadening (the Sim100AA config cut in
width of the grid and the line list)."""

import copy

import numpy as np
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
from stardis_tpu_torch.opacities.lines import synth_linelist  # noqa: E402

RTOL = 1e-9
BROADENING = ["radiation", "linear_stark", "quadratic_stark", "van_der_waals"]
N_SYNTH_LINES = 2000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(model_path, vald):
    line = {"disable": False, "broadening": BROADENING}
    if vald:
        line["vald_linelist"] = {"use_linelist": True, "use_vald_broadening": True}
    return {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30" if vald else "builtin:2",
        "input_model": {
            "type": "marcs", "fname": model_path,
            "final_atomic_number": 30 if vald else 2,
        },
        "opacity": {
            "bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
            "disable_electron_scattering": False, "line": line,
        },
        "no_of_thetas": 20 if vald else 5,
        "result_options": {"return_radiation_field": True, "return_plasma": True},
    }


@pytest.fixture(scope="module", params=["tardis", "vald"])
def runs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e")
    model = str(tmp / "sun.mod")
    write_marcs_file(model)
    vald = request.param == "vald"
    cfg = _config(model, vald)
    cfg_path = tmp / "config.yml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    lams = np.arange(6500.0, 6510.0, 0.01) if vald else np.arange(6540.0, 6590.0, 0.2)

    if vald:
        config, adata, model_j = stardis_tpu.parse_config_to_model(str(cfg_path))
        jax_synth_linelist(adata, N_SYNTH_LINES, lam_lo=6499.0, lam_hi=6511.0)
        nus = np.asarray(ju.Quantity(lams, ju.AA).to(ju.Hz, ju.spectral()))
        plan = build_simulation_plan(config, adata, model_j, nus)
        f_nu, _, _, i_nus, _, _ = run_simulation(plan)
        ref = {"F_nu": np.asarray(f_nu), "I_nus": np.asarray(i_nus),
               "nus": plan.tracing_nus, "spectrum_nu": np.asarray(f_nu)[-1]}
        atom_data = synth_linelist(
            build_builtin_atom_data(30, include_linelists=True), N_SYNTH_LINES,
            lam_lo=6499.0, lam_hi=6511.0,
        )
    else:
        out = stardis_tpu.run_stardis(str(cfg_path), ju.Quantity(lams, ju.AA))
        rf = out.stellar_radiation_field
        ref = {"F_nu": np.asarray(rf.F_nu), "I_nus": np.asarray(rf.I_nus),
               "nus": np.asarray(out.nus), "spectrum_nu": np.asarray(out.spectrum_nu),
               "spectrum_lambda": np.asarray(out.spectrum_lambda)}
        atom_data = None
    ours = stardis_tpu_torch.run_stardis(
        copy.deepcopy(cfg), tu.Quantity(lams, tu.AA), device="cpu",
        dtype=torch.float64, atom_data=atom_data,
    )
    return ref, ours


def test_flux_matches_jax(runs):
    ref, ours = runs
    f_nu = ours.stellar_radiation_field.F_nu
    assert f_nu.dtype == torch.float64 and f_nu.device.type == "cpu"
    np.testing.assert_allclose(f_nu.numpy(), ref["F_nu"], rtol=RTOL, atol=1e-300)
    np.testing.assert_allclose(np.asarray(ours.spectrum_nu), ref["spectrum_nu"], rtol=RTOL)


def test_intensities_match_jax(runs):
    ref, ours = runs
    i_nus = ours.stellar_radiation_field.I_nus.numpy()
    assert i_nus.shape == ref["I_nus"].shape
    np.testing.assert_allclose(i_nus, ref["I_nus"], rtol=RTOL, atol=1e-300)


def test_output_surface(runs):
    ref, ours = runs
    np.testing.assert_array_equal(np.asarray(ours.nus), ref["nus"])
    if "spectrum_lambda" in ref:
        np.testing.assert_allclose(
            np.asarray(ours.spectrum_lambda), ref["spectrum_lambda"], rtol=RTOL
        )
    assert not hasattr(ours, "stellar_model")
    assert ours.stellar_plasma.electron_densities.shape == (56,)
    opac = ours.stellar_radiation_field.opacities
    assert "alpha_line_at_nu" in opac.opacities_dict
    assert opac.total_alphas.shape == ours.stellar_radiation_field.F_nu.shape


def _base_config(tmp_path):
    model = str(tmp_path / "sun.mod")
    write_marcs_file(model)
    return _config(model, vald=False)


def _write_hminus_bf(path):
    lam = np.linspace(2000.0, 15000.0, 50)
    sig = 4e-17 * np.exp(-(((lam - 8500.0) / 4000.0) ** 2))
    path.write_text("".join(f"{wl:.1f},{s:.4e}\n" for wl, s in zip(lam, sig)))
    return str(path)


@pytest.mark.parametrize(
    "edit, ported_key",
    [
        (lambda c, d: c["opacity"]["line"].update(include_molecules=True), None),
        (lambda c, d: c["opacity"]["line"].update(window_mode="accuracy"), None),
        (lambda c, d: c["opacity"].update(file={"Hminus_bf": _write_hminus_bf(d / "hm.dat")}),
         "alpha_file_Hminus_bf"),
        (lambda c, d: c["input_model"].update(type="mesa"), "raises"),
    ],
    ids=["molecules", "accuracy", "file", "mesa"],
)
def test_out_of_slice_branches_raise(tmp_path, edit, ported_key):
    """Molecules, accuracy windows and file opacities are in the slice now:
    those branches run; MESA models still raise naming ROADMAP.md."""
    cfg = _base_config(tmp_path)
    cfg["result_options"] = {"return_radiation_field": True, "return_plasma": True}
    edit(cfg, tmp_path)
    lam = tu.Quantity(np.arange(6560.0, 6561.0, 0.5), tu.AA)
    if ported_key == "raises":
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            stardis_tpu_torch.run_stardis(cfg, lam, device="cpu", dtype=torch.float64)
        return
    out = stardis_tpu_torch.run_stardis(cfg, lam, device="cpu", dtype=torch.float64)
    assert np.isfinite(np.asarray(out.spectrum_nu)).all()
    if ported_key:
        assert ported_key in out.stellar_radiation_field.opacities.opacities_dict
    if cfg["opacity"]["line"].get("include_molecules"):
        densities = out.stellar_plasma.molecule_number_density
        assert "H2" in densities.names and densities.values.shape[1] == 56


def test_spherical_and_partition_options_raise(tmp_path):
    """Spherical models run (the inward sweep is ported); nu_segments=2
    runs and equals the unsegmented run; a bad segment count and mesh=
    raise."""
    lam = tu.Quantity(np.arange(6560.0, 6561.0, 0.1), tu.AA)
    sph = str(tmp_path / "sph.mod")
    write_marcs_file(sph, spherical=True)
    cfg = _base_config(tmp_path)
    cfg["input_model"]["fname"] = sph
    whole = stardis_tpu_torch.run_stardis(cfg, lam, device="cpu", dtype=torch.float64)
    assert (np.asarray(whole.spectrum_nu) > 0).all()
    halves = stardis_tpu_torch.run_stardis(cfg, lam, device="cpu", dtype=torch.float64,
                                           nu_segments=2)
    np.testing.assert_allclose(halves.stellar_radiation_field.F_nu.numpy(),
                               whole.stellar_radiation_field.F_nu.numpy(), rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="'auto'"):
        stardis_tpu_torch.run_stardis(cfg, lam, device="cpu", nu_segments="many")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        stardis_tpu_torch.run_stardis(_base_config(tmp_path), lam, mesh=object(), device="cpu", dtype=torch.float64)
    with pytest.raises(TypeError):
        stardis_tpu_torch.run_stardis(_base_config(tmp_path), np.arange(3.0), device="cpu", dtype=torch.float64)


def test_cuda_device_without_gpu_raises(tmp_path):
    """The entry points run on the card by default and raise without one;
    they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error path does not apply")
    lam = tu.Quantity(np.arange(6560.0, 6561.0, 0.5), tu.AA)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stardis_tpu_torch.run_stardis(_base_config(tmp_path), lam, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stardis_tpu_torch.run_stardis(_base_config(tmp_path), lam)


def test_tf32_switch_is_scoped_to_the_bf_product(tmp_path, monkeypatch):
    """run_simulation turns TF32 off for the bf product only and leaves the
    process-wide switch as it found it."""
    from stardis_tpu_torch import pipeline as tpipe
    from stardis_tpu_torch.base import parse_config_to_model
    from stardis_tpu_torch.opacities import continuum as tcont

    seen = []
    real_bf = tcont.calc_alpha_bf_hydrogenic

    def spy(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_bf(*args, **kwargs)

    monkeypatch.setattr(tcont, "calc_alpha_bf_hydrogenic", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    config, adata, model = parse_config_to_model(_base_config(tmp_path))
    nus = tu.Quantity(np.arange(6560.0, 6562.0, 0.5), tu.AA).to(tu.Hz, tu.spectral()).value
    tpipe.run_simulation(tpipe.build_simulation_plan(config, adata, model, nus), device="cpu", dtype=torch.float64)
    assert seen == [False]
    assert torch.backends.cuda.matmul.allow_tf32 is True
