"""SpectralService: the port's serving layer against the JAX package's,
request by request, float64 on the CPU, at 1e-9.

* builtin:30 with its VALD lines on 5885-5900 AA (tests/test_serving.py's
  config): the sun, a warm and a hot atmosphere in turn (the hot one
  re-tiers the JAX service, which runs at tier margin 1); unsegmented and
  through nu_segments=3; with return_radiation_field, I_nu;
* file opacities (the three synthetic tables): a request at other
  temperatures re-interpolates the sigma tables in both services, counted
  alike in sigma_reinterp_events;
* spherical requests that differ from the template (chords and the
  photospheric correction), segmented;
* synthesize_batch against the JAX service's;
* the request guards raise the JAX errors; a plan with molecules refuses
  other temperatures than its own; mesh=, bad segment counts and a CUDA
  device without a GPU raise.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import torch  # noqa: E402

from stardis_tpu import parse_config_to_model as j_parse  # noqa: E402
from stardis_tpu import units as ju  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu.serving import SpectralService as JService  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.base import read_stellar_model  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_opacity_tables  # noqa: E402
from stardis_tpu_torch.serving import SpectralService  # noqa: E402

RTOL = 1e-9
CPU = {"device": "cpu", "dtype": torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(base, members, config, lams):
    """Model files, the config as a dict and as YAML, the wavelength grid
    in both packages' units."""
    paths = {}
    for name, kw in members.items():
        paths[name] = str(base / f"{name}.mod")
        write_marcs_file(paths[name], **kw)
    config["input_model"]["fname"] = paths[next(iter(members))]
    cfg_path = base / "c.yml"
    cfg_path.write_text(yaml.safe_dump(config))
    return paths, config, str(cfg_path), ju.Quantity(lams, ju.AA), tu.Quantity(lams, tu.AA)


def _services(setup, **kw):
    paths, cfg, cfg_path, jlam, tlam = setup
    jsvc = JService(cfg_path, jlam, dtype=np.float64, **kw)
    tsvc = SpectralService(cfg, tlam, **kw, **CPU)
    return jsvc, tsvc


def _models(setup, svc, name):
    paths, _cfg, cfg_path, *_ = setup
    jmodel = j_parse(cfg_path, add_config_dict={"input_model.fname": paths[name]})[2]
    return jmodel, read_stellar_model(svc.config, svc.atom_data, paths[name])


def _serve(setup, jsvc, tsvc, name):
    jmodel, tmodel = _models(setup, tsvc, name)
    return jsvc.synthesize(jmodel), tsvc.synthesize(tmodel)


def _same(ref, ours, keys=("F_nu", "spectrum_nu", "spectrum_lambda")):
    for key in keys:
        np.testing.assert_allclose(ours[key], ref[key], rtol=RTOL, atol=1e-300, err_msg=key)
    np.testing.assert_array_equal(ours["nus"], ref["nus"])


@pytest.fixture(scope="module")
def sun_setup(tmp_path_factory):
    config = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": "", "final_atomic_number": 30},
        "opacity": {
            "bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
            "line": {
                "disable": False,
                "broadening": ["radiation", "van_der_waals"],
                "vald_linelist": {"use_linelist": True, "use_vald_broadening": True},
            },
        },
        "no_of_thetas": 5,
        "result_options": {},
    }
    members = {"sun": {"teff": 5777.0}, "warm": {"teff": 6300.0}, "hot": {"teff": 9000.0}}
    return _setup(tmp_path_factory.mktemp("serving"), members, config,
                  np.arange(5885.0, 5900.0, 0.1))


@pytest.mark.parametrize("nu_segments", [1, 3])
def test_requests_match_jax_service(sun_setup, nu_segments):
    jsvc, tsvc = _services(sun_setup, nu_segments=nu_segments)
    if nu_segments == 1:
        jsvc._tier_margin = 1.0  # the hot request outgrows the sun's tiers
    for name in ("sun", "warm", "hot", "sun"):
        ref, ours = _serve(sun_setup, jsvc, tsvc, name)
        _same(ref, ours)
        assert "I_nus" not in ours
    if nu_segments == 1:
        assert jsvc.stats.retier_events >= 1
    assert tsvc.stats.requests == 4 and tsvc.stats.compiles == 1
    assert tsvc.stats.retier_events == 0


@pytest.mark.parametrize("nu_segments", [1, 3])
def test_intensities_match_jax_service(sun_setup, nu_segments):
    opts = {"result_options.return_radiation_field": True}
    jsvc, tsvc = _services(sun_setup, nu_segments=nu_segments, add_config_dict=opts)
    ref, ours = _serve(sun_setup, jsvc, tsvc, "warm")
    _same(ref, ours, ("F_nu", "I_nus"))


def test_auto_segments_under_a_budget(sun_setup, monkeypatch):
    monkeypatch.setenv("STARDIS_SEGMENT_BUDGET", str(1 << 19))
    jsvc, tsvc = _services(sun_setup)
    auto = SpectralService(sun_setup[1], sun_setup[4], nu_segments="auto", **CPU)
    ref, ours = _serve(sun_setup, jsvc, tsvc, "sun")
    served = auto.synthesize(_models(sun_setup, auto, "sun")[1])
    assert auto._nu_segments > 1
    np.testing.assert_allclose(served["F_nu"], ours["F_nu"], rtol=1e-12, atol=0)
    _same(ref, served)


def test_batch_matches_jax_service(sun_setup):
    jsvc, tsvc = _services(sun_setup)
    names = ("sun", "warm", "hot")
    jmodels, tmodels = zip(*(_models(sun_setup, tsvc, n) for n in names))
    ref = jsvc.synthesize_batch(list(jmodels))
    ours = tsvc.synthesize_batch(list(tmodels))
    assert ours.shape == (3, 56, 150)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=1e-300)
    again = tsvc.synthesize_batch(list(tmodels))
    np.testing.assert_array_equal(again, ours)
    assert tsvc.stats.requests == 6 and tsvc.stats.compiles == 1


def test_file_opacities_reinterpolated_like_jax(tmp_path):
    config = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:5",
        "input_model": {"type": "marcs", "fname": "", "final_atomic_number": 5},
        "opacity": {"file": write_opacity_tables(tmp_path), "bf": {"H_I": {}},
                    "ff": {"H_I": {}}, "line": {"disable": True}},
        "no_of_thetas": 3,
        "result_options": {},
    }
    setup = _setup(tmp_path, {"sun": {"teff": 5777.0}, "hot": {"teff": 9000.0}}, config,
                   np.arange(6560.0, 6565.0, 0.1))
    for nu_segments in (1, 3):
        jsvc, tsvc = _services(setup, nu_segments=nu_segments)
        for name, events in (("sun", 0), ("hot", 1), ("sun", 1)):
            ref, ours = _serve(setup, jsvc, tsvc, name)
            _same(ref, ours)
            assert tsvc.stats.sigma_reinterp_events == jsvc.stats.sigma_reinterp_events == events
    jmodels, tmodels = zip(*(_models(setup, tsvc, n) for n in ("sun", "hot")))
    np.testing.assert_allclose(tsvc.synthesize_batch(list(tmodels)),
                               jsvc.synthesize_batch(list(jmodels)), rtol=RTOL, atol=1e-300)


def test_spherical_segmented_requests_match_jax(tmp_path):
    config = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:5",
        "input_model": {"type": "marcs", "fname": "", "final_atomic_number": 5},
        "opacity": {"bf": {"H_I": {}}, "line": {"disable": False, "broadening": ["radiation"]}},
        "no_of_thetas": 4,
        "result_options": {},
    }
    members = {"tpl": {"teff": 5777.0, "spherical": True},
               "other": {"teff": 6200.0, "spherical": True, "radius_cm": 9.0e10}}
    setup = _setup(tmp_path, members, config, np.arange(6560.0, 6566.0, 0.1))
    jsvc, tsvc = _services(setup, nu_segments=3)
    for name in ("tpl", "other"):
        ref, ours = _serve(setup, jsvc, tsvc, name)
        _same(ref, ours)


def test_guards_raise_as_jax(tmp_path, sun_setup):
    paths, cfg, cfg_path, jlam, tlam = sun_setup
    jsvc, tsvc = _services(sun_setup)
    _serve(sun_setup, jsvc, tsvc, "sun")
    for name, kw, match in (
        ("sph", {"spherical": True}, "geometry"),
        ("deep", {"n_depth": 40}, "depth count"),
    ):
        path = str(tmp_path / f"{name}.mod")
        write_marcs_file(path, **kw)
        jmodel = j_parse(cfg_path, add_config_dict={"input_model.fname": path})[2]
        tmodel = read_stellar_model(tsvc.config, tsvc.atom_data, path)
        for svc, model in ((jsvc, jmodel), (tsvc, tmodel)):
            with pytest.raises(ValueError, match=match):
                svc.synthesize(model)
    jmodel, tmodel = _models(sun_setup, tsvc, "warm")
    jmodel.microturbulence = jmodel.microturbulence * 2.0
    tmodel.microturbulence = tmodel.microturbulence * 2.0
    for svc, model in ((jsvc, jmodel), (tsvc, tmodel)):
        with pytest.raises(ValueError, match="microturbulence"):
            svc.synthesize(model)
    mol_cfg = {**cfg, "opacity": {**cfg["opacity"], "line": {
        **cfg["opacity"]["line"], "include_molecules": True}}}
    msvc = SpectralService(mol_cfg, tlam, **CPU)
    msvc.synthesize(read_stellar_model(msvc.config, msvc.atom_data, paths["sun"]))
    with pytest.raises(NotImplementedError, match="molecules"):
        msvc.synthesize(read_stellar_model(msvc.config, msvc.atom_data, paths["warm"]))
    with pytest.raises(ValueError, match="mutually exclusive"):
        SpectralService(cfg, tlam, nu_segments=2, mesh=object(), **CPU)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        SpectralService(cfg, tlam, mesh=object(), **CPU)
    with pytest.raises(ValueError, match="'auto'"):
        SpectralService(cfg, tlam, nu_segments="many", **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SpectralService(cfg, tlam)
