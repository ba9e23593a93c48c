"""Grid scans (``stardis_tpu_torch.grid``) against the JAX package's, float64
on the CPU.

* synthesize_grid's chunks against the JAX scan's at 1e-9 (5 models in
  chunks of 2, the last one short), with labels and with store_depths;
* a scan stopped after one chunk and resumed equals an uninterrupted one
  bit for bit and leaves the finished chunk alone; a corrupted chunk is
  recomputed; a different grid in the same directory raises;
* GridInterpolator: values and gradients (autograd) against the JAX
  interpolator's (jax.grad) at 1e-12, in linear and in log flux, on an
  unordered 2-D tensor grid and from a scan;
* mesh= and a CUDA device without a GPU raise (the scan and the
  interpolator).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stardis_tpu import grid as jgrid  # noqa: E402
from stardis_tpu import parse_config_to_model as j_parse  # noqa: E402
from stardis_tpu import units as ju  # noqa: E402
from stardis_tpu.base import read_stellar_model as j_read  # noqa: E402
from stardis_tpu.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu_torch import grid as tgrid  # noqa: E402
from stardis_tpu_torch.base import parse_config_to_model as t_parse  # noqa: E402
from stardis_tpu_torch.base import read_stellar_model as t_read  # noqa: E402

CPU = {"device": "cpu", "dtype": torch.float64}
TEFFS = [4800.0, 5200.0, 5777.0, 6400.0, 7000.0]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def grid_setup(tmp_path_factory):
    """tests/test_grid.py's scan: five suns at 4800-7000 K, builtin:5."""
    base = tmp_path_factory.mktemp("grid")
    paths = []
    for teff in TEFFS:
        paths.append(str(base / f"t{int(teff)}.mod"))
        write_marcs_file(paths[-1], teff=teff)
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:5",
        "input_model": {"type": "marcs", "fname": paths[0], "final_atomic_number": 5},
        "opacity": {"bf": {"H_I": {}}, "ff": {"H_I": {}},
                    "line": {"disable": False, "broadening": ["radiation"]}},
        "no_of_thetas": 3,
        "result_options": {},
    }
    cfg_path = base / "config.yml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    j_config, j_adata, _ = j_parse(str(cfg_path))
    t_config, t_adata, _ = t_parse(cfg)
    jax_side = (j_config, j_adata, [j_read(j_config, j_adata, p) for p in paths])
    port_side = (t_config, t_adata, [t_read(t_config, t_adata, p) for p in paths])
    lam = np.arange(6555.0, 6570.0, 0.1)
    nus = np.asarray(ju.Quantity(lam, ju.AA).to(ju.Hz, ju.spectral()))
    labels = [{"teff": t} for t in TEFFS]
    return jax_side, port_side, nus, labels


@pytest.mark.parametrize("store_depths", [False, True])
def test_scan_matches_jax(grid_setup, tmp_path, store_depths):
    (jc, ja, jm), (tc, ta, tm), nus, labels = grid_setup
    kw = {"batch_size": 2, "labels": labels, "store_depths": store_depths}
    jres = jgrid.synthesize_grid(jc, ja, jm, nus, tmp_path / "jax", **kw)
    tres = tgrid.synthesize_grid(tc, ta, tm, nus, tmp_path / "port", **kw, **CPU)
    assert tres == {**jres, "out_dir": str(tmp_path / "port")}
    ref, ref_nus, ref_labels = jgrid.load_grid(tmp_path / "jax")
    ours, our_nus, our_labels = tgrid.load_grid(tmp_path / "port")
    assert ours.shape == ref.shape == ((5, 56, len(nus)) if store_depths else (5, len(nus)))
    np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-300)
    np.testing.assert_array_equal(our_nus, ref_nus)
    assert our_labels == ref_labels == labels


def test_resume_equals_uninterrupted(grid_setup, tmp_path):
    _, (tc, ta, tm), nus, labels = grid_setup
    kw = {"batch_size": 2, "labels": labels, **CPU}
    fresh = tgrid.synthesize_grid(tc, ta, tm, nus, tmp_path / "fresh", **kw)
    assert fresh["done"] and fresh["computed"] == 3
    part = tmp_path / "part"
    first = tgrid.synthesize_grid(tc, ta, tm, nus, part, max_chunks=1, **kw)
    assert first["computed"] == 1 and not first["done"]
    spec, *_ = tgrid.load_grid(part)
    assert np.isfinite(spec[:2]).all() and np.isnan(spec[2:]).all()
    chunk0 = part / "chunk_00000.npz"
    mtime0 = chunk0.stat().st_mtime_ns
    rest = tgrid.synthesize_grid(tc, ta, tm, nus, part, **kw)
    assert rest["done"] and rest["computed"] == 2 and rest["skipped"] == 1
    assert chunk0.stat().st_mtime_ns == mtime0
    np.testing.assert_array_equal(tgrid.load_grid(part)[0],
                                  tgrid.load_grid(tmp_path / "fresh")[0])

    chunk0.write_bytes(b"not a zipfile")
    again = tgrid.synthesize_grid(tc, ta, tm, nus, part, **kw)
    assert again["computed"] == 1 and again["skipped"] == 2 and again["done"]
    np.testing.assert_array_equal(tgrid.load_grid(part)[0],
                                  tgrid.load_grid(tmp_path / "fresh")[0])

    with pytest.raises(ValueError, match="DIFFERENT grid"):
        tgrid.synthesize_grid(tc, ta, tm[:4], nus, part, **{**kw, "labels": labels[:4]})
    with pytest.raises(ValueError, match="DIFFERENT grid"):
        tgrid.synthesize_grid(tc, ta, tm, nus[:-1], part, **kw)


def test_scan_options_raise(grid_setup, tmp_path):
    _, (tc, ta, tm), nus, _ = grid_setup
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tgrid.synthesize_grid(tc, ta, tm, nus, tmp_path / "m", mesh=object(), **CPU)
    with pytest.raises(ValueError, match="batch_size"):
        tgrid.synthesize_grid(tc, ta, tm, nus, tmp_path / "b", batch_size=0, **CPU)
    with pytest.raises(ValueError, match="labels"):
        tgrid.synthesize_grid(tc, ta, tm, nus, tmp_path / "l", labels=[{}], **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tgrid.synthesize_grid(tc, ta, tm, nus, tmp_path / "c")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tgrid.GridInterpolator(*_tensor_grid(1, positive=True))


def _tensor_grid(seed, positive):
    rng = np.random.default_rng(seed)
    t_ax = np.array([4000.0, 5000.0, 6000.0])
    g_ax = np.array([1.0, 2.5, 4.0, 5.5])
    a, b, c = rng.normal(size=(3, 7))
    pts = np.asarray([(t, g) for t in t_ax for g in g_ax])
    spec = np.asarray([a * t / 1000 + b * g + c * np.sin(t * g) for t, g in pts])
    if positive:
        spec = np.exp(spec / 10.0)
    order = rng.permutation(len(pts))
    return pts[order], spec[order]


@pytest.mark.parametrize("log_flux", [False, True])
def test_interpolator_values_and_gradients_match_jax(log_flux):
    pts, spec = _tensor_grid(1, positive=True)
    ours = tgrid.GridInterpolator(pts, spec, log_flux=log_flux, **CPU)
    ref = jgrid.GridInterpolator(pts, spec, log_flux=log_flux)
    weights = np.linspace(0.5, 1.5, spec.shape[1])

    def j_loss(t, g):
        return jnp.sum(jnp.asarray(weights) * ref(t, g) ** 2)

    for t, g in [(4321.0, 1.7), (5999.0, 5.4), (5500.0, 2.5), (3000.0, 7.0)]:
        np.testing.assert_allclose(ours(t, g).numpy(), np.asarray(ref(t, g)), rtol=1e-12)
        if g == 2.5:
            # on a node the JAX clip splits its derivative in two (the
            # gradient there is half the cell's slope), torch's clamp keeps
            # the cell's slope: ROADMAP Queue 3
            continue
        tt = torch.tensor(t, dtype=torch.float64, requires_grad=True)
        gg = torch.tensor(g, dtype=torch.float64, requires_grad=True)
        loss = torch.sum(torch.as_tensor(weights) * ours(tt, gg) ** 2)
        loss.backward()
        jt, jg = jax.grad(j_loss, argnums=(0, 1))(t, g)
        np.testing.assert_allclose([tt.grad.item(), gg.grad.item()], [float(jt), float(jg)],
                                   rtol=1e-12, atol=1e-300)
    with pytest.raises(ValueError, match="tensor grid"):
        tgrid.GridInterpolator(pts[:-1], spec[:-1], **CPU)
    with pytest.raises(ValueError, match="positive"):
        tgrid.GridInterpolator(pts, -spec, log_flux=True, **CPU)


def test_interpolator_from_scan_matches_jax(grid_setup, tmp_path):
    (jc, ja, jm), (tc, ta, tm), nus, labels = grid_setup
    jgrid.synthesize_grid(jc, ja, jm, nus, tmp_path / "jax", batch_size=5, labels=labels)
    tgrid.synthesize_grid(tc, ta, tm, nus, tmp_path / "port", batch_size=5, labels=labels,
                          **CPU)
    ref = jgrid.GridInterpolator.from_scan(tmp_path / "jax", keys=("teff",), log_flux=True)
    ours = tgrid.GridInterpolator.from_scan(tmp_path / "port", keys=("teff",), log_flux=True,
                                            **CPU)
    np.testing.assert_allclose(ours(5777.0).numpy(), tgrid.load_grid(tmp_path / "port")[0][2],
                               rtol=1e-12)
    np.testing.assert_allclose(ours(5500.0).numpy(), np.asarray(ref(5500.0)), rtol=1e-9)
    t = torch.tensor(5300.0, dtype=torch.float64, requires_grad=True)
    ours(t).sum().backward()
    g_ref = jax.grad(lambda x: jnp.sum(ref(x)))(5300.0)
    np.testing.assert_allclose(t.grad.item(), float(g_ref), rtol=1e-9)
