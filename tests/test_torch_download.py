"""``stardis_tpu_torch.atom_data.download_atom_data`` against the JAX
package's, on ``file://`` URLs only (the counterparts of
tests/test_convert.py's download tests): a store fetched and converted,
then reused from the cache; the same file name from another source fetched
again; the error cases; the known names; and ``run_stardis`` with a
published store's name (its URL pointed at a local store) equal to the run
on the converted file's path."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
pd = pytest.importorskip("pandas")
import torch  # noqa: E402

from stardis_tpu.atom_data import download as jdl  # noqa: E402
from stardis_tpu.atom_data import synthetic_carsus as jsc  # noqa: E402
from stardis_tpu.atom_data.base import AtomData as JaxAtomData  # noqa: E402
from stardis_tpu_torch import run_stardis  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.atom_data import AtomData, download_atom_data  # noqa: E402
from stardis_tpu_torch.atom_data import convert as cv  # noqa: E402
from stardis_tpu_torch.atom_data import download as dl  # noqa: E402
from stardis_tpu_torch.atom_data import synthetic_carsus as sc  # noqa: E402
from stardis_tpu_torch.constants import EV_TO_ERG  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu_torch.util.regression import golden_config  # noqa: E402

from test_torch_carsus import (  # noqa: E402
    assert_jax_atom_data_equal,
    jax_toy_frames,
    to_table,
    toy_frames,
)

LAMBDA = (5150.0, 5160.0, 0.05)  # AA


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_download_file_url_and_convert(tmp_path):
    src = tmp_path / "kurucz_like.h5"
    sc.write_store(toy_frames(), src)
    dest = tmp_path / "cache"
    path = download_atom_data(src.as_uri(), dest_dir=dest)
    assert path.endswith("kurucz_like_native.h5")
    adata = AtomData.from_hdf(path)
    np.testing.assert_allclose(adata.ionization_energy(1, 1), 13.598434 * EV_TO_ERG, rtol=1e-10)
    assert len(adata.lines) == 1
    assert (dest / "kurucz_like.h5.source").read_text() == src.as_uri() + "\n"

    # the JAX package's download of its own store of the same frames gives
    # the same converted store
    jsrc = tmp_path / "jax" / "kurucz_like.h5"
    jsrc.parent.mkdir()
    jsc.write_store(jax_toy_frames(), jsrc)
    ref = jdl.download_atom_data(jsrc.as_uri(), dest_dir=tmp_path / "jax_cache")
    assert_jax_atom_data_equal(JaxAtomData.from_hdf(path), JaxAtomData.from_hdf(ref))

    # cached: a second call reuses both files
    raw, native = dest / "kurucz_like.h5", dest / "kurucz_like_native.h5"
    stamps = (raw.stat().st_mtime_ns, native.stat().st_mtime_ns)
    assert download_atom_data(src.as_uri(), dest_dir=dest) == path
    assert (raw.stat().st_mtime_ns, native.stat().st_mtime_ns) == stamps
    # convert=False returns the raw carsus copy; overwrite fetches again
    assert download_atom_data(src.as_uri(), dest_dir=dest, convert=False) == str(raw)
    assert download_atom_data(src.as_uri(), dest_dir=dest, overwrite=True) == path
    assert raw.stat().st_mtime_ns >= stamps[0]
    assert sorted(p.name for p in dest.iterdir()) == [
        "kurucz_like.h5", "kurucz_like.h5.source", "kurucz_like_native.h5"]


def test_download_same_name_different_source_refetches(tmp_path):
    """The cache is keyed by file name; a same-named file from another
    source URL is fetched again, not reused."""
    src_a, src_b = tmp_path / "a" / "store.h5", tmp_path / "b" / "store.h5"
    src_a.parent.mkdir()
    src_b.parent.mkdir()
    sc.write_store(toy_frames(), src_a)
    frames_b = jax_toy_frames()
    frames_b["lines"] = pd.concat([frames_b["lines"]] * 2, ignore_index=True)
    sc.write_store({k: to_table(v) for k, v in frames_b.items()}, src_b)
    dest = tmp_path / "cache"
    path_a = download_atom_data(src_a.as_uri(), dest_dir=dest)
    assert len(AtomData.from_hdf(path_a).lines) == 1
    path_b = download_atom_data(src_b.as_uri(), dest_dir=dest)
    assert path_b == path_a
    assert len(AtomData.from_hdf(path_b).lines) == 2


def test_download_atom_data_errors(tmp_path):
    with pytest.raises(ValueError, match="known names"):
        download_atom_data("no_such_store", dest_dir=tmp_path)
    with pytest.raises(RuntimeError, match="download failed"):
        download_atom_data((tmp_path / "missing.h5").as_uri(), dest_dir=tmp_path)
    # a failed download leaves neither a partial nor a final file
    assert list(tmp_path.iterdir()) == []
    # a failed conversion leaves no partial native store
    bad = tmp_path / "src" / "bad.h5"
    bad.parent.mkdir()
    with h5py.File(bad, "w") as f:
        f.create_group("unrelated")
    dest = tmp_path / "cache"
    with pytest.raises(ValueError, match="lacks required tables"):
        download_atom_data(bad.as_uri(), dest_dir=dest)
    assert sorted(p.name for p in dest.iterdir()) == ["bad.h5", "bad.h5.source"]


def test_known_names_resolve_to_reference_source(monkeypatch, tmp_path):
    assert dl.KNOWN_ATOM_DATA == jdl.KNOWN_ATOM_DATA
    url = dl.KNOWN_ATOM_DATA["kurucz_cd23_chianti_H_He"]
    assert url.startswith("https://github.com/tardis-sn/tardis-regression-data")
    assert url.endswith("kurucz_cd23_chianti_H_He.h5")
    monkeypatch.setenv("STARDIS_DATA_DIR", str(tmp_path / "data"))
    assert dl.default_data_dir() == jdl.default_data_dir() == tmp_path / "data"
    monkeypatch.delenv("STARDIS_DATA_DIR")
    assert dl.default_data_dir() == jdl.default_data_dir()


def test_run_stardis_with_downloaded_store_equals_path_route(tmp_path, monkeypatch):
    """``atom_data: <published name>`` downloads (here from a file://
    URL) and converts into $STARDIS_DATA_DIR, and runs equal to the same
    store converted by hand and named by its path, bit for bit."""
    frames = sc.build_carsus_frames(n_lines=20_000, n_vald_lines=15_000)
    src = tmp_path / "src" / "kurucz_cd23_chianti_H_He.h5"
    src.parent.mkdir()
    sc.write_store(frames, src)
    by_hand = tmp_path / "by_hand.h5"
    cv.convert(src, by_hand)
    monkeypatch.setitem(dl.KNOWN_ATOM_DATA, "kurucz_cd23_chianti_H_He", src.as_uri())
    monkeypatch.setenv("STARDIS_DATA_DIR", str(tmp_path / "data"))
    model = tmp_path / "sun.mod"
    write_marcs_file(model)
    lams = tu.Quantity(np.arange(*LAMBDA), tu.AA)
    runs = [run_stardis(golden_config("carsus_scale", model, atom_data=spec), lams,
                        device="cpu", dtype=torch.float64)
            for spec in ("kurucz_cd23_chianti_H_He", by_hand)]
    assert (tmp_path / "data" / "kurucz_cd23_chianti_H_He_native.h5").exists()
    flux = np.asarray(runs[0].spectrum_nu)
    assert np.isfinite(flux).all() and (flux > 0).all()
    np.testing.assert_array_equal(flux, np.asarray(runs[1].spectrum_nu))
    np.testing.assert_array_equal(runs[0].stellar_plasma.electron_densities.numpy(),
                                  runs[1].stellar_plasma.electron_densities.numpy())
