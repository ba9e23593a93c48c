"""Fetch published atomic-data stores (the port of
``stardis_tpu/atom_data/download.py``).

The reference obtains its atomic data by downloading the carsus-format
``kurucz_cd23_chianti_H_He.h5`` from the tardis-regression-data
repository.  ``download_atom_data`` fetches a store by name or URL,
converts it to this package's h5py layout (``atom_data.convert``, both
pandas HDFStore layouts, no PyTables) and returns a path for the config's
``atom_data`` entry.  The stores share the JAX package's layout, and so its
data directory (``$STARDIS_DATA_DIR``, else ``~/.stardis_tpu/atom_data``).

Downloads are cached: an existing completed file is reused unless
``overwrite`` is set, or unless its ``.source`` sidecar names another URL.
Writes are atomic (``.part`` + rename), so a killed download never leaves a
truncated store behind.  ``file://`` URLs work.
"""

from __future__ import annotations

import logging
import os
import shutil
import urllib.parse
import urllib.request
from pathlib import Path

logger = logging.getLogger(__name__)

_REGRESSION_DATA = "https://github.com/tardis-sn/tardis-regression-data/raw/main/atom_data"

#: name -> source URL of known published carsus stores
KNOWN_ATOM_DATA = {
    "kurucz_cd23_chianti_H_He": f"{_REGRESSION_DATA}/kurucz_cd23_chianti_H_He.h5",
}


def default_data_dir() -> Path:
    env = os.environ.get("STARDIS_DATA_DIR")
    if env:
        return Path(env).expanduser()
    return Path.home() / ".stardis_tpu" / "atom_data"


def download_atom_data(name_or_url: str = "kurucz_cd23_chianti_H_He", dest_dir=None,
                       convert: bool = True, overwrite: bool = False,
                       timeout: float = 300.0) -> str:
    """Download an atomic-data store and (by default) convert it to the
    native layout.

    Parameters
    ----------
    name_or_url : a key of ``KNOWN_ATOM_DATA`` (e.g. the reference's
        ``"kurucz_cd23_chianti_H_He"``), or any http(s)/file URL of a
        carsus-format HDF5 store.
    dest_dir : download/conversion directory (default ``default_data_dir()``).
    convert : also produce ``<name>_native.h5`` in this package's layout and
        return its path; with ``convert=False`` the raw carsus path is
        returned instead.
    overwrite : re-download / re-convert even when the files exist.

    Returns the path (str) of the usable store.
    """
    url = KNOWN_ATOM_DATA.get(name_or_url, name_or_url)
    if "://" not in url:
        raise ValueError(
            f"unknown atom-data name {name_or_url!r}; known names: "
            f"{sorted(KNOWN_ATOM_DATA)} (or pass a full URL)"
        )
    dest_dir = Path(dest_dir) if dest_dir is not None else default_data_dir()
    dest_dir.mkdir(parents=True, exist_ok=True)
    fname = Path(urllib.parse.urlparse(url).path).name or "atom_data.h5"
    raw_path = dest_dir / fname
    src_marker = raw_path.with_name(raw_path.name + ".source")

    # the cache is keyed by file name; a same-named file from another source
    # URL is fetched again, never reused: the sidecar records the source
    if raw_path.exists() and not overwrite:
        recorded = src_marker.read_text().strip() if src_marker.exists() else None
        if recorded != url:
            logger.info("Cached %s came from %s, not %s: downloading again",
                        raw_path.name, recorded or "<unknown>", url)
            overwrite = True

    if overwrite or not raw_path.exists():
        part = raw_path.with_suffix(raw_path.suffix + ".part")
        logger.info("Downloading %s -> %s", url, raw_path)
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp, open(part, "wb") as out:
                shutil.copyfileobj(resp, out)
        except Exception as exc:
            part.unlink(missing_ok=True)
            raise RuntimeError(f"atom-data download failed from {url}: {exc}") from exc
        os.replace(part, raw_path)
        src_marker.write_text(url + "\n")
    else:
        logger.info("Atom data already present: %s", raw_path)

    if not convert:
        return str(raw_path)

    native_path = raw_path.with_name(raw_path.stem + "_native.h5")
    if overwrite or not native_path.exists():
        from .convert import convert as _convert

        logger.info("Converting %s -> %s", raw_path, native_path)
        tmp = native_path.with_suffix(".h5.part")
        try:
            _convert(raw_path, tmp)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        os.replace(tmp, native_path)
    return str(native_path)
