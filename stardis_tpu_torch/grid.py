"""Spectral-library grid scans with checkpoint and resume (the port of
``stardis_tpu/grid.py``).

``synthesize_grid`` cuts the model list into chunks of ``batch_size``
models, runs each chunk through ``parallel.batch.run_batch`` (one template
plan for the scan) and writes each finished chunk atomically (a temporary
file in the same directory, then ``os.replace``) as ``chunk_XXXXX.npz``
beside a ``manifest.json`` that pins the grid's identity: the frequency
grid, the model count, the chunking, the labels, the whole validated config
and every model's physical arrays.  A re-run over the same ``out_dir``
checks the identity (a different grid, config or edited model is an error),
skips the chunks whose files load and cover the right models, and computes
the rest: a scan stopped at chunk k resumes at chunk k and ends equal, bit
for bit, to an uninterrupted scan, since each chunk is an independent
computation: with molecules too, since each chunk's members carry their own
K(T) and U(T) rows (``collect_batch_inputs``), whichever model the scan's
template plan was built from.

The JAX scan pads its last chunk to ``batch_size`` models so that every
chunk runs one compiled program; the port compiles nothing per shape and
runs the last chunk as it is.  With ``mesh=`` each chunk goes through
``run_batch(mesh=)``; over several processes (``parallel.distributed``) the
chunk is gathered on every process, process 0 decides which chunks to skip
and is the only one that writes.

``GridInterpolator`` interpolates a finished library multilinearly in
torch, on the card unless the caller asks for the CPU, so autograd gives
its gradient in the parameters.
"""

from __future__ import annotations

import copy
import hashlib
import itertools
import json
import os
import tempfile
import zipfile
from pathlib import Path

import numpy as np
import torch

from .parallel.batch import collect_batch_inputs, make_batch, run_batch
from .parallel.sharding import Mesh, process_count, process_rank
from .pipeline import resolve_device

_MANIFEST = "manifest.json"
#: what np.load raises on a truncated or corrupted chunk file
_UNREADABLE = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


def _chunk_name(i: int) -> str:
    return f"chunk_{i:05d}.npz"


def _grid_identity(tracing_nus_hz, batch_size, labels, store_depths, config,
                   stellar_models):
    """Fingerprint of everything that defines the chunks' contents; the
    config's model path is left out (the models' arrays are hashed), so
    the same atmospheres at another path keep their checkpoints."""
    h = hashlib.md5()
    h.update(np.ascontiguousarray(np.asarray(tracing_nus_hz, np.float64)).tobytes())
    h.update(str((len(stellar_models), int(batch_size), bool(store_depths))).encode())
    if labels is not None:
        h.update(json.dumps(labels, sort_keys=True, default=float).encode())
    cfg_dict = copy.deepcopy(config.to_dict() if hasattr(config, "to_dict") else config)
    if isinstance(cfg_dict, dict):
        cfg_dict.get("input_model", {}).pop("fname", None)
    h.update(json.dumps(cfg_dict, sort_keys=True, default=str).encode())
    for m in stellar_models:
        for arr in (m.temperatures, m.geometry.r, m.composition.elemental_number_density):
            h.update(np.ascontiguousarray(np.asarray(arr, np.float64)).tobytes())
    return h.hexdigest()


def _atomic_savez(path: Path, **arrays):
    fd, tmp = tempfile.mkstemp(prefix=path.name + ".", suffix=".tmp", dir=str(path.parent))
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _chunk_ok(path: Path, idx_expected) -> bool:
    """A checkpoint counts only if it loads and covers the expected model
    indices; anything else is recomputed."""
    if not path.exists():
        return False
    try:
        with np.load(path) as z:
            return bool(np.array_equal(z["idx"], idx_expected)) and "spectrum" in z.files
    except _UNREADABLE:
        return False


def synthesize_grid(config, atom_data, stellar_models, tracing_nus_hz, out_dir,
                    batch_size: int | None = None, mesh=None, device="cuda",
                    dtype=torch.float32, labels: list | None = None,
                    store_depths: bool = False, max_chunks: int | None = None,
                    resume: bool = True):
    """Synthesize a grid of atmospheres with per-chunk checkpoints.

    config, atom_data : the parsed config and atom data every member shares
    stellar_models : StellarModels with equal depth counts and geometry
    tracing_nus_hz : [N] frequency grid (Hz; any order, stored descending)
    out_dir : checkpoint directory, created if missing; each chunk is
        ``chunk_XXXXX.npz`` with ``idx`` (model indices) and ``spectrum``
        ([b, N] emergent F_nu, or [b, D, N] with ``store_depths``)
    batch_size : models per chunk; default the mesh's 'batch' axis, else
        ``min(8, len(models))``; with a 'batch' axis a multiple of it
    device, dtype : the card in float32 unless the caller asks otherwise
    labels : optional JSON-serialisable per-model labels, kept in the
        manifest and returned by ``load_grid``
    max_chunks : stop after this many newly computed chunks (the scan stays
        resumable)
    resume : reuse valid chunk files; False recomputes and overwrites them
    mesh : a ``parallel.sharding.Mesh`` passed to ``run_batch``

    Returns a dict with ``computed`` / ``skipped`` / ``total`` chunk
    counts, ``out_dir`` and ``done`` (every chunk finished).
    """
    device = resolve_device(device, "synthesize_grid")
    from .util.compile_cache import enable_compilation_cache

    enable_compilation_cache()  # no-op unless STARDIS_COMPILE_CACHE is set
    lead = process_rank() == 0
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.sharding.Mesh, not {type(mesh).__name__}")
    n_mesh_batch = mesh.shape.get("batch") if mesh is not None else None
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n_models = len(stellar_models)
    if n_models == 0:
        raise ValueError("empty model list")
    if labels is not None and len(labels) != n_models:
        raise ValueError("labels must match stellar_models")
    if batch_size is None:
        batch_size = n_mesh_batch or min(8, n_models)
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if n_mesh_batch and batch_size % n_mesh_batch:
        raise ValueError(f"batch_size {batch_size} must be a multiple of the mesh batch "
                         f"axis ({n_mesh_batch})")

    nus = np.sort(np.asarray(tracing_nus_hz, dtype=np.float64))[::-1].copy()
    n_chunks = -(-n_models // batch_size)
    identity = _grid_identity(nus, batch_size, labels, store_depths, config, stellar_models)

    manifest_path = out_dir / _MANIFEST
    if manifest_path.exists():
        if json.loads(manifest_path.read_text()).get("identity") != identity:
            raise ValueError(
                f"{out_dir} holds checkpoints for a DIFFERENT grid (frequency grid / "
                "model count / chunking / labels / config / models mismatch); use a "
                "fresh out_dir or delete the old scan"
            )
    elif lead:
        manifest = {
            "identity": identity,
            "n_models": n_models,
            "batch_size": batch_size,
            "n_chunks": n_chunks,
            "n_nu": int(len(nus)),
            "n_depth": int(len(stellar_models[0].temperatures)),
            "store_depths": store_depths,
            "labels": labels,
        }
        tmp = manifest_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(manifest, indent=1, default=float))
        os.replace(tmp, manifest_path)
    nus_path = out_dir / "tracing_nus.npz"
    if lead and not nus_path.exists():
        _atomic_savez(nus_path, tracing_nus=nus)

    def members_of(ci):
        return np.arange(ci * batch_size, min((ci + 1) * batch_size, n_models))

    # which chunks are finished: process 0's reading, so that every process
    # computes (and gathers) the same chunks
    ok = [resume and _chunk_ok(out_dir / _chunk_name(ci), members_of(ci)) if lead else None
          for ci in range(n_chunks)]
    if process_count() > 1:
        torch.distributed.broadcast_object_list(ok, src=0)
    plan = None
    computed = skipped = 0
    finished = set()
    for ci in range(n_chunks):
        idx = members_of(ci)
        if ok[ci]:
            skipped += 1
            finished.add(ci)
            continue
        if max_chunks is not None and computed >= max_chunks:
            break
        members = [stellar_models[i] for i in idx]
        if plan is None:
            plan, batch = make_batch(config, atom_data, members, nus)
        else:
            batch = collect_batch_inputs(config, members, plan)
        f_nu = run_batch(plan, batch, mesh=mesh, device=device,
                         dtype=dtype).cpu().numpy()  # [b, D, N]
        if lead:
            _atomic_savez(out_dir / _chunk_name(ci), idx=idx,
                          spectrum=f_nu if store_depths else f_nu[:, -1, :])
        computed += 1
        finished.add(ci)
    done = all(ci in finished or _chunk_ok(out_dir / _chunk_name(ci), members_of(ci))
               for ci in range(n_chunks))
    return {"out_dir": str(out_dir), "total": n_chunks, "computed": computed,
            "skipped": skipped, "done": done}


class GridInterpolator:
    """Multilinear interpolation over a spectral library, in torch.

    points : [M, P] parameter values of the members; they must form a full
        tensor grid (each combination of the axes' unique values once)
    spectra : [M, ...] per-member spectra
    log_flux : interpolate log(spectra) and exponentiate (strictly
        positive spectra only): fluxes vary near-exponentially in Teff, so
        this removes most of the linear mode's mid-cell error

    device, dtype : where the library and its axes live and the precision
        of the arithmetic: the card in float32 unless the caller asks
        otherwise; a CUDA device without a GPU raises

    Calling it with one value per axis (numbers or tensors; tensors that
    require grad get their gradient through autograd) returns the
    interpolated spectrum as a tensor of that device and dtype.  Queries
    outside the hull are clamped to its boundary.  Accuracy guidance is in
    the JAX package's ``stardis_tpu/grid.py``: the arithmetic here is the
    same.
    """

    def __init__(self, points, spectra, log_flux: bool = False, device="cuda",
                 dtype=torch.float32):
        self.device = resolve_device(device, "GridInterpolator")
        self.dtype = dtype
        points = np.asarray(points, dtype=np.float64)
        spectra = np.asarray(spectra)
        self.log_flux = bool(log_flux)
        if self.log_flux:
            if not (spectra > 0).all():
                raise ValueError("log_flux=True needs strictly positive spectra")
            spectra = np.log(spectra)
        if points.ndim == 1:
            points = points[:, None]
        m, p = points.shape
        if spectra.shape[0] != m:
            raise ValueError("points and spectra disagree on member count")
        self.axes = [np.unique(points[:, a]) for a in range(p)]
        shape = tuple(len(ax) for ax in self.axes)
        if int(np.prod(shape)) != m:
            raise ValueError(
                f"{m} members do not form a tensor grid over axis sizes {shape} - "
                "every parameter combination must appear exactly once"
            )
        grid = np.empty(shape + spectra.shape[1:], dtype=spectra.dtype)
        filled = np.zeros(shape, dtype=bool)
        for k in range(m):
            idx = tuple(int(np.searchsorted(self.axes[a], points[k, a])) for a in range(p))
            if filled[idx]:
                raise ValueError(f"duplicate grid point {tuple(points[k])}")
            filled[idx] = True
            grid[idx] = spectra[k]
        if not filled.all():
            raise ValueError("missing tensor-grid combinations")
        self.grid = torch.as_tensor(grid, dtype=torch.float64).to(self.device, dtype)
        self._axes_t = [torch.as_tensor(ax).to(self.device, dtype) for ax in self.axes]

    def __call__(self, *params):
        """Interpolated spectrum at one value per axis."""
        if len(params) != len(self.axes):
            raise ValueError(f"expected {len(self.axes)} parameters, got {len(params)}")
        cells = []
        for x, ax in zip(params, self._axes_t):
            x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
            if len(ax) == 1:
                cells.append((torch.tensor(0, device=self.device), x * 0.0))
                continue
            i = torch.clamp(torch.searchsorted(ax, x.detach()) - 1, 0, len(ax) - 2)
            t = (x - ax[i]) / (ax[i + 1] - ax[i])
            # minimum/maximum rather than clamp: on a node (t = 0 or 1) they
            # split the derivative in half, as jnp.clip does
            cells.append((i, torch.minimum(torch.maximum(t, t.new_zeros(())), t.new_ones(()))))
        out = 0.0
        for corner in itertools.product((0, 1), repeat=len(cells)):
            w = 1.0
            idx = []
            for (i, t), c in zip(cells, corner):
                w = w * (t if c else 1.0 - t)
                idx.append(i + c)
            out = out + w * self.grid[tuple(idx)]
        return torch.exp(out) if self.log_flux else out

    @classmethod
    def from_scan(cls, out_dir, keys, log_flux: bool = False, device="cuda",
                  dtype=torch.float32):
        """From a finished ``synthesize_grid`` directory whose labels carry
        numeric parameters, e.g. keys=("teff", "logg")."""
        spectra, _nus, labels = load_grid(out_dir)
        if labels is None:
            raise ValueError("the scan has no labels to interpolate over")
        if np.isnan(spectra).any():
            raise ValueError("the scan is incomplete (NaN members present)")
        points = np.asarray([[float(lab[k]) for k in keys] for lab in labels])
        return cls(points, spectra, log_flux=log_flux, device=device, dtype=dtype)


def load_grid(out_dir):
    """Assemble a finished (or partial) scan: (spectra, tracing_nus,
    labels); spectra is [M, N] emergent F_nu (or [M, D, N] for
    ``store_depths`` scans) with NaN rows for chunks not computed yet."""
    out_dir = Path(out_dir)
    manifest = json.loads((out_dir / _MANIFEST).read_text())
    with np.load(out_dir / "tracing_nus.npz") as z:
        nus = z["tracing_nus"]
    n_models = manifest["n_models"]
    spectra = None
    for ci in range(manifest["n_chunks"]):
        path = out_dir / _chunk_name(ci)
        if not path.exists():
            continue
        try:
            with np.load(path) as z:
                idx, spec = z["idx"], z["spectrum"]
        except _UNREADABLE:
            continue
        if spectra is None:
            spectra = np.full((n_models,) + spec.shape[1:], np.nan, dtype=spec.dtype)
        spectra[idx] = spec
    if spectra is None:
        shape = (n_models, manifest["n_nu"])
        if manifest.get("store_depths"):
            shape = (n_models, manifest["n_depth"], manifest["n_nu"])
        spectra = np.full(shape, np.nan)
    return spectra, nus, manifest.get("labels")
