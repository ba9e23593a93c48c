"""Wavelength segments on one device, and the wavelength and batch axes
sharded over a mesh of devices.

``segmented_spectrum`` is the port of ``segmented_spectrum``
(``stardis_tpu/parallel/sharding.py:555``): grids larger than the card's
memory.  The grid runs as K contiguous pixel ranges, one after another,
each through ``pipeline.spectrum_batch`` on its range: the continuum on the
range's columns, Kernel 1's range launch (the counterpart of
``accumulate_pairs_blocked``, ``stardis_tpu/opacities/line_kernel.py:1316``)
and Kernel 2 on the range.  Every range reads the global grid, centres,
windows and reference frequency, so each pixel is computed exactly as in
the unsegmented run; only the bound-free ``torch.matmul`` may round
otherwise at another width.  Peak device memory is the plan's fixed arrays
plus one range's [D, n] grids (``util.memory``).

``shard_spectrum`` and ``shard_batch_spectrum`` are the ports of
``stardis_tpu/parallel/sharding.py:846`` and ``:380``.  A ``Mesh`` holds
torch devices on named axes; each shard of its ``'nu'`` axis is one pixel
range of ``segment_ranges(N, n)``, run as a segment is, and each row of its
``'batch'`` axis a contiguous chunk of the models.  The entries of a mesh
may repeat: the shards of one device run one after another on its stream.
That is how the CPU (``Mesh(["cpu"] * 4, ("nu",))``) and a machine with one
card (``make_nu_mesh(devices=["cuda:0"] * 4)``) run every line of the
sharded code, and a run on a mesh of repeated devices equals
``nu_segments=n`` bit for bit.  Distinct devices get one host thread each
(as ``torch.nn.parallel.parallel_apply`` does), so the host syncs of one
device (the line quantities' finiteness check, a copy to the host) do not
hold the others; ctypes releases the GIL during a kernel launch.  Across
processes (``parallel.distributed``) each process computes the shards of
the mesh entries it holds, and one ``all_gather`` assembles the whole result
on every process: the only collective.

What the JAX module does for XLA and the TPU is not carried: padding the
grid to equal shards, one compiled program for all of them, the per-shard
bucketing of (line, depth-block) pairs into tier programs
(``bucket_pairs_per_shard``, ``bucket_pair_programs_per_shard``,
``_halo_sels``, ``_stack_padded``) and the ``chunk`` size.  Kernel 1's range
launch reads each range's exact windows.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..pipeline import (
    _stage,
    device_constants,
    host_array,
    model_axis,
    model_sigmas,
    prepare_lines,
    spectrum_batch,
)


def segment_ranges(n_nu, n_segments):
    """[(a, b)]: K contiguous pixel ranges of ceil(N / K) pixels (the last
    may be shorter) covering [0, n_nu); fewer when K > n_nu."""
    k = int(n_segments)
    if k < 1:
        raise ValueError(f"n_segments must be >= 1, got {n_segments}")
    per = -(-int(n_nu) // k)
    return [(a, min(a + per, n_nu)) for a in range(0, n_nu, per)]


class _Walls:
    """Per-range device time: CUDA events on the card (the time between a
    range's first and last queued work), the host clock on the CPU."""

    def __init__(self, device):
        self._cuda = device.type == "cuda"
        self._marks = []
        self.mark()

    def mark(self):
        if self._cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self._marks.append(event)
        else:
            self._marks.append(time.perf_counter())

    def seconds(self):
        if self._cuda:
            self._marks[-1].synchronize()
            return [a.elapsed_time(b) * 1e-3 for a, b in zip(self._marks, self._marks[1:])]
        return [b - a for a, b in zip(self._marks, self._marks[1:])]


def segmented_spectrum(plan, state, line_quants, n_segments, consts, collect_opacities=False,
                       segment_walls=None, ray_distances=None, file_sigma_override=None,
                       plain=False, timings=None):
    """One model's spectrum in ``n_segments`` serial pixel ranges.

    state, line_quants : stage 1 of this model
    consts : the plan's DeviceConstants (``pipeline.device_constants``)
    collect_opacities : copy each range's per-source opacity grids, and
        their total, to host NumPy arrays [D, N] (one device-to-host copy
        per range), under the keys of ``pipeline.stage_spectrum``; the
        per-line ``_gammas`` / ``_doppler_widths`` diagnostics are attached
        once, as host arrays [L, D]
    segment_walls : optional list that receives each range's device time
        in seconds (CUDA events; host times on the CPU)
    ray_distances : [G, T] host array replacing the plan's (a served
        request's geometry)
    file_sigma_override : per plan.file_sources entry, FileSigmaRows [D] or
        a [D, N] host array replacing the plan's sigmas (a served request's
        temperatures)
    plain, timings : as ``pipeline.spectrum_batch``

    In the accuracy window mode the per-depth epsilon comes from a
    continuum-only pass over the ranges (``pipeline.accuracy_epsilon``),
    not from a continuum of the whole grid.

    F_nu, and I_nus when the plan tracks them, are written into one
    preallocated device tensor each; without ``collect_opacities`` they
    carry gradients to stage 1's tensors (each range's Kernels 1b and 2b
    sum over that range only).  With it, a stage-1 tensor that requires
    grad raises: the host copies carry none.  Under autograd the ranges do
    not bound device memory: each range's saved tensors (its opacities and
    source) live until the backward; ``util.memory`` and
    ``nu_segments="auto"`` model forward-only runs.
    Returns F_nu [D, N]; (F_nu, I_nus)
    when the plan tracks I_nu; (F_nu, I_nus or None, opacities, total)
    with ``collect_opacities``.
    """
    t = state.t
    device = t.device
    n_nu = len(plan.tracing_nus)
    n_depth = len(plan.temperatures)
    ranges = segment_ranges(n_nu, n_segments)
    rays = None if ray_distances is None else np.asarray(ray_distances)[None]
    sigmas = model_sigmas(file_sigma_override)
    track = plan.track_individual_intensities

    with _stage(timings, "line_opacity", device):
        lines = prepare_lines(plan, [state], [line_quants], consts, sigmas, plain, ranges)

    f_nu = torch.empty((n_depth, n_nu), dtype=t.dtype, device=device)
    i_nus = (torch.empty((n_depth, n_nu, len(plan.weights)), dtype=t.dtype, device=device)
             if track else None)
    opacities, total = {}, None
    walls = _Walls(device)
    for a, b in ranges:
        f_s, total_s, opac_s, i_s = spectrum_batch(
            plan, [state], lines, consts, ray_distances=rays,
            photospheric_correction=plan.photospheric_correction, file_sigmas=sigmas,
            plain=plain, timings=timings, pixels=(a, b),
        )
        f_nu[:, a:b] = f_s[0]
        if track:
            i_nus[:, a:b] = i_s[0]
        del f_s, i_s
        walls.mark()
        if collect_opacities:
            keys = [k for k in opac_s if "gammas" not in k and "doppler" not in k]
            host = host_array(torch.stack([opac_s[k][0] for k in keys] + [total_s[0]]),
                              "segmented_spectrum(collect_opacities=True)")
            if total is None:
                opacities = {k: np.empty((n_depth, n_nu), dtype=host.dtype) for k in keys}
                total = np.empty((n_depth, n_nu), dtype=host.dtype)
            for i, k in enumerate(keys):
                opacities[k][:, a:b] = host[i]
            total[:, a:b] = host[-1]
        del opac_s, total_s
    if segment_walls is not None:
        segment_walls.extend(walls.seconds())

    if collect_opacities:
        for label, _prepared, gamma, doppler in lines:
            what = "segmented_spectrum(collect_opacities=True)"
            opacities[label + "_gammas"] = host_array(gamma[0], what)
            opacities[label + "_doppler_widths"] = host_array(doppler[0], what)
        return f_nu, i_nus, opacities, total
    if track:
        return f_nu, i_nus
    return f_nu


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------

def process_rank():
    """This process's rank in the ``torch.distributed`` group, 0 without
    one."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count():
    """The processes of the ``torch.distributed`` group, 1 without one."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _canonical(device):
    """``device`` as one torch.device per device: "cuda" is the current
    card, "cpu:0" the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu") if device.type == "cpu" else device


class Mesh:
    """Devices on named axes, as ``jax.sharding.Mesh`` has them.

    devices : array-like of devices (torch.device or strings), one axis per
        name; entries may repeat, and the shards of one device then run one
        after another on its stream
    axis_names : e.g. ("nu",) or ("batch", "nu")
    ranks : optional array of the devices' shape: the process
        (``torch.distributed`` rank) that holds each entry, for a mesh over
        several processes (``parallel.distributed``); None when this
        process holds every entry

    ``devices`` is an ndarray of torch.device and ``shape[name]`` the size
    of an axis."""

    def __init__(self, devices, axis_names, ranks=None):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [_canonical(d) for d in arr.ravel()]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim or self.devices.size == 0:
            raise ValueError(f"a mesh needs devices on {len(self.axis_names)} axes "
                             f"{self.axis_names}, got shape {self.devices.shape}")
        self.ranks = (None if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(self.devices.shape))

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def held(self, index):
        """Whether this process computes the entry at ``index``."""
        return self.ranks is None or int(self.ranks[index]) == process_rank()

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]})"


def visible_devices():
    """Every visible card, cuda:0 ... cuda:n-1; raises without one."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass devices=, e.g. ['cpu'] * 4 "
                           "on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def make_nu_mesh(n_devices=None, devices=None):
    """1-D ``'nu'`` mesh: ``devices`` (which may repeat one device), or the
    first ``n_devices`` visible cards (default all of them)."""
    if devices is None:
        devices = visible_devices()[: n_devices or None]
    return Mesh(list(devices), ("nu",))


def make_batch_nu_mesh(n_batch, n_nu, devices=None):
    """2-D mesh: the models split over ``'batch'``, the wavelength grid over
    ``'nu'``; ``devices`` default the first n_batch x n_nu visible cards."""
    if devices is None:
        devices = visible_devices()[: n_batch * n_nu]
    devices = list(devices)
    if len(devices) != n_batch * n_nu:
        raise ValueError(f"{len(devices)} devices do not make a {n_batch} x {n_nu} mesh")
    return Mesh(np.asarray(devices, dtype=object).reshape(n_batch, n_nu), ("batch", "nu"))


def as_batch_nu(mesh):
    """``mesh`` as a ('batch', 'nu') mesh: a 1-D 'nu' mesh is one batch row,
    a 1-D 'batch' mesh one column."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a stardis_tpu_torch.parallel.sharding.Mesh, "
                        f"not {type(mesh).__name__}")
    names = mesh.axis_names
    if names == ("batch", "nu"):
        return mesh
    if names in (("nu",), ("batch",)):
        shape = (1, -1) if names == ("nu",) else (-1, 1)
        ranks = None if mesh.ranks is None else mesh.ranks.reshape(shape)
        return Mesh(mesh.devices.reshape(shape), ("batch", "nu"), ranks)
    raise ValueError(f"mesh axes must be ('nu',), ('batch',) or ('batch', 'nu'), not {names}")


# ----------------------------------------------------------------------
# sharded spectra
# ----------------------------------------------------------------------

def _to_device(state, quants, device):
    """A stage-1 result (PlasmaState, line quantities) copied to ``device``
    (no copy where it already lies there)."""
    state = type(state)(*(t.to(device) for t in state))
    if quants:
        quants = {k: tuple(t.to(device) for t in triple) for k, triple in quants.items()}
    return state, quants


def _tiles(mesh, n_models, n_nu):
    """[(entry, (m0, m1), (a, b))] of a ('batch', 'nu') mesh in mesh order:
    batch row r holds the models ``segment_ranges(B, rows)[r]``, column c
    the pixels ``segment_ranges(N, columns)[c]`` (ceil-sized, the last ones
    shorter); entries beyond the ranges hold nothing."""
    n_rows, n_cols = mesh.devices.shape
    rows, cols = segment_ranges(n_models, n_rows), segment_ranges(n_nu, n_cols)
    return [((r, c), rows[r], cols[c]) for r in range(len(rows)) for c in range(len(cols))]


def _per_device(work):
    """Run ``work[device]()`` for every device, each on a host thread of its
    own with its device current (one device: on this thread), under this
    thread's grad mode; returns {device: result} and re-raises the first
    failure."""
    grad = torch.is_grad_enabled()

    def call(device, fn):
        with torch.set_grad_enabled(grad):
            if device.type == "cuda":
                with torch.cuda.device(device):
                    return fn()
            return fn()

    if len(work) == 1:
        (device, fn), = work.items()
        return {device: call(device, fn)}
    results, errors = {}, []

    def run(device, fn):
        try:
            results[device] = call(device, fn)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=item) for item in work.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _gather_tiles(outs, tiles, mesh):
    """Every process's tiles into ``outs`` ([B, D, N, ...] tensors, this
    process's tiles already written): one ``all_gather`` of a flat buffer per
    process (padded to the longest), unpacked tile by tile.  Copies only, so
    the bits are kept."""
    dist = torch.distributed
    world = process_count()
    dtype = outs[0].dtype
    comm = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))

    def views(tile):
        _, (m0, m1), (a, b) = tile
        return [out[m0:m1, :, a:b] for out in outs]

    owned = [[t for t in tiles if int(mesh.ranks[t[0]]) == r] for r in range(world)]
    lengths = [sum(v.numel() for t in own for v in views(t)) for own in owned]
    buf = torch.zeros(max(lengths), dtype=dtype, device=comm)
    pos = 0
    for tile in owned[process_rank()]:
        for v in views(tile):
            buf[pos:pos + v.numel()] = v.reshape(-1).to(comm)
            pos += v.numel()
    bufs = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(bufs, buf)
    for r, own in enumerate(owned):
        if r == process_rank():
            continue
        pos = 0
        for tile in own:
            for v in views(tile):
                v.copy_(bufs[r][pos:pos + v.numel()].reshape(v.shape))
                pos += v.numel()


def shard_tiles(plan, mesh, n_models, row_inputs, dtype, consts=None, ray_distances=None,
                photospheric_correction=None, file_sigmas=None, plain=False, timings=None,
                shard_walls=None):
    """The spectra of ``n_models`` models on a ('batch', 'nu') mesh, where
    the caller says how each batch row gets its stage 1 (copies of a stage
    1 already run: ``shard_batch_spectrum``; run on the row's devices:
    ``parallel.batch.run_batch``): (F_nu [B, D, N], I_nus [B, D, N, T] or
    None) on the first device of the mesh this process holds.

    row_inputs(m0, m1, consts, timings) : stage 1 of models [m0, m1) on
        the device of ``consts`` (the plan's DeviceConstants there), as
        (state, quants) with the model axis
    consts : DeviceConstants to reuse on their own device; other devices
        upload the plan's
    The other arguments as ``shard_batch_spectrum``."""
    n_nu = len(plan.tracing_nus)
    n_depth, n_theta = len(plan.temperatures), len(plan.weights)
    tiles = _tiles(mesh, n_models, n_nu)
    held = [t for t in tiles if mesh.held(t[0])]
    if not held:
        raise ValueError(f"this process (rank {process_rank()}) holds no shard of {mesh}")
    by_device = {}
    for tile in held:
        by_device.setdefault(mesh.devices[tile[0]], []).append(tile)
    out_device = mesh.devices[held[0][0]]
    track = plan.track_individual_intensities
    outs = [torch.empty((n_models, n_depth, n_nu), dtype=dtype, device=out_device)]
    if track:
        outs.append(torch.empty((n_models, n_depth, n_nu, n_theta), dtype=dtype,
                                device=out_device))
    cols = segment_ranges(n_nu, mesh.devices.shape[1])
    correction = photospheric_correction

    def work_of(device, dev_tiles):
        def work():
            if consts is not None and consts.tracing_nus.device == device:
                c = consts
            else:
                c = device_constants(plan, dtype, device)
            rows, walls, stage_t = {}, [], ({} if timings is not None else None)
            for _entry, (m0, m1), (a, b) in dev_tiles:
                sigmas = None if file_sigmas is None else [s[m0:m1] for s in file_sigmas]
                if (m0, m1) not in rows:
                    state, quants = row_inputs(m0, m1, c, stage_t)
                    with _stage(stage_t, "line_opacity", device):
                        # in the accuracy window mode the epsilon comes from
                        # the whole grid, in the mesh's pixel ranges
                        lines = prepare_lines(plan, state, quants, c, sigmas, plain, cols)
                    rows[(m0, m1)] = (state, lines)
                state, lines = rows[(m0, m1)]
                wall = _Walls(device)
                f, total, opac, i = spectrum_batch(
                    plan, state, lines, c,
                    ray_distances=None if ray_distances is None else ray_distances[m0:m1],
                    photospheric_correction=(correction[m0:m1] if np.ndim(correction)
                                             else correction),
                    file_sigmas=sigmas, plain=plain, timings=stage_t, pixels=(a, b))
                del total, opac
                wall.mark()
                outs[0][m0:m1, :, a:b] = f
                if track:
                    outs[1][m0:m1, :, a:b] = i
                walls.append(wall)
                del f, i
            return [w.seconds()[0] for w in walls], stage_t
        return work

    results = _per_device({d: work_of(d, t) for d, t in by_device.items()})
    if shard_walls is not None:
        seconds = {d: iter(res[0]) for d, res in results.items()}
        shard_walls.extend(next(seconds[mesh.devices[t[0]]]) for t in held)
    if timings is not None:
        for _walls, stage_t in results.values():
            for k, v in stage_t.items():
                timings[k] = timings.get(k, 0.0) + v
    if mesh.ranks is not None and process_count() > 1:
        _gather_tiles(outs, tiles, mesh)
    return outs[0], (outs[1] if track else None)


def shard_batch_spectrum(plan, states, quants, mesh, consts, ray_distances=None,
                         photospheric_correction=None, file_sigmas=None, plain=False,
                         timings=None, shard_walls=None):
    """The spectra of a batch of models on a ('batch', 'nu') mesh: each
    entry (batch row, nu column) computes a contiguous chunk of the models
    over one pixel range, as ``pipeline.spectrum_batch`` on that range.

    states, quants : stage 1 of the B models on the device of ``consts``,
        batched (``stage_plasma_and_lines`` of [B, D] temperatures) or one
        per model (``pipeline.model_axis``); each row's models are copied to
        the devices of its entries (copies keep the bits)
    consts : the plan's DeviceConstants there; the other devices upload
        the plan's own
    ray_distances : [B, G, T] host array (default the plan's for each model)
    photospheric_correction : [B] host array, a number, or None
    file_sigmas : per plan.file_sources entry, FileSigmaRows [B, D] or a
        [B, D, N] host array (each row takes its models' part)
    plain, timings : as ``spectrum_batch``
    shard_walls : optional list that receives each entry's device time in
        seconds (CUDA events; host times on the CPU), in mesh order
    The rows take ceil(B / rows) models each and the columns ceil(N /
    columns) pixels (the JAX package pads both to equal shards; the port
    runs the last ones shorter).  In the accuracy window mode each model's
    epsilon comes from the whole grid.
    Returns F_nu [B, D, N], or (F_nu, I_nus [B, D, N, T]) when the plan
    tracks I_nu, on the first device of the mesh this process holds.
    """
    mesh = as_batch_nu(mesh)
    state, quants = model_axis(states, quants)
    f_nu, i_nus = shard_tiles(
        plan, mesh, state.t.shape[0],
        lambda m0, m1, c, _timings: _to_device(
            type(state)(*(x[m0:m1] for x in state)),
            quants and {k: tuple(x[m0:m1] for x in triple) for k, triple in quants.items()},
            c.tracing_nus.device),
        consts.tracing_nus.dtype, consts, ray_distances, photospheric_correction,
        file_sigmas, plain, timings, shard_walls)
    return (f_nu, i_nus) if plan.track_individual_intensities else f_nu


def shard_spectrum(plan, state, line_quants, mesh, consts, ray_distances=None,
                   file_sigma_override=None, plain=False, timings=None, shard_walls=None):
    """One model's spectrum with the wavelength grid sharded over the
    mesh's ``'nu'`` axis: shard s is the pixel range
    ``segment_ranges(N, n)[s]`` (ceil(N / n) pixels, the JAX package's
    padded shard less its padding), run on its device as a segment is:
    the continuum, Kernel 1's range launch and Kernel 2 on the range.
    Stage 1 (``state``, ``line_quants``, on the device of ``consts``) ran
    once; its tensors are copied to each other device of the mesh.

    consts : the plan's DeviceConstants on the state's device
    ray_distances : [G, T] host array replacing the plan's (a served
        request's geometry)
    file_sigma_override : per plan.file_sources entry, FileSigmaRows [D] or
        a [D, N] host array replacing the plan's sigmas (split by range, not
        padded)
    plain, timings : as ``pipeline.spectrum_batch``
    shard_walls : optional list that receives each shard's device time in
        seconds (CUDA events; host times on the CPU), in mesh order
    In the accuracy window mode the epsilon comes from the whole grid, as
    in ``segmented_spectrum``.  Returns F_nu [D, N], or (F_nu, I_nus [D, N,
    T]) when the plan tracks I_nu, on the first device of the mesh this
    process holds.
    """
    if not isinstance(mesh, Mesh) or mesh.axis_names != ("nu",):
        raise ValueError(f"shard_spectrum needs a 1-D 'nu' mesh, got {mesh!r}")
    out = shard_batch_spectrum(
        plan, [state], [line_quants], mesh, consts,
        ray_distances=None if ray_distances is None else np.asarray(ray_distances)[None],
        photospheric_correction=plan.photospheric_correction,
        file_sigmas=model_sigmas(file_sigma_override),
        plain=plain, timings=timings, shard_walls=shard_walls)
    if plan.track_individual_intensities:
        return out[0][0], out[1][0]
    return out[0]


def shard_eval_stats(lines, n_nu, ndev):
    """The load of ``ndev`` wavelength shards: {"ndev", "per_shard_evals"
    [ndev], "unsharded_evals", "efficiency"}.

    lines : ``pipeline.prepare_lines``' result (every line set of a batch)
    An evaluation is an in-window (model, line, depth, pixel) quadruple of
    Kernel 1: the window -iw <= p - centre < iw cut to the grid and to the
    shard's range of ``segment_ranges(n_nu, ndev)``.  The exact windows
    partition every pair's pixels among the shards, so the per-shard counts
    add up to the unsharded one, and efficiency = unsharded / (ndev x the
    largest per-shard count) measures only the balance: 1.0 is an even
    load.  The JAX package's meter (``stardis_tpu/parallel/sharding.py:280``)
    counts the evaluations of its TPU tier programs (panel widths, dense
    local grids, the halo), so its numbers differ from these by design.
    """
    from ..opacities.line_kernel import pair_windows

    ranges = segment_ranges(n_nu, ndev)
    per_shard = [0] * ndev
    unsharded = 0
    for _label, q, _gamma, _doppler in lines:
        # iw is [B, D, L] in the kernel's layout, [B, L, D] in the plain one's
        iw = q.iw if q.iw_max is not None else q.iw.transpose(1, 2)
        lo, hi = pair_windows(q.centers, iw, n_nu, 0, n_nu)
        unsharded += int((hi - lo).clamp_min(0).sum())
        for s, (a, b) in enumerate(ranges):
            per_shard[s] += int((hi.clamp(max=b) - lo.clamp(min=a)).clamp_min(0).sum())
    peak = max(per_shard)
    return {"ndev": ndev, "per_shard_evals": per_shard, "unsharded_evals": unsharded,
            "efficiency": unsharded / (ndev * peak) if peak else 1.0}
