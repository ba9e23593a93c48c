"""Runs over several processes: the port of
``stardis_tpu/parallel/distributed.py`` on ``torch.distributed``.

One process per card (or several CPU processes) joins one process group
(``initialize``); a mesh over every process's devices
(``make_global_mesh``, ``make_batch_nu_mesh``) records which process holds
each entry.  The sharded paths (``parallel.sharding.shard_spectrum``,
``parallel.batch.run_batch``) then compute on each process the shards of
its own entries and assemble the whole result on every process with one
``all_gather``: no collective before it.  A run of one process needs none
of this: ``initialize`` is a no-op, and the meshes of
``parallel.sharding`` hold that process's devices only.

    from stardis_tpu_torch.parallel import distributed
    distributed.initialize()                 # no-op for one process
    mesh = distributed.make_global_mesh()    # ('nu',) over every process's card
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..pipeline import resolve_device
from .sharding import Mesh, process_count, process_rank, visible_devices

logger = logging.getLogger(__name__)


def _local_card(rank):
    """This process's card: LOCAL_RANK (torchrun's), default the rank, modulo
    the visible cards."""
    return int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()


def initialize(init_method=None, world_size=None, rank=None, device="cuda"):
    """Join the process group of a run over several processes; returns
    whether one was joined.  A single process (``world_size`` not given
    and WORLD_SIZE unset or 1) is a no-op.

    init_method : where the processes meet, e.g. "tcp://localhost:29500" or
        "file:///shared/path"; default "env://" (MASTER_ADDR, MASTER_PORT)
    world_size, rank : default the WORLD_SIZE and RANK variables
    device : "cuda" (NCCL; this process's card, ``LOCAL_RANK`` modulo the
        visible cards, is made current) or "cpu" (gloo)
    """
    world = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else int(world_size)
    if world <= 1:
        logger.info("single-process run; torch.distributed not initialized")
        return False
    dist = torch.distributed
    if dist.is_initialized():
        return True
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    device = resolve_device(device, "initialize")
    if device.type == "cuda":
        torch.cuda.set_device(_local_card(rank))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method or "env://", world_size=world, rank=rank)
    logger.info("torch.distributed initialized: process %d of %d", rank, world)
    return True


def _global_devices(devices):
    """(every process's devices in rank order, the rank of each) from this
    process's ``devices``: by default every visible card in a run of one
    process, and this process's own card (``LOCAL_RANK``) in a run of
    several."""
    if devices is None:
        devices = (visible_devices() if process_count() == 1
                   else [torch.device("cuda", _local_card(process_rank()))])
    devices = [str(torch.device(d)) for d in devices]
    if process_count() == 1:
        return devices, [0] * len(devices)
    lists = [None] * process_count()
    torch.distributed.all_gather_object(lists, devices)
    return ([d for own in lists for d in own],
            [r for r, own in enumerate(lists) for _ in own])


def make_global_mesh(axis="nu", devices=None):
    """1-D mesh over every process's devices (``devices``: this process's,
    e.g. ["cpu", "cpu"]; default as ``_global_devices``)."""
    flat, ranks = _global_devices(devices)
    return Mesh(flat, (axis,), ranks)


def make_batch_nu_mesh(n_batch=None, devices=None):
    """2-D (batch x nu) mesh over every process's devices: batch rows across
    processes (models are independent, so that axis carries no traffic
    before the final gather), the wavelength grid across each row; n_batch
    defaults to the process count."""
    flat, ranks = _global_devices(devices)
    if n_batch is None:
        n_batch = process_count()
    if len(flat) % n_batch:
        raise ValueError(f"{len(flat)} devices not divisible into {n_batch} batch rows")
    return Mesh(np.asarray(flat, dtype=object).reshape(n_batch, -1), ("batch", "nu"),
                np.asarray(ranks).reshape(n_batch, -1))
