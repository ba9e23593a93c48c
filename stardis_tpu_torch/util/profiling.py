"""Tracing and profiling utilities (the port of
``stardis_tpu/util/profiling.py``): per-stage wall timers with a
grid-throughput line, and a ``torch.profiler`` trace context that writes
TensorBoard-readable traces.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time

import torch

logger = logging.getLogger(__name__)


def _synchronize(tree):
    """Wait for the devices of every tensor in ``tree`` (nested lists,
    tuples and dicts) to finish their work, as ``jax.block_until_ready``
    does; CPU tensors are ready when they exist."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for value in tree.values():
            _synchronize(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            _synchronize(value)


class StageTimer:
    """Wall-clock per-stage timing with grid-throughput accounting.

    Usage:
        timer = StageTimer(grid_cells=n_lambda * n_depth)
        with timer.stage("plasma", block_on=tensors):
            ...
        timer.report()

    ``block_on``: tensors whose devices are synchronised before the stage's
    clock stops, so that the stage's time holds its device work.
    """

    def __init__(self, grid_cells=None):
        self.grid_cells = grid_cells
        self.stages = {}

    @contextlib.contextmanager
    def stage(self, name, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.stages[name] = self.stages.get(name, 0.0) + (time.perf_counter() - t0)

    @property
    def total(self):
        return sum(self.stages.values())

    def report(self, log=True):
        """{stage: s, ..., "total": s}; logged at INFO with the throughput
        in (lambda x depth) cells per second when ``log``."""
        lines = [f"{name}: {wall:.3f}s" for name, wall in self.stages.items()]
        if self.grid_cells and self.total > 0:
            lines.append(f"throughput: {self.grid_cells / self.total:,.0f} "
                         "(lambda x depth) cells/s")
        if log:
            logger.info("stage timings: %s", " | ".join(lines))
        return dict(self.stages, total=self.total)


@contextlib.contextmanager
def device_trace(log_dir=None):
    """``torch.profiler`` trace of the block, written to ``log_dir``
    (default ``<tempdir>/stardis_tpu_torch_trace``) as a Chrome trace that
    TensorBoard's profiler plugin reads.  The card's kernels, copies and
    memsets are traced when CUDA is available; the profiler sees only the
    host otherwise.  Yields the directory."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = str(log_dir or os.path.join(tempfile.gettempdir(), "stardis_tpu_torch_trace"))
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    logger.info("device trace written to %s", log_dir)
