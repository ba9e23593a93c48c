"""Tracing and profiling utilities (the port of
``stardis_tpu/util/profiling.py``): per-stage wall timers with a
grid-throughput line, a ``torch.profiler`` trace context that writes
TensorBoard-readable traces, the program's spans at its layer boundaries,
and one view of its counters.

Spans.  ``span(name)`` marks one layer boundary: a served request and its
stages, a batch's inputs and its run, the host plan.  Tracing is on
exactly while a ``torch.profiler`` records (``device_trace`` starts one);
there is no other switch.  Off, a span is one flag read, one flag set (the
buffer's session has ended) and a shared null context: no allocation, no
``record_function``, no synchronisation.  On,
it enters ``record_function("stardis.<name>")``, so its start and end are
events of the same profiler as the card's kernels and copies, and it is
kept in memory as a ``Span`` (``spans()``): name, start and end on the
host's monotonic clock, the enclosing span, and the request, the id of
its root span (one served request, one batch's inputs, one batch run).
The buffer holds one profiler session: the first span recorded after one
that found no profiler empties it.  It keeps ``SPAN_LIMIT`` spans and
counts the rest as dropped.  Tracing never synchronises: a span over
asynchronous work measures the host's enqueue, and a span measures the
host blocked on the card only where the program itself waits: "validate"
and "readback", and any copy from pageable host memory to the card, which
waits for the work queued before it.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import tempfile
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as autograd_profiler

logger = logging.getLogger(__name__)

#: spans kept per profiler session; later ones are counted as dropped
SPAN_LIMIT = 200_000
#: prefix of the spans' names among the profiler's events
PREFIX = "stardis."


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns() at entry
    end_ns: int  # ... at exit
    parent: int | None  # id of the enclosing span of the same thread; None for a root
    request: int  # id of the root span
    id: int


class _Trace:
    """The spans of the current profiler session, shared by every thread
    (each thread nests its own spans)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans = []
        self.dropped = 0
        self.stale = False  # a span found no profiler since the last one kept
        self.ids = itertools.count()
        self.local = threading.local()

    def _empty(self):
        self.spans, self.dropped, self.stale = [], 0, False

    def clear(self):
        with self.lock:
            self._empty()

    def begin(self):
        """A new span's id; the first span after one that found no
        profiler empties the buffer."""
        with self.lock:
            if self.stale:
                self._empty()
            return next(self.ids)

    def keep(self, span):
        with self.lock:
            if len(self.spans) < SPAN_LIMIT:
                self.spans.append(span)
            else:
                self.dropped += 1

    def open_spans(self):
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_TRACE = _Trace()
_OFF = contextlib.nullcontext()


def span(name):
    """Context manager marking the layer boundary ``name`` (see the module
    docstring); a shared no-op unless a torch profiler records."""
    if not autograd_profiler._is_profiler_enabled:
        _TRACE.stale = True
        return _OFF
    return _OpenSpan(name)


class _OpenSpan:
    __slots__ = ("name", "id", "parent", "request", "start", "record")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.id = _TRACE.begin()
        stack = _TRACE.open_spans()
        outer = stack[-1] if stack else None
        self.parent = None if outer is None else outer.id
        self.request = self.id if outer is None else outer.request
        stack.append(self)
        self.record = autograd_profiler.record_function(PREFIX + self.name)
        self.record.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.record.__exit__(*exc)
        _TRACE.open_spans().pop()
        _TRACE.keep(Span(self.name, self.start, end, self.parent, self.request, self.id))
        return False


def spans():
    """The spans of the current (or last) profiler session, in the order
    they ended."""
    with _TRACE.lock:
        return list(_TRACE.spans)


def counters():
    """The program's counters, read where they are kept: stage-1 graph
    captures and replays (``pipeline.CapturedStage1``), the differentiated
    stage 1's captures, forward replays and backwards run again eagerly
    because a later forward had replayed (``pipeline.CapturedStage1Grad``),
    kernels built by ``nvcc`` in this process (``_cuda.BUILD_LOGS``), the
    kernel wrappers' launch counters, the continuum's file-opacity terms
    (``pipeline.FileSigmaCounts``: tables expanded on the device from
    rows, dense sigma arrays copied to it), and the spans dropped this
    session.  After warm-up a capture or a build is work done again."""
    from .. import _cuda
    from ..opacities import line_kernel
    from ..pipeline import CapturedStage1, CapturedStage1Grad, FileSigmaCounts
    from ..radiation_field import solver

    k1 = line_kernel.accumulate_line_opacity_cuda
    k1b = line_kernel.accumulate_line_opacity_grad_cuda
    k2, k2b = solver.raytrace_cuda, solver.raytrace_grad_cuda
    return {
        "stage1_captures": CapturedStage1.captures,
        "stage1_replays": CapturedStage1.replays,
        "stage1_grad_captures": CapturedStage1Grad.captures,
        "stage1_grad_replays": CapturedStage1Grad.replays,
        "stage1_grad_stale_backwards": CapturedStage1Grad.stale_backwards,
        "kernel_builds": len(_cuda.BUILD_LOGS),
        "line_opacity_launches": k1.launches,
        "line_opacity_range_launches": k1.range_launches,
        "line_opacity_grad_launches": k1b.launches,
        "formal_solution_launches": k2.launches,
        "formal_solution_inward_launches": k2.inward_launches,
        "formal_solution_grad_launches": k2b.launches,
        "formal_solution_grad_inward_launches": k2b.inward_launches,
        "file_sigma_rows": FileSigmaCounts.rows,
        "file_sigma_uploads": FileSigmaCounts.uploads,
        "spans_dropped": _TRACE.dropped,
    }


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
    clock stops, so that the stage's time holds its device work.  Each
    stage is also a ``span``.
    """

    def __init__(self, grid_cells=None):
        self.grid_cells = grid_cells
        self.stages = {}

    @contextlib.contextmanager
    def stage(self, name, block_on=None):
        with span(name):
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
    host otherwise.  The program's spans are recorded while it runs
    (``spans()`` holds this trace's).  Yields the directory."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = str(log_dir or os.path.join(tempfile.gettempdir(), "stardis_tpu_torch_trace"))
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _TRACE.clear()  # this trace's spans only
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    logger.info("device trace written to %s", log_dir)
