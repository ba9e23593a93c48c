"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (sm_90a) into a
shared library with a plain C interface, at first use, into ``BUILD_DIR``
(``_build/`` unless ``util.compile_cache.enable_compilation_cache`` points
it elsewhere; keyed by a hash of the source and flags), and loaded with
ctypes.  The C
entry points launch on the stream they are given and return
``cudaGetLastError()``; ``check`` turns a non-zero status into an exception.
Nothing here runs at import time, so the package imports on machines
without a GPU or a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent / "_build"
#: where kernels are built and loaded from (``util.compile_cache``)
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: flags of one kernel on top of NVCC_FLAGS.  The formal solution and its
#: backward are built without FMA contraction, so that each of their
#: products rounds as in the plain version: the weights w1 = w0 - tau e and
#: w2 = 2 w1 - tau^2 e cancel, and the reference's gap-0 wrap divides by
#: the surface tau, so a fused product there moves I_nu far beyond one
#: rounding; the backward recomputes both sweeps and must round them as
#: the forward did.  Kernel 2b's checkpoint span (the steps between two
#: intensities a recomputed sweep keeps, radiation_field.solver's
#: TRACE_GRAD_SPAN) is compiled in as SPAN.
TRACE_GRAD_SPAN = 8
KERNEL_FLAGS = {"formal_solution": ("-fmad=false",),
                "formal_solution_grad": ("-fmad=false", f"-DSPAN={TRACE_GRAD_SPAN}")}
#: every kernel of csrc/, in the order chip_smoke.py builds them
KERNELS = ("line_opacity", "formal_solution", "line_opacity_grad", "formal_solution_grad")

_LIBS: dict = {}
#: one build of each kernel in a process: the host threads of a mesh over
#: several cards reach a kernel's first launch together (different kernels
#: build in parallel)
_LOAD_LOCKS: dict = {}
#: compiler report (ptxas registers / spills) of each kernel built by this
#: process, by kernel name
BUILD_LOGS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiling it if needed."""
    if name in _LIBS:
        return _LIBS[name]
    with _LOAD_LOCKS.setdefault(name, threading.Lock()):
        if name not in _LIBS:
            _LIBS[name] = _build_and_load(name)
    return _LIBS[name]


def _build_and_load(name: str) -> ctypes.CDLL:
    src = CSRC / f"{name}.cu"
    flags = (*NVCC_FLAGS, *KERNEL_FLAGS.get(name, ()))
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    build_dir = BUILD_DIR  # read once, under the kernel's load lock
    lib_path = build_dir / f"lib{name}_{digest}.so"
    if not lib_path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src.name}:\n{res.stdout}\n{res.stderr}"
            )
        BUILD_LOGS[name] = res.stderr.strip()
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
    return lib


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel ``name``, typed."""
    fn = getattr(load(name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


def check(name: str, status: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        msg = getattr(load(name), f"{name}_error_string")(status)
        raise RuntimeError(f"{name} kernel failed: CUDA error {status} ({msg.decode()})")


def ptr(tensor) -> ctypes.c_void_p:
    # The kernels run asynchronously on PyTorch's current stream; a tensor
    # freed after the launch returns its memory to the caching allocator,
    # which hands it out only to work ordered after the kernel on that
    # stream, so the wrappers need not keep their temporaries alive.
    return ctypes.c_void_p(tensor.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


_COUNT_LOCK = threading.Lock()


def count(wrapper, counter: str) -> None:
    """Add one to a wrapper's launch counter (``wrapper.<counter>``); the
    host threads of a mesh over several cards launch at the same time."""
    with _COUNT_LOCK:
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def launch(fn, device, *args) -> int:
    """Call the C entry point ``fn`` with ``args`` and the current stream of
    ``device`` (its last argument), with ``device`` the calling thread's
    current CUDA device for the call: an entry point launches, opts in to
    more than 48 KB of shared memory (``cudaFuncSetAttribute``) and reads
    ``cudaGetLastError`` on the current device, which must be its tensors'
    own whatever device the caller has made current."""
    import torch

    with torch.cuda.device(device):
        return fn(*args, stream_ptr(device))
