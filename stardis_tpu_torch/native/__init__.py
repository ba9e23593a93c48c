"""Native (C++) host-side components (the port of ``stardis_tpu/native``).

A VALD line-list text parser: multi-GB VALD exports parse ~100x faster
than with a Python loop.  ``vald_parser.cpp`` is built by g++ at first
use into ``BUILD_DIR`` (``stardis_tpu_torch/_build/`` unless
``util.compile_cache.enable_compilation_cache`` points it elsewhere; keyed
by a hash of the source and flags, as ``_cuda.load`` builds the CUDA
kernels) and loaded with ctypes; nothing builds at import.  A pure-Python
parser with the same semantics keeps the feature available where no
compiler is present.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..atom_data.base import Table
from ..util.species import SYMBOL_TO_Z

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "vald_parser.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

#: the parser that produced the last ``read_vald_linelist`` result:
#: "native" or "python"
LAST_PARSER = None

#: the columns of a parsed list, in order; a shortlist lacks SHORT_DROPPED
COLUMNS = ("atomic_number", "ion_charge", "wavelength", "log_gf", "e_low",
           "j_lo", "e_up", "j_up", "rad", "stark", "waals")
SHORT_DROPPED = ("j_lo", "e_up", "j_up")

_lib_handle = None


def _load_library():
    """The parser's shared library, compiled if needed."""
    global _lib_handle
    if _lib_handle is not None:
        return _lib_handle
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    build_dir = BUILD_DIR  # read once: enable_compilation_cache may move it
    lib_path = build_dir / f"libvald_parser_{digest}.so"
    if not lib_path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        res = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n{res.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.vald_count_lines.argtypes = [ctypes.c_char_p]
    lib.vald_count_lines.restype = ctypes.c_int
    dp = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    ip = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    lib.vald_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ip, ip,
        dp, dp, dp, dp, dp, dp, dp, dp, dp,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.vald_parse.restype = ctypes.c_int
    _lib_handle = lib
    return lib


def read_vald_linelist(path, use_native=True):
    """Parse a VALD3 text export (long or shortlist format) into the
    ``linelist_atoms`` Table the line pipeline reads: the columns of
    COLUMNS (atomic_number and ion_charge int64, the rest float64), without
    SHORT_DROPPED for a shortlist.

    Returns (Table, is_shortlist); ``LAST_PARSER`` says which parser ran.
    """
    global LAST_PARSER
    path = str(path)
    if use_native:
        try:
            out = _read_native(path)
            LAST_PARSER = "native"
            return out
        except Exception as exc:  # noqa: BLE001 - compiler missing, unreadable, ...
            logger.warning(
                "native VALD parser unavailable (%s); using Python fallback", exc
            )
    out = _read_python(path)
    LAST_PARSER = "python"
    return out


def _table(columns, is_short):
    if is_short:
        columns = {k: v for k, v in columns.items() if k not in SHORT_DROPPED}
    return Table(columns), is_short


def _read_native(path):
    lib = _load_library()
    cap = lib.vald_count_lines(path.encode())
    if cap < 0:
        raise IOError(f"cannot read {path}")
    cap = max(cap, 1)
    z = np.empty(cap, np.int32)
    q = np.empty(cap, np.int32)
    cols = [np.empty(cap, np.float64) for _ in range(9)]
    short_flag = ctypes.c_int(0)
    n = lib.vald_parse(path.encode(), cap, z, q, *cols, ctypes.byref(short_flag))
    if n < 0:
        raise IOError(f"cannot read {path}")
    columns = {"atomic_number": z[:n].astype(np.int64),
               "ion_charge": q[:n].astype(np.int64)}
    columns.update((name, c[:n].copy()) for name, c in zip(COLUMNS[2:], cols))
    return _table(columns, bool(short_flag.value))


def _read_python(path):
    """Pure-Python parser with the same semantics as the C++ one."""
    rows = []
    shortlist_votes = longlist_votes = 0
    spec_re = re.compile(r"^\s*'([A-Z][a-z]?)\s+(\d+)'")
    with open(path) as fh:
        for line in fh:
            m = spec_re.match(line)
            if not m:
                continue
            sym, ion = m.group(1), int(m.group(2))
            if sym not in SYMBOL_TO_Z or not (1 <= ion <= 30):
                continue
            vals = []
            for tok in line[m.end():].split(","):
                tok = tok.strip()
                if not tok:
                    continue
                try:
                    vals.append(float(tok))
                except ValueError:
                    break
            if len(vals) < 4:
                continue
            z, q = SYMBOL_TO_Z[sym], ion - 1
            if len(vals) >= 9:
                rows.append((z, q, vals[0], vals[1], vals[2], vals[3], vals[4],
                             vals[5], vals[-3], vals[-2], vals[-1]))
                longlist_votes += 1
            else:
                rows.append((z, q, vals[0], vals[2], vals[1], -1.0, -1.0, -1.0,
                             vals[3] if len(vals) > 3 else 0.0,
                             vals[4] if len(vals) > 4 else 0.0,
                             vals[5] if len(vals) > 5 else 0.0))
                shortlist_votes += 1
    data = list(zip(*rows)) if rows else [()] * len(COLUMNS)
    columns = {name: np.array(col, dtype=np.int64 if i < 2 else np.float64)
               for i, (name, col) in enumerate(zip(COLUMNS, data))}
    return _table(columns, shortlist_votes > longlist_votes)
