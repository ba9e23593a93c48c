"""Persistent kernel build cache (the port of
``stardis_tpu/util/compile_cache.py``).

The port compiles at first use: ``nvcc`` builds each CUDA kernel of
``csrc/`` (``_cuda.load``) and g++ the VALD text parser
(``native._load_library``), each into a build directory, keyed by a hash
of its source and flags, and loads it from there in every later process.
By default that directory is ``stardis_tpu_torch/_build``;
``enable_compilation_cache`` points both builds at another one, so that
processes which do not share a checkout (a CLI run, a serving process, a
grid scan) share one set of builds and start without compiling.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

logger = logging.getLogger(__name__)

ENV_VAR = "STARDIS_COMPILE_CACHE"


def enable_compilation_cache(cache_dir=None):
    """Point the kernels' build directory at ``cache_dir``.

    ``cache_dir`` defaults to the ``STARDIS_COMPILE_CACHE`` environment
    variable; if neither is set this is a no-op (returns None).  The
    directory is created if missing.  Returns the resolved path.

    A call without ``cache_dir`` (the entry points' wiring) leaves a
    directory that was set before (by the CLI's ``--compile-cache`` or a
    call with a directory) as it is and returns it.  A library already
    loaded in this process stays loaded; later builds and loads use the
    new directory.  The JAX package's ``min_compile_secs`` has no
    counterpart: every build takes seconds or more, so every build is
    cached.
    """
    from .. import _cuda, native

    explicit = cache_dir is not None
    if cache_dir is None:
        cache_dir = os.environ.get(ENV_VAR)
    if not cache_dir:
        return None
    path = Path(cache_dir).expanduser()
    current = _cuda.BUILD_DIR
    if not explicit and current != _cuda.DEFAULT_BUILD_DIR and current != path:
        return str(current)
    path.mkdir(parents=True, exist_ok=True)
    _cuda.BUILD_DIR = native.BUILD_DIR = path
    logger.info("Kernel build cache at %s", path)
    return str(path)
