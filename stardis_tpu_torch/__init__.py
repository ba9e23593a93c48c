"""stardis_tpu_torch — the PyTorch + CUDA port of stardis_tpu for NVIDIA
Hopper GPUs.

Entry points, all on the card in float32 unless the caller passes
``device="cpu"`` (they raise when asked for a GPU that is not there):
``run_stardis`` (one model, plane-parallel or spherical, with molecules,
file opacities, either window mode, and ``nu_segments=K | "auto"`` for
grids beyond the card's memory), ``parallel.batch.run_batch`` (a grid of
models on one device), ``serving.SpectralService`` (repeated requests
against one plan), ``grid.synthesize_grid`` (checkpointed library scans)
and ``python -m stardis_tpu_torch`` (the command line).  A NumPy host
phase (config, MARCS model, builtin atom and molecular data, line
selection, file tables), a torch LTE solve and line quantities, and two
hand-written CUDA kernels for sm_90a — line-opacity accumulation over any
pixel range of the grid (csrc/line_opacity.cu) and the formal solution
with its spherical inward sweep (csrc/formal_solution.cu), each taking a
batch of models in one launch.  On CPU tensors each kernel's plain torch
version runs instead.  The JAX package ``stardis_tpu`` is the reference it
is tested against; this package never imports it.
"""

from .base import STARDISOutput, parse_config_to_model, run_stardis

__version__ = "0.1.0"

__all__ = ["run_stardis", "STARDISOutput", "parse_config_to_model"]
