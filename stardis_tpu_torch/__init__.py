"""stardis_tpu_torch — the PyTorch + CUDA port of stardis_tpu for NVIDIA
Hopper GPUs.

Entry points: ``run_stardis`` (one model, plane-parallel or spherical,
with molecules, file opacities and either window mode) and
``parallel.batch.run_batch`` (a grid of models on one device).  A NumPy
host phase (config, MARCS model, builtin atom and molecular data, line
selection, file tables), a torch LTE solve and line quantities, and two
hand-written CUDA kernels for sm_90a — line-opacity accumulation
(csrc/line_opacity.cu) and the formal solution with its spherical inward
sweep (csrc/formal_solution.cu), each taking a batch of models in one
launch.  On CPU tensors each kernel's plain torch version runs instead.  The JAX package ``stardis_tpu`` is the reference it is tested
against; this package never imports it.
"""

from .base import STARDISOutput, parse_config_to_model, run_stardis

__version__ = "0.1.0"

__all__ = ["run_stardis", "STARDISOutput", "parse_config_to_model"]
