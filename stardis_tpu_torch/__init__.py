"""stardis_tpu_torch — the PyTorch + CUDA port of stardis_tpu for NVIDIA
Hopper GPUs.

Entry points, all on the card in float32 unless the caller passes
``device="cpu"`` (they raise when asked for a GPU that is not there):
``run_stardis`` (one model, plane-parallel or spherical, with molecules,
file opacities, either window mode, and ``nu_segments=K | "auto"`` for
grids beyond the card's memory), ``parallel.batch.run_batch`` (a grid of
models on one device), ``serving.SpectralService`` (repeated requests
against one plan), ``grid.synthesize_grid`` (checkpointed library scans)
and ``python -m stardis_tpu_torch`` (the command line), and
``postprocessing`` (rotational and instrumental broadening: scipy host
functions and differentiable torch ones).  The gradient path has no entry
point of its own: as with the JAX package, a caller passes temperatures
(or densities) with ``requires_grad`` to ``pipeline.stage_plasma_and_lines``
and then ``stage_spectrum``, ``spectrum_batch``, ``parallel.batch.run_batch``
or ``parallel.sharding.segmented_spectrum``, post-processes, and calls
``loss.backward()``; host copies (``run_stardis``' output, segments with
``collect_opacities``) carry no gradient and raise under autograd.  A
NumPy host phase (config, MARCS model, builtin atom and molecular data,
line selection, file tables), a torch LTE solve and line quantities, and
four hand-written CUDA kernels for sm_90a — line-opacity accumulation over
any pixel range of the grid (csrc/line_opacity.cu) and its backward
(csrc/line_opacity_grad.cu), the formal solution with its spherical
inward sweep (csrc/formal_solution.cu) and its backward
(csrc/formal_solution_grad.cu), each taking a batch of models in one
launch.  On CPU tensors each kernel's plain torch version runs instead.
The JAX package ``stardis_tpu`` is the reference it is tested against;
this package never imports it.
"""

from .base import STARDISOutput, parse_config_to_model, run_stardis

__version__ = "0.1.0"

__all__ = ["run_stardis", "STARDISOutput", "parse_config_to_model"]
