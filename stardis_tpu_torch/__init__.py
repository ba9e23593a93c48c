"""stardis_tpu_torch — the PyTorch + CUDA port of stardis_tpu for NVIDIA
Hopper GPUs.

Entry points, all on the card in float32 unless the caller passes
``device="cpu"`` (they raise when asked for a GPU that is not there):
``run_stardis`` (one model, plane-parallel or spherical, with molecules,
file opacities, either window mode, and ``nu_segments=K | "auto"`` for
grids beyond the card's memory), ``parallel.batch.run_batch`` (a grid of
models), ``serving.SpectralService`` (repeated requests against one plan),
``grid.synthesize_grid`` (checkpointed library scans), ``python -m
stardis_tpu_torch`` (the command line; ``--compile-cache DIR`` or
``STARDIS_COMPILE_CACHE`` keeps the kernel builds in DIR,
``util.compile_cache``), each of the first four also with ``mesh=``
(``parallel.sharding.Mesh``: wavelengths and models sharded over devices,
across processes with ``parallel.distributed``),
``radiation_field.create_stellar_radiation_field`` (the whole device
pipeline for a prepared model, outputs in the caller's frequency order),
``plasma.create_stellar_plasma`` (a model's LTE plasma state), and
``postprocessing`` (rotational and instrumental broadening: scipy host
functions and differentiable torch ones).  Atom data: carsus stores are
converted by ``python -m stardis_tpu_torch.atom_data.convert`` (or in
memory by ``atom_data.convert.convert_frames``), published ones fetched by
``atom_data.download_atom_data``, and a kurucz-scale synthetic one made by
``atom_data.synthetic_carsus``; ``util.profiling`` times stages and traces
the card.  The gradient path has no entry
point of its own: as with the JAX package, a caller passes temperatures
(or densities) with ``requires_grad`` to ``pipeline.stage_plasma_and_lines``
and then ``stage_spectrum``, ``spectrum_batch``, ``parallel.batch.run_batch``
or ``parallel.sharding.segmented_spectrum``, post-processes, and calls
``loss.backward()``; host copies (``run_stardis``' output, segments with
``collect_opacities``) carry no gradient and raise under autograd.  A
NumPy host phase (config, MARCS and MESA models, builtin atom and
molecular data, an HDF5 atom-data store or a carsus store, VALD text line lists through
a C++ parser built by g++ at first use, line selection, file tables; the
HDF5 output in ``util.hdf``), a torch LTE solve and line quantities, and
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
