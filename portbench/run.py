"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload giant_mol.batch8 --seed 12345 \
        --seconds 51 --trace 0

Set-up (inputs from the seed, the program's plan, kernels and graphs, a
warm-up of every shape the cell uses) counts as ``setup_s``; the window
then runs the cell's closed loop for ``--seconds``; the reference checks a
sample of the answers.  ``--trace 1`` profiles a window of at most
``bench.TRACE_SECONDS`` and reports the per-layer metrics.  The last line
of standard output is one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error.  Without a CUDA card, or
with fewer cards than the cell asks for, it exits with 2 and prints no
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = HERE / ".build"
#: top-level modules that may not be loaded in the process that prints
#: the result: JAX and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "stardis_tpu")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # every build and kernel cache of the program inside the checkout, at
    # fixed paths, so that only a checkout's first run compiles
    os.environ["STARDIS_COMPILE_CACHE"] = str(BUILD / "stardis")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    print(f"torch imported at {time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; cells: {sorted(cells)}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2

    import stardis_tpu_torch  # noqa: F401  (fails here, before any result, without the program)
    from stardis_tpu_torch.util.compile_cache import enable_compilation_cache

    from portbench import bench

    enable_compilation_cache()
    result = bench.run(args.workload, args.seed, args.seconds, args.trace, "cuda",
                       torch.float32, t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    compared = result["compared"]
    for name, entry in compared.items():
        print(f"{name} {entry['value']!r} limit {entry['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
