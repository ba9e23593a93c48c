"""Readings that set the limits of ``correct``: for each seed, one run of
the cell with a short window (set-up, the window, the check, as
``run.py`` does them) and, for the control seeds, the control's reading on
the same sampled inputs: the reference computed in bfloat16 in the
program's place.  One JSON line per seed.

    python3 portbench/control.py --workload sim100aa_sun.serve \
        --seeds 1,2,3,4,5,6,7,8,9,10,11,12 --control-seeds 1,2,3 --seconds 3

``--kernel1-scale 1.01`` reads a fault instead: Kernel 1's output scaled
where ``accumulate_line_opacity_cuda`` returns it, in the measured window
alone (``faults.py``), so only a check that reads the window's own calls
sees it.  The benchmark's own runs never run the control or a fault.
"""

import argparse
import json
import sys
import time

from run import BUILD, ROOT  # noqa: F401  (portbench/ is the script's directory)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--kernel1-scale", type=float, default=None)
    args = parser.parse_args(argv)
    import os

    os.environ["STARDIS_COMPILE_CACHE"] = str(BUILD / "stardis")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from stardis_tpu_torch.util.compile_cache import enable_compilation_cache

    from portbench import bench, faults

    enable_compilation_cache()
    if args.kernel1_scale is not None:
        faults.scale_kernel1(setattr, args.kernel1_scale, when=faults.in_window(setattr))
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result = bench.run(args.workload, seed, args.seconds, 0, "cuda", torch.float32,
                           control=seed in controls)
        line = {"workload": args.workload, "seed": seed, "correct": result["correct"],
                "attempted": result["attempted"], "failed": result["failed"],
                "program": {k: v["value"] for k, v in result["compared"].items()},
                "control": result.get("control"), "seconds": time.perf_counter() - t0,
                "kind": torch.cuda.get_device_name(0), "kernel1_scale": args.kernel1_scale}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
