"""Command-line synthesis: ``python -m stardis_tpu_torch`` (the port of
``stardis_tpu/__main__.py``).

    python -m stardis_tpu_torch config.json --lambda 6540:6590:0.01 \\
        --ascii spectrum.txt --segments auto

``--lambda`` takes ``start:stop:step`` in Angstrom (stop exclusive).
``--ascii`` writes a two-column (wavelength [AA], F_lambda
[erg/s/cm^2/AA]) text table.  ``--set`` applies dotted-key config overrides,
e.g. ``--set opacity.line.disable=true``.  ``--segments K|auto`` runs the
grid in K serial wavelength segments (``run_stardis(nu_segments=)``).  The
run is on the card in float32; ``--cpu`` runs on the CPU in float64.
Configs are JSON (YAML where PyYAML is installed).

Library scans: ``--grid`` takes a directory (or glob) of model files and
synthesizes them with per-chunk checkpoints into ``--scan-out``
(``stardis_tpu_torch.grid``); a stopped scan re-run resumes:

    python -m stardis_tpu_torch config.json --lambda 4000:7000:0.02 \\
        --grid 'models/*.mod' --scan-out scan_dir --batch-size 8

``--output`` (HDF5) is not ported yet (ROADMAP.md Queue 1 item 11, other
inputs and the HDF output writer); ``--compile-cache`` belongs to XLA and
has no counterpart.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
import time
from pathlib import Path

import numpy as np


def _parse_lambda(spec: str):
    try:
        start, stop, step = (float(tok) for tok in spec.split(":"))
    except ValueError:
        raise SystemExit(f"--lambda expects start:stop:step in Angstrom, got {spec!r}")
    if not (stop > start and step > 0):
        raise SystemExit(f"--lambda needs stop > start and step > 0, got {spec!r}")
    return np.arange(start, stop, step)


def _parse_override(item: str):
    if "=" not in item:
        raise SystemExit(f"--set expects dotted.key=value, got {item!r}")
    key, _, raw = item.partition("=")
    try:
        value = json.loads(raw)  # numbers / true / false / null / quoted
    except json.JSONDecodeError:
        value = raw  # bare string
    return key, value


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m stardis_tpu_torch",
        description="LTE stellar spectral synthesis (PyTorch + CUDA)",
    )
    parser.add_argument("config", help="JSON (or YAML) config file")
    parser.add_argument(
        "--lambda", dest="lambda_spec", required=True, metavar="A:B:STEP",
        help="wavelength grid start:stop:step in Angstrom (stop exclusive)",
    )
    parser.add_argument(
        "--output", metavar="FILE.h5",
        help="HDF5 output: not ported yet (ROADMAP.md Queue 1 item 11)",
    )
    parser.add_argument(
        "--ascii", metavar="FILE.txt",
        help="write a two-column (lambda [AA], F_lambda) text table",
    )
    parser.add_argument(
        "--set", dest="overrides", action="append", default=[], metavar="KEY=VALUE",
        help="dotted-key config override (repeatable), e.g. "
        "--set opacity.line.disable=true",
    )
    parser.add_argument(
        "--cpu", action="store_true",
        help="run on the CPU in float64 (default: the GPU in float32)",
    )
    parser.add_argument(
        "--segments", default="1", metavar="K",
        help="synthesize the grid in K serial wavelength segments (exact "
        "partition, for grids beyond the card's memory); 'auto' sizes K from "
        "the memory model",
    )
    parser.add_argument(
        "--grid", metavar="DIR_OR_GLOB",
        help="synthesize a GRID of model files (directory or glob) with "
        "checkpoint/resume; needs --scan-out",
    )
    parser.add_argument(
        "--scan-out", metavar="DIR",
        help="checkpoint directory for --grid (chunk_XXXXX.npz + manifest)",
    )
    parser.add_argument(
        "--batch-size", type=int, default=None,
        help="models per chunk for --grid (default: min(8, number of models))",
    )
    args = parser.parse_args(argv)

    if args.segments != "auto":
        try:
            args.segments = int(args.segments)
        except ValueError:
            raise SystemExit(
                f"--segments expects an integer or 'auto', got {args.segments!r}"
            )
    if args.output:
        from .pipeline import not_ported

        raise not_ported("--output (HDF5)", "item 11, other inputs and the HDF output writer")
    lambdas_aa = _parse_lambda(args.lambda_spec)
    overrides = dict(_parse_override(item) for item in args.overrides)

    import torch

    device, dtype = ("cpu", torch.float64) if args.cpu else ("cuda", torch.float32)
    if args.grid and args.segments != 1:
        # grid scans batch over models; wavelength segments do not reach
        # synthesize_grid, so refuse rather than drop the flag
        raise SystemExit(
            "--segments is not supported with --grid: narrow the wavelength grid instead"
        )
    if args.grid:
        return _run_grid(args, lambdas_aa, overrides, device, dtype)

    from . import run_stardis
    from . import units as u

    t0 = time.perf_counter()
    sim = run_stardis(
        args.config, u.Quantity(lambdas_aa, u.AA), add_config_dict=overrides or None,
        device=device, dtype=dtype, nu_segments=args.segments,
    )
    wall = time.perf_counter() - t0

    f_lam = np.asarray(sim.spectrum_lambda)
    lam = np.asarray(sim.lambdas)
    print(
        f"synthesized {len(lam)} points in {wall:.2f}s "
        f"({lambdas_aa[0]:.2f}-{lambdas_aa[-1]:.2f} AA) on {device}; "
        f"F_lambda range [{f_lam.min():.4e}, {f_lam.max():.4e}] erg/s/cm^2/AA"
    )
    if args.ascii:
        np.savetxt(args.ascii, np.column_stack([lam, f_lam]),
                   header="wavelength_AA  F_lambda_erg_s_cm2_AA")
        print(f"wrote {args.ascii}")
    return 0


def _run_grid(args, lambdas_aa, overrides, device, dtype):
    """--grid: checkpointed library scan over many model files."""
    if not args.scan_out:
        raise SystemExit("--grid needs --scan-out DIR for the checkpoints")
    root = Path(args.grid)
    if root.is_dir():
        # only model-looking files, so a stray README or config in the
        # folder does not become a grid member; use a glob for other layouts
        files = sorted(
            p for p in root.iterdir()
            if p.is_file() and (p.suffix in (".mod", ".dat")
                                or p.name.endswith((".mod.gz", ".dat.gz")))
        )
    else:
        files = sorted(Path(p) for p in glob.glob(args.grid))
    if not files:
        raise SystemExit(f"--grid matched no model files: {args.grid!r}")

    from . import units as u
    from .base import parse_config_to_model, read_stellar_model
    from .grid import synthesize_grid

    config, adata, _model0 = parse_config_to_model(args.config, overrides or None)
    models = [read_stellar_model(config, adata, f) for f in files]
    nus = np.asarray(u.Quantity(lambdas_aa, u.AA).to(u.Hz, u.spectral()))
    t0 = time.perf_counter()
    res = synthesize_grid(
        config, adata, models, nus, args.scan_out, batch_size=args.batch_size,
        device=device, dtype=dtype, labels=[{"fname": str(f)} for f in files],
    )
    wall = time.perf_counter() - t0
    state = "complete" if res["done"] else "PARTIAL (re-run to resume)"
    print(
        f"grid scan {state}: {len(files)} models x {len(lambdas_aa)} points, "
        f"{res['computed']} chunk(s) computed (+{res['skipped']} resumed) in "
        f"{wall:.2f}s -> {res['out_dir']}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
