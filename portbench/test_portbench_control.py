"""The control comes out not correct: the reference computed in bfloat16,
in the program's place, reads above each cell's limit while the
program reads below it.  On the card, at the cells' test sizes; the chip
runs it with ``python -m pytest portbench -m cuda``."""

import pytest
import torch

from portbench import bench

CELLS = [w["name"] for w in bench.load_spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limit(card, workload):
    result = bench.run(workload, 2**31 + 901, 0.5, 0, card, torch.float32,
                       overrides=bench.test_sizes(workload), log=lambda msg: None,
                       control=True)
    for name, entry in result["compared"].items():
        assert entry["value"] <= entry["limit"] < result["control"][name]
