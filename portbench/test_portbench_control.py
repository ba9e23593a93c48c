"""The control comes out not correct: the reference computed in bfloat16,
in the program's place, reads above each cell's limit while the
program reads below it; and so does Kernel 1 on the card with its output
1 % off in the measured window alone.  On the card, at the cells' test
sizes; the chip runs it with ``python -m pytest portbench -m cuda``."""

import pytest
import torch

from portbench import bench, faults

CELLS = [w["name"] for w in bench.load_spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limit(card, workload):
    result = bench.run(workload, 2**31 + 901, 0.5, 0, card, torch.float32,
                       overrides=bench.test_sizes(workload), log=lambda msg: None,
                       control=True)
    for name, entry in result["compared"].items():
        assert entry["value"] <= entry["limit"] < result["control"][name]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_kernel1_fault_fails_the_limit(card, workload, monkeypatch):
    faults.scale_kernel1(monkeypatch.setattr, 1.01, when=faults.in_window(monkeypatch.setattr))
    result = bench.run(workload, 2**31 + 903, 0.5, 0, card, torch.float32,
                       overrides=bench.test_sizes(workload), log=lambda msg: None)
    entry = result["compared"]["line_opacity_err"]
    assert not result["correct"] and entry["limit"] < entry["value"] < 0.02
