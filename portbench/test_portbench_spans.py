"""The per-layer metrics read from the program's spans: small traced CPU
runs of both cells report them, and on the served cell the three request
metrics together take no more than the mean request wall the harness
timed.  A program without spans gives None and raises nothing."""

import sys
import types

import pytest
import torch

from portbench import bench, program_spans

SEED = 2**33 + 5
READERS = {"sim100aa_sun.serve": ("request_inputs_ms", "dispatch_ms", "device_wait_ms"),
           "giant_mol.batch8": ("file_sigma_ms",)}


def traced_run(workload, monkeypatch):
    """bench.run traced on the CPU at the cell's test sizes; also returns
    the latencies of the traced window's calls."""
    real, seen = bench.closed_loop, {}

    def loop(driver, seconds, timings=None):
        out = real(driver, seconds, timings)
        seen["latencies"] = out[1]
        return out

    monkeypatch.setattr(bench, "closed_loop", loop)
    torch.set_num_threads(2)
    result = bench.run(workload, SEED, 0.5, 1, "cpu", torch.float64,
                       overrides=bench.test_sizes(workload), log=lambda msg: None)
    return result, seen["latencies"]


@pytest.mark.parametrize("workload", sorted(READERS))
def test_traced_run_reports_the_span_metrics(workload, monkeypatch):
    result, latencies = traced_run(workload, monkeypatch)
    assert result["correct"]
    values = {name: result["metrics"][name]["value"] for name in READERS[workload]}
    assert all(v > 0 for v in values.values()), values
    mean_wall_ms = 1e3 * sum(latencies) / len(latencies)
    if workload == "sim100aa_sun.serve":
        assert sum(values.values()) <= mean_wall_ms
    else:
        collect_ms = result["metrics"]["collect_inputs_ms"]["value"]
        assert values["file_sigma_ms"] <= collect_ms <= mean_wall_ms


def test_a_program_without_spans_gives_none(monkeypatch):
    """The parent of the spans has ``util.profiling`` without ``spans``."""
    monkeypatch.setitem(sys.modules, "stardis_tpu_torch.util.profiling",
                        types.ModuleType("stardis_tpu_torch.util.profiling"))
    assert program_spans.mean_per_root("serve.request", ("serve.inputs",)) is None
    for names in READERS.values():
        for name in names:
            assert bench.load_module("metrics", name).read({}) is None
