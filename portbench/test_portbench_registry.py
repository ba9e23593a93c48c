"""The benchmark is driven by data: every cell, configuration, traffic
mix, limit and metric of BENCHMARK.json is found by its name."""

import json

import pytest

from portbench import bench

SPEC = bench.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
PER_LAYER = [m["name"] for m in SPEC["per_layer"]]
END_TO_END = [m["name"] for m in SPEC["end_to_end"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = next(w for w in SPEC["workloads"] if w["name"] == workload)
    config = bench.load_json("configs", cell["config"])
    entry = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    assert entry["file"] == f"portbench/configs/{cell['config']}.json"
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    mix = bench.load_json("traffic", cell["traffic"])
    driver = bench.load_module("drivers", mix["kind"])
    assert callable(driver.Driver)
    limits = bench.load_json("limits", workload)
    assert all(v["limit"] > 0 for v in limits.values())
    # every limit lies between the readings it was set from, Kernel 1's
    # output compared in every cell
    assert all(v["lower"] < v["limit"] < v["upper"] for v in limits.values())
    assert "line_opacity_err" in limits
    reported = bench.cell_metrics(SPEC, workload, "end_to_end")
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    assert bench.cell_metrics(SPEC, workload, "per_layer")


@pytest.mark.parametrize("name", PER_LAYER)
def test_per_layer_metric_found_by_name(name):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == name)
    module = bench.load_module("metrics", name)
    stem, _, suffix = name.partition(".")  # a split metric reads with its stem's reader
    moves = module.MOVES + (f".{suffix}" if suffix else "")
    assert (module.NAME, module.UNIT, module.LAYER, moves) == (
        stem, entry["unit"], entry["layer"], entry["moves"])
    assert callable(module.read)
    moved = next(m for m in SPEC["end_to_end"] if m["name"] == entry["moves"])
    for cell in entry["workloads"]:  # a cell that reports it reports what it moves
        assert cell in moved.get("workloads", [cell])


@pytest.mark.parametrize("name", END_TO_END)
def test_end_to_end_metric_found_by_name(name):
    assert callable(bench.load_module("end_to_end", name).read)


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    assert len(json.dumps(SPEC)) < 64 * 1024
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_driver_module_check_replaces_the_spectrum_check(monkeypatch):
    """A kind whose answers are no spectra brings its own ``check``, which
    gets what ``Driver.close()`` returned: a new kind is a new file."""
    import types

    import torch

    real_load = bench.load_module
    seen = {}

    def load(folder, name):
        module = real_load(folder, name)
        if folder != "drivers":
            return module

        class Driver(module.Driver):
            def close(self):
                super().close()
                return "first steps"

        def check(ref, answers, mix, seed, n_nu, kept):
            seen.update(kept=kept, calls=len(answers))
            return {"spectrum_rel_err": 1.0}

        return types.SimpleNamespace(Driver=Driver, check=check)

    monkeypatch.setattr(bench, "load_module", load)
    torch.set_num_threads(2)
    result = bench.run("sim100aa_sun.serve", 5, 0.2, 0, "cpu", torch.float64,
                       overrides=bench.test_sizes("sim100aa_sun.serve"), log=lambda msg: None)
    assert seen["kept"] == "first steps" and seen["calls"] == result["attempted"] >= 1
    assert result["compared"]["spectrum_rel_err"]["value"] == 1.0 and not result["correct"]


def test_control_readings_use_the_kinds_own_check(monkeypatch):
    """``control_readings`` hands the control (the reference in bfloat16)
    to the check of the driver module, where it has one."""
    import types

    import torch

    real_load = bench.load_module
    seen = []

    def load(folder, name):
        module = real_load(folder, name)
        if folder != "drivers":
            return module

        def check(ref, answers, mix, seed, n_nu, kept=None, control=None):
            seen.append((ref.dtype, None if control is None else control.dtype))
            return {"spectrum_rel_err": 0.0 if control is None else 2.0}

        return types.SimpleNamespace(Driver=module.Driver, check=check)

    monkeypatch.setattr(bench, "load_module", load)
    torch.set_num_threads(2)
    result = bench.run("sim100aa_sun.serve", 5, 0.2, 0, "cpu", torch.float64,
                       overrides=bench.test_sizes("sim100aa_sun.serve"), log=lambda msg: None,
                       control=True)
    assert seen == [(torch.float64, None), (torch.float64, torch.bfloat16)]
    assert result["control"] == {"spectrum_rel_err": 2.0} and result["correct"]
