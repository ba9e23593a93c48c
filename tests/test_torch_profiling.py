"""``stardis_tpu_torch.util.profiling`` against the JAX package's: the
StageTimer's stages accumulate, ``report`` returns them with their total
and logs the throughput line; ``block_on`` takes CPU tensors (nested);
``device_trace`` writes a trace file under its directory on the CPU; and
``run_stardis`` logs the same "plan" and "solve" stages as JAX's."""

import json
import logging
import re
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import torch  # noqa: E402

import stardis_tpu  # noqa: E402
from stardis_tpu import units as ju  # noqa: E402
from stardis_tpu.util.profiling import StageTimer as JaxStageTimer  # noqa: E402
from stardis_tpu_torch import run_stardis  # noqa: E402
from stardis_tpu_torch import units as tu  # noqa: E402
from stardis_tpu_torch.io.synthetic import write_marcs_file  # noqa: E402
from stardis_tpu_torch.util.profiling import StageTimer, device_trace  # noqa: E402
from stardis_tpu_torch.util.regression import golden_config  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def drive(timer):
    for name, wall in (("a", 0.02), ("b", 0.01), ("a", 0.01)):
        with timer.stage(name):
            time.sleep(wall)
    return timer


def test_stage_timer_matches_jax(caplog):
    with caplog.at_level(logging.INFO):
        ours = drive(StageTimer(grid_cells=1000)).report()
        ref = drive(JaxStageTimer(grid_cells=1000)).report()
    assert list(ours) == list(ref) == ["a", "b", "total"]
    assert ours["a"] >= 0.03 and ours["b"] >= 0.01
    assert ours["total"] == pytest.approx(ours["a"] + ours["b"])
    lines = [r.getMessage() for r in caplog.records if r.name == "stardis_tpu_torch.util.profiling"]
    assert len(lines) == 1 and "(lambda x depth) cells/s" in lines[0]
    assert re.sub(r"[0-9.,]+", "#", lines[0]) == re.sub(
        r"[0-9.,]+", "#", [r.getMessage() for r in caplog.records
                           if r.name == "stardis_tpu.util.profiling"][0])
    timer = StageTimer()
    assert timer.report(log=False) == {"total": 0}
    caplog.clear()
    drive(timer).report(log=False)
    assert not caplog.records


def test_block_on_cpu_tensors():
    timer = StageTimer()
    x = torch.ones(4)
    with timer.stage("cpu", block_on={"a": x, "b": [x, (x * 2, None)]}):
        x.add_(1)
    with timer.stage("cpu", block_on=x):
        pass
    assert set(timer.stages) == {"cpu"} and timer.total > 0


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(tmp_path / "trace") as log_dir:
        a = torch.randn(64, 64)
        (a @ a).sum()
    assert log_dir == str(tmp_path / "trace")
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_run_stardis_logs_plan_and_solve(tmp_path, caplog):
    model = tmp_path / "sun.mod"
    write_marcs_file(model)
    cfg = golden_config("solar_halpha", model)
    lams = np.arange(6560.0, 6566.0, 0.1)
    yml = tmp_path / "c.yml"
    yml.write_text(yaml.safe_dump(cfg))

    def stages(logger_name):
        msgs = [r.getMessage() for r in caplog.records
                if r.name == logger_name and r.getMessage().startswith("stage timings")]
        assert len(msgs) == 1, msgs
        return re.findall(r"(\w+): [0-9.]+s", msgs[0]), msgs[0]

    with caplog.at_level(logging.INFO):
        run_stardis(cfg, tu.Quantity(lams, tu.AA), device="cpu", dtype=torch.float64)
        stardis_tpu.run_stardis(str(yml), ju.Quantity(lams, ju.AA))
    ours, msg = stages("stardis_tpu_torch.util.profiling")
    ref, _ = stages("stardis_tpu.util.profiling")
    assert ours == ref == ["plan", "solve"]
    assert "throughput" in msg
