"""The fit kind on the CPU at the cell's test sizes, in float64: every step's
model spectrum, loss and gradient agree with ``reference.fit`` component
by component, fits restart from the mix's start, the kept step holds
Kernel 1b's input and outputs as the reference has them, and a traced run
reports the step's forward and backward walls."""

import numpy as np
import torch

from portbench import bench, inputs
from portbench.reference import fit as reference_fit
from portbench.reference.spectrum import Reference

WORKLOAD = "sim100aa_sun.fit"
SEED = 2**31 + 4242


def test_steps_agree_with_the_reference(tmp_path):
    torch.set_num_threads(2)
    sizes = bench.test_sizes(WORKLOAD)
    config = {**bench.load_json("configs", "sim100aa_sun"), **sizes["config"]}
    mix = {**bench.load_json("traffic", "fit"), **sizes["traffic"]}
    ctx = bench.Context(config, mix, SEED, "cpu", torch.float64, tmp_path)
    driver = bench.load_module("drivers", "fit").Driver(ctx)
    steps = mix["steps_per_fit"]
    answers = [driver.call(i)[0] for i in range(steps + 1)]  # a fit, and the next one's start
    ref = Reference(inputs.stardis_config(config, driver.template_path, ctx.tables),
                    inputs.atom_data(config), ctx.lambdas, driver.template_path, "cpu")
    for (path, t_scale), ans in answers:
        assert t_scale == ans["params"][0]
        m_ref, g_ref, vjp = reference_fit.step(ref, path, ans["params"], ans["observed"],
                                               ans["vel_pix"], mix["half_width_pix"],
                                               mix["radius_pix"], mix["fd_step"])
        residual = ans["model"] - ans["observed"]
        # the plain paths on both sides, in float64: rounding only
        assert np.max(np.abs(ans["model"] - m_ref)) < 1e-12
        assert abs(ans["loss"] / np.mean((m_ref - ans["observed"]) ** 2) - 1.0) < 1e-9
        # v sin i and sigma: autograd on both sides
        np.testing.assert_allclose(ans["grad"][1:], g_ref[1:], rtol=1e-9)
        # the T scale: the reference's central difference (h = 1e-5), whose
        # truncation reads up to 1.5e-8 of it at these sizes
        np.testing.assert_allclose(ans["grad"][0], g_ref[0], rtol=1e-7)
        # the check's g*: the reference's Jacobian on the step's residual
        np.testing.assert_allclose(vjp(2.0 / len(residual) * residual), g_ref, rtol=1e-7)
    start = np.asarray(mix["start"], dtype=np.float64)
    assert np.array_equal(answers[0][1]["params"], start)
    assert not np.array_equal(answers[1][1]["params"], start)
    assert np.array_equal(answers[steps][1]["params"], start)
    assert [a["target"] for _k, a in answers] == [0] * steps + [1]
    assert not np.array_equal(answers[0][1]["observed"], answers[steps][1]["observed"])


def test_traced_run_reports_the_step_walls():
    torch.set_num_threads(2)
    result = bench.run(WORKLOAD, SEED, 0.5, 1, "cpu", torch.float64,
                       overrides=bench.test_sizes(WORKLOAD), log=lambda msg: None)
    assert result["correct"]
    metrics = {name: entry["value"] for name, entry in result["metrics"].items()}
    assert metrics["fit_forward_ms"] > 0 and metrics["fit_backward_ms"] > 0
    # no card, no device trace: the kernels' rooflines find nothing to read
    assert "kernel1b_roofline" not in metrics and "kernel1_roofline" not in metrics


def test_kept_step_holds_kernel1b_input_and_outputs(tmp_path):
    torch.set_num_threads(2)
    sizes = bench.test_sizes(WORKLOAD)
    config = {**bench.load_json("configs", "sim100aa_sun"), **sizes["config"]}
    mix = {**bench.load_json("traffic", "fit"), **sizes["traffic"], "kernel1b_within": 3}
    ctx = bench.Context(config, mix, SEED, "cpu", torch.float64, tmp_path)
    fit = bench.load_module("drivers", "fit")
    driver = fit.Driver(ctx)
    answers = [driver.call(i)[0][1] for i in range(3)]
    n_nu, n_depth = len(ctx.lambdas), len(driver.plan.temperatures)
    n_lines = int(driver.consts.lines["atomic"][0].shape[0])
    kept = driver.close()
    assert kept["call"] == driver.keep_at
    assert np.array_equal(kept["params"], answers[kept["call"]]["params"])
    entry = kept["lines"]["atomic"]
    assert entry["kappa"].shape == (n_depth, n_nu)
    assert all(entry[name].shape == (n_lines, n_depth) for name in ("alpha", "gamma", "doppler"))
    ref = Reference(inputs.stardis_config(config, kept["path"], ctx.tables),
                    inputs.atom_data(config), ctx.lambdas, kept["path"], "cpu")
    model = fit.reference_model(ref, (kept["path"], kept["params"][0]))
    plain = ref.model(kept["path"], kept["params"][0])
    np.testing.assert_allclose(model.composition.density * kept["params"][0],
                               plain.composition.density, rtol=1e-15)
    picked = {}

    def every_line(key, reach):
        picked[key] = np.flatnonzero(reach)
        return picked[key]

    want = reference_fit.line_gradients(ref, model, {"atomic": entry["kappa"]}, every_line)
    assert 0 < len(picked["atomic"]) <= n_lines
    for name, g_ref in zip(("alpha", "gamma", "doppler"), want["atomic"]):
        g = entry[name][picked["atomic"]]
        assert np.max(np.abs(g - g_ref)) <= 1e-12 * np.max(np.abs(g_ref))
        # lines whose windows miss the grid get no gradient
        assert not np.any(np.delete(entry[name], picked["atomic"], axis=0))
