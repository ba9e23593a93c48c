"""Runs over several processes (``parallel.distributed``) and over several
cards.

* ``initialize`` is a no-op in one process;
* two processes joined by gloo (a ``file://`` rendezvous under tmp_path),
  two CPU shards each: F_nu of ``run_simulation`` and the spectrum of
  ``run_stardis`` on the global 4-shard mesh equal the one-process run on
  ``["cpu"] * 4`` bit for bit, and so does ``run_batch`` on a 2 x 2 global
  (batch x nu) mesh; a grid scan on that mesh writes each chunk once, from
  process 0, and equals the one-process scan bit for bit;
* on a machine with two cards or more (marked ``cuda``; skips below two):
  Kernels 1, 1b, 2 and 2b launched on cuda:1 while cuda:0 is current equal
  their output on cuda:0, a run on a mesh over every card equals the
  one-card run bit for bit, and the two-process run above on two cards
  (NCCL, float32) equals one process's run on a mesh over both.

The workers are this file run as a script, one process per rank.
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stardis_tpu_torch import pipeline as tpipe
from stardis_tpu_torch import units as tu
from stardis_tpu_torch.atom_data import build_builtin_atom_data
from stardis_tpu_torch.base import parse_config_to_model, read_stellar_model, run_stardis
from stardis_tpu_torch.io.synthetic import write_marcs_file
from stardis_tpu_torch.opacities.lines import synth_linelist
from stardis_tpu_torch.parallel import distributed
from stardis_tpu_torch.parallel.batch import make_batch, run_batch
from stardis_tpu_torch.parallel.sharding import Mesh

REPO = Path(__file__).resolve().parents[1]
TEFFS = (4800.0, 5400.0, 5777.0, 6400.0)
LAMS = 6500.0 + 0.02 * np.arange(151)  # 151 points: 4 shards of 38, 38, 38, 37
WORLD = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread, as each worker runs: float32 sums on several CPU threads
    may round otherwise from run to run, and the suite runs in several
    worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_models(base):
    for i, teff in enumerate(TEFFS):
        write_marcs_file(str(Path(base) / f"m{i}.mod"), teff=teff)


def _inputs(base):
    """(config dict, atom data, the batch's stellar models, nus): what the
    test and each worker build alike from the model files in ``base``."""
    paths = [str(Path(base) / f"m{i}.mod") for i in range(len(TEFFS))]
    cfg = {
        "stardis_config_version": 1.0,
        "atom_data": "builtin:30",
        "input_model": {"type": "marcs", "fname": paths[2], "final_atomic_number": 30},
        "opacity": {
            "bf": {"H_I": {}}, "ff": {"H_I": {}}, "rayleigh": ["H"],
            "line": {"disable": False, "broadening": ["radiation", "linear_stark"],
                     "vald_linelist": {"use_linelist": True, "use_vald_broadening": True}},
        },
        "no_of_thetas": 3,
        "result_options": {},
    }
    atom_data = synth_linelist(build_builtin_atom_data(30, include_linelists=True), 200,
                               6499.0, 6504.0)
    config, adata, _ = parse_config_to_model(copy.deepcopy(cfg), atom_data=atom_data)
    models = [read_stellar_model(config, adata, p) for p in paths]
    nus = tu.Quantity(LAMS, tu.AA).to(tu.Hz, tu.spectral()).value
    return cfg, config, adata, models, nus


def _runs(base, mesh, batch_mesh, scan_dir, device):
    """F_nu [D, N], the surface spectrum, the batch's F_nu and a grid scan
    on the given meshes: float64 on the CPU, float32 on the cards."""
    kw = {"device": device, "dtype": torch.float64 if device == "cpu" else torch.float32}
    cfg, config, adata, models, nus = _inputs(base)
    plan = tpipe.build_simulation_plan(config, adata, models[2], nus)
    f_nu = tpipe.run_simulation(plan, mesh=mesh, **kw)[0]
    spectrum = np.asarray(run_stardis(copy.deepcopy(cfg), tu.Quantity(LAMS, tu.AA),
                                      atom_data=adata, mesh=mesh, **kw).spectrum_nu)
    bplan, batch = make_batch(config, adata, models, nus)
    f_batch = run_batch(bplan, batch, mesh=batch_mesh, **kw)
    from stardis_tpu_torch.grid import synthesize_grid

    scan = synthesize_grid(config, adata, models, nus, scan_dir, mesh=batch_mesh, **kw)
    return f_nu.cpu().numpy(), spectrum, f_batch.cpu().numpy(), scan


def _worker(rank, base, init_file, out_dir, device):
    """One rank of a two-process run: its results and the files it wrote.
    On the CPU (gloo) each rank holds two CPU shards, on the cards (NCCL)
    its own card."""
    from stardis_tpu_torch import grid

    torch.set_num_threads(1)
    assert distributed.initialize(init_method=f"file://{init_file}", world_size=WORLD,
                                  rank=rank, device=device)
    written = []
    save = grid._atomic_savez

    def logged(path, **arrays):
        written.append(Path(path).name)
        save(path, **arrays)

    grid._atomic_savez = logged
    local = ["cpu", "cpu"] if device == "cpu" else None
    mesh = distributed.make_global_mesh(devices=local)
    batch_mesh = distributed.make_batch_nu_mesh(devices=local)
    per_rank = 2 if device == "cpu" else 1
    assert mesh.ranks.tolist() == [r for r in range(WORLD) for _ in range(per_rank)]
    assert batch_mesh.shape == {"batch": WORLD, "nu": per_rank}
    f_nu, spectrum, f_batch, scan = _runs(base, mesh, batch_mesh, Path(out_dir) / "scan",
                                          device)
    np.savez(Path(out_dir) / f"rank{rank}.npz", f_nu=f_nu, spectrum=spectrum, f_batch=f_batch)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps({"written": written,
                                                                "scan": scan}))
    torch.distributed.destroy_process_group()


def test_initialize_is_a_no_op_in_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize(device="cpu") is False
    assert distributed.initialize(world_size=1) is False
    assert not torch.distributed.is_initialized()


def _two_processes(tmp_path, device, one_mesh, one_batch_mesh):
    """Run the two ranks, then the same work in this process on
    ``one_mesh`` / ``one_batch_mesh``; hold each rank's results to it bit
    for bit and the scan's files to one write each, from process 0."""
    _write_models(tmp_path)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), str(tmp_path),
                               str(tmp_path / "rendezvous"), str(out_dir), device],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    f_nu, spectrum, f_batch, scan = _runs(tmp_path, one_mesh, one_batch_mesh,
                                          tmp_path / "scan_one", device)
    from stardis_tpu_torch.grid import load_grid

    for rank in range(WORLD):
        with np.load(out_dir / f"rank{rank}.npz") as got:
            np.testing.assert_array_equal(got["f_nu"], f_nu)
            np.testing.assert_array_equal(got["spectrum"], spectrum)
            np.testing.assert_array_equal(got["f_batch"], f_batch)
    reports = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(WORLD)]
    assert reports[0]["scan"]["done"] and reports[0]["scan"]["computed"] == scan["computed"] == 2
    assert sorted(reports[0]["written"]) == ["chunk_00000.npz", "chunk_00001.npz",
                                             "tracing_nus.npz"]
    assert reports[1]["written"] == []
    np.testing.assert_array_equal(load_grid(out_dir / "scan")[0],
                                  load_grid(tmp_path / "scan_one")[0])


def test_two_processes_equal_one_process(tmp_path):
    _two_processes(tmp_path, "cpu", Mesh(["cpu"] * 4, ("nu",)),
                   Mesh([["cpu"] * 2] * 2, ("batch", "nu")))


@pytest.mark.cuda
def test_two_processes_on_two_cards_equal_one_process(tmp_path):
    """NCCL: each rank on its own card; the same work in one process on a
    mesh over both cards (a host thread each)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    _two_processes(tmp_path, "cuda", Mesh(["cuda:0", "cuda:1"], ("nu",)),
                   Mesh([["cuda:0"], ["cuda:1"]], ("batch", "nu")))


def _kernel_outputs(device):
    """Kernels 1, 1b, 2 and 2b on seeded inputs on ``device``."""
    from stardis_tpu_torch.opacities import line_kernel as lk
    from stardis_tpu_torch.radiation_field import solver

    rng = np.random.default_rng(0)
    n_lines, n_depth, n_nu, n_theta = 200, 12, 1500, 20
    nus = np.linspace(4.6e14, 4.5e14, n_nu)
    line_nu = np.sort(rng.uniform(nus.min(), nus.max(), n_lines))
    t = lambda a: torch.as_tensor(a, device=device).to(torch.float32)  # noqa: E731
    alpha = t(rng.uniform(1e-9, 1e-3, (n_lines, n_depth)))
    gamma, doppler = t(rng.uniform(1e8, 2e9, (n_lines, n_depth))), t(
        rng.uniform(1e9, 5e9, (n_lines, n_depth)))
    nu_ref = float(nus[n_nu // 2])
    iw = lk.window_half_widths(alpha, gamma, doppler, lk.grid_min_step(nus), n_nu)
    prepared = lk.prepare_line_opacity(
        t(nus - nu_ref), t(line_nu - nu_ref),
        torch.as_tensor(lk.line_center_indices(nus, line_nu), device=device), alpha, gamma,
        doppler, iw)
    line = lk.line_opacity_range(prepared)
    grad = t(rng.standard_normal((1, n_depth, n_nu)))
    line_grads = lk.accumulate_line_opacity_grad_cuda(prepared, grad, 0, n_nu)
    alphas = t(rng.uniform(1e-9, 1e-5, (1, n_depth, n_nu)))
    source = t(rng.uniform(1e-6, 1e-4, (1, n_depth, n_nu)))
    rays = t(rng.uniform(1e6, 1e7, (1, n_depth - 1, n_theta)))
    weights = t(np.full(n_theta, 1.0 / n_theta))
    corr = t(np.ones(1))
    f_nu, i_nus = solver.raytrace(alphas, source, rays, weights,
                                  track_individual_intensities=True)
    trace_grads = solver.raytrace_grad_cuda(alphas, source, rays, weights, corr,
                                            grad, None, False)
    return [line, *line_grads, f_nu, i_nus, *trace_grads]


@pytest.mark.cuda
def test_kernels_launch_on_their_tensors_device():
    """A tensor on cuda:1 while cuda:0 is the current device: each kernel
    launches on cuda:1's stream, with its shared-memory opt-in there."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    ref = [x.cpu() for x in _kernel_outputs(torch.device("cuda", 0))]
    assert torch.cuda.current_device() == 0
    other = [x.cpu() for x in _kernel_outputs(torch.device("cuda", 1))]
    for a, b in zip(ref, other):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_mesh_over_every_card_equals_one_card(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from stardis_tpu_torch.parallel.sharding import make_nu_mesh

    _write_models(tmp_path)
    _, config, adata, models, nus = _inputs(tmp_path)
    plan = tpipe.build_simulation_plan(config, adata, models[2], nus)
    one = tpipe.run_simulation(plan, nu_segments=torch.cuda.device_count())[0]
    cards = tpipe.run_simulation(plan, mesh=make_nu_mesh())[0]
    assert torch.equal(one, cards)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), *sys.argv[2:6])
