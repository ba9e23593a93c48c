"""A molecule batch member's gradient: d sum(F_nu) / dT of a cool giant in
``run_batch`` against ``jax.grad`` of that model's JAX run, float64 on the
CPU.  Apart from ``tests/test_torch_molecule_batch.py``, whose setup it
shares, because the JAX gradient takes ~2 min to compile: the two files
then run side by side."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stardis_tpu.pipeline import (  # noqa: E402
    line_window_tiers,
    stage_plasma_and_lines,
    stage_spectrum,
)
from stardis_tpu_torch.parallel import batch as tbatch  # noqa: E402
from test_torch_molecule_batch import CPU, _setup  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_flux_grad(plan):
    """jax.grad of sum(F_nu[surface]) with respect to T, on windows from
    line_window_tiers at the plan's temperatures."""
    n_elem = jnp.asarray(plan.n_elem)
    temps0 = jnp.asarray(plan.temperatures)
    state, lq = stage_plasma_and_lines(plan, temps0, n_elem)
    window = line_window_tiers(plan, lq, state)

    def flux_sum(t):
        st, q = stage_plasma_and_lines(plan, t, n_elem)
        return jnp.sum(stage_spectrum(plan, st, q, window=window)[0][-1])

    return np.asarray(jax.jit(jax.grad(flux_sum))(temps0))


def test_member_gradient_matches_jax_grad(tmp_path):
    """d sum(F_nu[surface]) / dT of the giants' batch member 1 (coupled
    molecules; tensor temperatures that require grad, the molecular rows
    host constants as the JAX plan's tables are) equals jax.grad of that
    model's JAX run at 1e-8, relative to its largest entry.  One case: the
    JAX gradient takes ~2 min to compile on the CPU."""
    s = _setup(tmp_path, "giants", True, jax_runs=False)
    temps = torch.tensor(s.batch.temperatures, requires_grad=True)
    f_nu = tbatch.run_batch(s.plan, dataclasses.replace(s.batch, temperatures=temps), **CPU)
    f_nu[:, -1].sum().backward()
    ref = _jax_flux_grad(s.jplans[1])
    ours = temps.grad[1].numpy()
    assert np.isfinite(ours).all() and np.abs(ref).max() > 0
    assert np.abs(ours - ref).max() / np.abs(ref).max() <= 1e-8
