"""The bound-free product and the broadening products run in full float32,
forward and backward, whatever the caller set.

``torch.backends.cuda.matmul.allow_tf32`` is a process-wide switch (it is
read on the card only, but it is set and read the same way on the CPU).
``util.matmul.full_float32_matmul`` turns it off while its forward and its
backward run, and gives the caller's setting back after each.  A
``TorchFunctionMode`` records the switch at every matrix product of a
forward and of the backward: each must see it off, the backward's
products must be seen at all (autograd's own product backward would run
in C++, unseen and under the caller's setting), and the switch must read
on again afterwards.  The gradients equal autograd of the plain product."""

import numpy as np
import pytest
import torch

from stardis_tpu_torch import postprocessing as pp
from stardis_tpu_torch.opacities import continuum as cont
from stardis_tpu_torch.util.matmul import full_float32_matmul

@pytest.fixture
def products(monkeypatch):
    """The switch as every matrix product (``@``, ``torch.outer``) sees it,
    recorded into a list that the test reads and clears.  Autograd runs a
    backward with an empty torch-function mode stack, so the products are
    wrapped where they are looked up."""
    seen = []
    matmul, outer = torch.Tensor.__matmul__, torch.outer

    def recorded(fn):
        def wrapper(*args, **kwargs):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(torch.Tensor, "__matmul__", recorded(matmul))
    monkeypatch.setattr(torch, "outer", recorded(outer))
    return seen


@pytest.fixture
def tf32_on():
    """The caller has turned TF32 on."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = previous


def _forward_and_backward(fn, inputs, seen):
    """(switch at the forward's products, at the backward's, gradients)."""
    out = fn(*inputs)
    fwd = list(seen)
    seen.clear()
    assert torch.backends.cuda.matmul.allow_tf32
    grads = torch.autograd.grad(out.square().sum(), inputs)
    assert torch.backends.cuda.matmul.allow_tf32
    return fwd, list(seen), grads


def _bf_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    nus = torch.as_tensor(np.linspace(3.0e15, 4.0e14, 300)).to(dtype)
    cutoff = torch.as_tensor(np.array([3.29e15, 8.2e14, 3.65e14, 2.05e14])).to(dtype)
    coeff = torch.as_tensor(rng.uniform(0.5, 2.0, 4) * 1e-17).to(dtype)
    levels = torch.as_tensor(rng.uniform(1.0, 10.0, (4, 12)) * 1e10).to(dtype)
    return nus, levels.requires_grad_(), cutoff, coeff


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bf_product_backward_runs_in_full_float32(tf32_on, products, dtype):
    nus, levels, cutoff, coeff = _bf_inputs(dtype)
    fwd, bwd, (grad,) = _forward_and_backward(
        lambda lv: cont.calc_alpha_bf_hydrogenic(nus, lv, cutoff, coeff), [levels], products)
    assert fwd and bwd and not any(fwd) and not any(bwd)
    ref_levels = levels.detach().clone().requires_grad_()
    ratio = nus[None, :] / cutoff[:, None]
    weighted = coeff[:, None] * (ratio >= 1.0).to(dtype) / ratio**3
    (ref,) = torch.autograd.grad((ref_levels.T @ weighted).square().sum(), [ref_levels])
    assert torch.equal(grad, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_broadening_products_backward_run_in_full_float32(tf32_on, products, dtype):
    rng = np.random.default_rng(1)
    flux = torch.as_tensor(1.0 - 0.5 * np.exp(-np.linspace(-6, 6, 200) ** 2)).to(dtype)
    inputs = [flux.requires_grad_(), torch.tensor(8.0, dtype=dtype, requires_grad=True),
              torch.tensor(2.5, dtype=dtype, requires_grad=True)]

    def broaden(f, v_rot, sigma):
        out = pp.rotation_broadening_torch(1.5, f, v_rot, half_width_pix=12)
        return pp.instrumental_broadening_torch(out, sigma, radius_pix=11)

    fwd, bwd, grads = _forward_and_backward(broaden, inputs, products)
    assert len(fwd) >= 2 and len(bwd) >= 2 and not any(fwd) and not any(bwd)
    assert all(torch.isfinite(g).all() for g in grads)
    a = torch.as_tensor(rng.standard_normal((7, 5))).to(dtype).requires_grad_()
    for shape in ((5,), (5, 3)):
        b = torch.as_tensor(rng.standard_normal(shape)).to(dtype).requires_grad_()
        ours = torch.autograd.grad(full_float32_matmul(a, b).square().sum(), [a, b])
        ref = torch.autograd.grad((a @ b).square().sum(), [a, b])
        assert all(torch.allclose(x, y, rtol=1e-6 if dtype == torch.float32 else 1e-14,
                                  atol=0) for x, y in zip(ours, ref))


def test_switch_holds_across_racing_threads(monkeypatch, tf32_on):
    """The host threads of a mesh over several cards run these products at
    the same time: every product of every thread sees the switch off, and
    the caller's setting is what comes back.  Each product sleeps a
    millisecond, so that the threads' blocks would overlap."""
    import threading
    import time

    seen = []
    matmul = torch.Tensor.__matmul__

    def slow(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        time.sleep(1e-3)
        return matmul(*args)

    monkeypatch.setattr(torch.Tensor, "__matmul__", slow)
    gen = torch.Generator().manual_seed(13)
    a, b = torch.randn(20, 6, generator=gen), torch.randn(6, 30, generator=gen)
    errors = []

    def work():
        try:
            for _ in range(20):
                full_float32_matmul(a, b)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(seen) == 8 * 20 and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32
