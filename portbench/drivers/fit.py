"""Kind ``fit``: gradient fits of one star's parameters, one client, closed
loop: each call is one Adam step.

Set-up writes the configuration's model, builds the program's plan and
device constants once, and draws a pool of targets from the seed: true
parameters (T scale s, v sin i, sigma of the instrument in pixels), each
stratified over the mix's range.  A target's "observed" spectrum is the
program's own forward pass at its true parameters, without gradient, read
to the host: data from then on, one array for the program and the
reference alike.
Set-up then warms up with a few steps.

Call i is step i % steps_per_fit of fit i // steps_per_fit, on target
(i // steps_per_fit) % pool; every fit starts from the mix's ``start``.  A
step goes through the program's public differentiable functions, as a
user's fit does: ``stage_plasma_and_lines`` on T s and n / s with autograd
on, ``stage_spectrum`` (the surface row), ``rotation_broadening_torch`` and
``instrumental_broadening_torch`` on static supports, the division by the
mean, the mean-squared loss against the observed spectrum,
``torch.autograd.grad``, then Adam's update on the card (a learning rate
per parameter, decaying with the step); the loss, the gradient, the new
parameters and the model spectrum are read to the host in one copy, as a
fit's convergence test and its plot read them.

Set-up also draws from the seed one of the window's first
``kernel1b_within`` steps (the first fit, ~2.5 s of the window) at which
the step keeps, for the check, Kernel 1's output, each line set's opacity
[D, N] as ``stage_spectrum`` returns it, and Kernel 1b's input and
outputs: the gradient of the loss with respect to that opacity [D, N], and
with respect to the set's alpha, gamma and doppler widths [L, D].  Hooks on
the tensors that ``stage_spectrum`` and ``stage_plasma_and_lines`` return
take the gradients during the step's own backward; all are copied to the
host once the window has closed.

The observed spectra are the program's own: the check compares the
sampled step's target's with the reference's at its true parameters, so
a fault in them does not hide behind both sides' use of one array.

``check`` compares sampled steps with ``reference.fit``: the model spectrum
and the target's observed spectrum, the gradient, each component weighted
by its parameter's range, and Kernels 1's and 1b's outputs at the kept
step.
"""

import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import bench, inputs
from portbench.reference import fit as reference_fit

#: speed of light [km/s]
C_KMS = 299792.458
#: the fitted parameters, each with its range of true values in the mix
PARAMS = ("t_scale", "v_sin_i_kms", "sigma_pix")
#: pixels at which the check compares the kept step's line opacity, as
#: many as the spectrum cells' ``check_pixels``
KAPPA_PIXELS = 1024


def velocity_per_pixel(lambdas_aa):
    """The velocity width of one pixel [km/s] of a uniform wavelength grid,
    at its mean wavelength."""
    return float((lambdas_aa[1] - lambdas_aa[0]) / np.mean(lambdas_aa) * C_KMS)


class Driver:
    def __init__(self, ctx):
        from stardis_tpu_torch import units as u
        from stardis_tpu_torch.base import parse_config_to_model
        from stardis_tpu_torch.pipeline import build_simulation_plan, device_constants

        self.ctx, mix = ctx, ctx.mix
        dev, dtype = ctx.device, ctx.dtype
        self.template_path = inputs.write_model(ctx.config, ctx.tmp / "model.mod")
        cfg = inputs.stardis_config(ctx.config, self.template_path, ctx.tables)
        config, adata, model = parse_config_to_model(cfg, atom_data=ctx.adata)
        nus = u.Quantity(ctx.lambdas, u.AA).to(u.Hz, u.spectral()).value
        self.plan = build_simulation_plan(config, adata, model, nus)
        self.consts = device_constants(self.plan, dtype, dev)
        self.temps0 = torch.as_tensor(self.plan.temperatures, device=dev).to(dtype)
        self.n_elem0 = torch.as_tensor(self.plan.n_elem, device=dev).to(dtype)
        self.vel_pix = velocity_per_pixel(ctx.lambdas)
        self.steps = mix["steps_per_fit"]
        self.start = torch.tensor(mix["start"], dtype=dtype, device=dev)
        self.lr = torch.tensor(mix["lr"], dtype=dtype, device=dev)
        self.truth = np.stack([bench.stratified(ctx.rng, mix["pool"], *mix[k])
                               for k in PARAMS], 1)
        with torch.no_grad():
            self.observed = [self.spectrum(torch.tensor(t, dtype=dtype, device=dev))
                             for t in self.truth]
        self.observed_host = [o.cpu().numpy() for o in self.observed]
        kernel1b_rng = np.random.default_rng(bench.seed_words(ctx.seed, 2))
        self.keep_at, self.kept = int(kernel1b_rng.integers(mix["kernel1b_within"])), None
        for k in range(mix["warmup_steps"]):
            self.step(0, k)

    def spectrum(self, params, keep=None):
        """The broadened surface spectrum over its mean at (s, v sin i,
        sigma), through the program's public functions; with ``keep`` (a
        dict), Kernel 1b's input and outputs go there in the backward."""
        from stardis_tpu_torch.pipeline import stage_plasma_and_lines, stage_spectrum
        from stardis_tpu_torch.postprocessing import (
            instrumental_broadening_torch,
            rotation_broadening_torch,
        )

        mix, plan, consts = self.ctx.mix, self.plan, self.consts
        s, v_sin_i, sigma = params[0], params[1], params[2]
        state, lq = stage_plasma_and_lines(plan, self.temps0 * s, self.n_elem0 / s, consts)
        f_nu, _total, opacities, _i_nus = stage_spectrum(plan, state, lq, consts)
        if keep is not None:
            keep_line_gradients(lq, opacities, keep)
        surface = f_nu[-1]
        out = rotation_broadening_torch(self.vel_pix, surface, v_sin_i,
                                        half_width_pix=mix["half_width_pix"])
        out = instrumental_broadening_torch(out, sigma, radius_pix=mix["radius_pix"])
        return out / out.mean()

    def step(self, target, k, timings=None, keep=None):
        """Step k of a fit of ``target``: {"params" before the step, "loss",
        "grad", the "model" spectrum}, host arrays; ``keep`` as
        ``spectrum``'s."""
        mix = self.ctx.mix
        if k == 0:
            self.params = self.start.clone()
            self.before = self.start.double().cpu().numpy()
            self.m = torch.zeros_like(self.start)
            self.v = torch.zeros_like(self.start)
        before = self.before
        sync = (torch.cuda.synchronize if timings is not None and self.ctx.device.type == "cuda"
                else lambda: None)
        p = self.params.clone().requires_grad_()
        sync()
        t0 = time.perf_counter()
        with record_function("portbench.fit_forward"):
            model = self.spectrum(p, keep)
            loss = torch.mean((model - self.observed[target]) ** 2)
        sync()
        t1 = time.perf_counter()
        with record_function("portbench.fit_backward"):
            (g,) = torch.autograd.grad(loss, p)
        sync()
        if timings is not None:
            timings["fit_forward"], timings["fit_backward"] = t1 - t0, time.perf_counter() - t1
        with record_function("portbench.adam"), torch.no_grad():
            b1, b2 = mix["betas"]
            self.m.mul_(b1).add_(g, alpha=1.0 - b1)
            self.v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            m_hat = self.m / (1.0 - b1 ** (k + 1))
            v_hat = self.v / (1.0 - b2 ** (k + 1))
            rate = self.lr / (1.0 + mix["lr_decay"] * k)
            self.params = self.params - rate * m_hat / (torch.sqrt(v_hat) + mix["eps"])
        with record_function("portbench.readback"):
            host = torch.cat([loss.detach()[None], g, self.params, model.detach()]).cpu().numpy()
        self.before = host[4:7].astype(np.float64)
        return {"params": before, "loss": float(host[0]), "grad": host[1:4].astype(np.float64),
                "model": host[7:]}

    def call(self, i, timings=None):
        fit, k = divmod(i, self.steps)
        target = fit % len(self.observed)
        keep = {} if i == self.keep_at else None
        answer = self.step(target, k, timings, keep)
        answer.update(target=target, truth=self.truth[target], step=k,
                      observed=self.observed_host[target], vel_pix=self.vel_pix)
        if keep is not None:
            self.kept = {"call": i, "path": self.template_path, "params": answer["params"],
                         "lines": keep}
        return [((self.template_path, float(answer["params"][0])), answer)]

    def close(self):
        """Frees the program's state; returns the kept step with its line
        opacities and gradients as host arrays ([D, N] and [L, D]), or
        None."""
        kept = self.kept
        if kept is not None:
            kept["lines"] = {key: {name: g.reshape(g.shape[-2:]).cpu().numpy()
                                   for name, g in entry.items()}
                             for key, entry in kept["lines"].items()}
        del self.plan, self.consts, self.observed, self.params, self.m, self.v, self.kept
        return kept


def keep_line_gradients(quants, opacities, store):
    """Kernel 1's output, each line set's opacity as the step computed it,
    into ``store[line set]["opacity"]``, and hooks that put there, when the
    backward reaches them, Kernel 1b's input, the gradient with respect to
    that opacity ("kappa"), and its outputs, the gradients with respect to
    its alpha, gamma and doppler."""
    from stardis_tpu_torch.pipeline import LINE_SETS

    def keeper(entry, name):
        def hook(grad):
            entry[name] = grad.detach().clone()
        return hook

    for key, label in LINE_SETS:
        if key not in (quants or {}):
            continue
        entry = store.setdefault(key, {})
        kappa = opacities[label]  # a view of the tensor the total opacity sums
        entry["opacity"] = kappa.detach().clone()
        (kappa if kappa._base is None else kappa._base).register_hook(keeper(entry, "kappa"))
        for name, tensor in zip(("alpha", "gamma", "doppler"), quants[key]):
            tensor.register_hook(keeper(entry, name))


def reference_model(ref, key):
    """The reference's model of a call's key (path, s): temperatures times
    s and densities over s, as the step scales them (``bench.run`` counts
    the traced window's Kernel 1 and 1b work on it)."""
    return reference_fit.scaled_model(ref, *key)


def check(ref, answers, mix, seed, n_nu, kept=None, control=None):
    """The check of ``correct`` for fits, against ``reference.fit`` in
    float64.  Returns {number: value}:

    * ``fit_model_err``: the largest |x - x_ref| over every pixel of the
      model spectrum x of ``check_steps`` steps of the window drawn from
      the seed (the broadened surface F_nu over its mean, at the
      parameters each step started from) and of its target's observed
      spectrum (at the target's true parameters);
    * ``fit_grad_rel_err``: the largest max_k |(g_k - g*_k) r_k| over
      max_k |g*_k r_k| of those steps, with r the ranges of the true
      parameters (a component near zero at a fit's optimum does not decide
      it alone) and g* = J_ref^T (2 / N) (m - observed): the reference's
      Jacobian of the model applied to the step's own residual, whose two
      terms the first number compares;
    * ``kernel1b_grad_err``: Kernel 1b's outputs at the kept step
      (``Driver.close``): on ``kernel1b_lines`` lines of each line
      set drawn from the seed among those whose windows reach the grid,
      the gradients in alpha, gamma and doppler against the reference's
      (autograd through its line sum at its own line quantities and
      windows for the step's parameters), both fed the program's gradient
      in the line opacity at that step; for each of the three the largest
      |g - g_ref| over the largest |g_ref|, and the largest of the three;
    * ``line_opacity_err``: Kernel 1's output at the kept step, each line
      set's opacity at every depth, against the reference's line sum at
      ``KAPPA_PIXELS`` pixels drawn from the seed (``line_opacity_err``).

    The loss itself is not compared: a fit's residual is a difference of
    nearly equal spectra, which float32 holds to a few per cent only.
    With a ``control`` reference, its model spectra and gradients at the
    same steps take the program's place; its gradient is read in v sin i
    and sigma only, since bfloat16 holds T s and T (s +- fd_step) alike
    and its difference in s is 0."""
    rng = np.random.default_rng(bench.seed_words(seed, 1))
    done = [i for i, out in enumerate(answers) if out is not None]
    picked = sorted(rng.choice(len(done), size=min(mix["check_steps"], len(done)),
                               replace=False)) if done else []
    failed = dict.fromkeys(("fit_model_err", "fit_grad_rel_err", "kernel1b_grad_err",
                            "line_opacity_err"), float("inf"))
    if not picked:
        return failed
    ranges = np.array([hi - lo for lo, hi in (mix[k] for k in PARAMS)])
    components = slice(0, 3) if control is None else slice(1, 3)
    model_err = grad_err = 0.0
    for j in picked:
        ((path, _s), ans), = answers[done[j]]
        sizes = (ans["vel_pix"], mix["half_width_pix"], mix["radius_pix"])
        args = (path, ans["params"], ans["observed"], *sizes, mix["fd_step"])
        m_ref, _g, vjp = reference_fit.step(ref, *args)
        m, g = ((np.asarray(ans["model"], np.float64), ans["grad"]) if control is None
                else reference_fit.step(control, *args)[:2])
        obs_ref = reference_fit.model_at(ref, path, ans["truth"], *sizes)
        obs = (np.asarray(ans["observed"], np.float64) if control is None
               else reference_fit.model_at(control, path, ans["truth"], *sizes))
        g_star = vjp(2.0 / len(m) * (m - np.asarray(ans["observed"], np.float64)))
        scale = np.max(np.abs(g_star * ranges))
        off = np.max(np.abs((g - g_star) * ranges)[components])
        errs = (max(np.max(np.abs(m - m_ref)), np.max(np.abs(obs - obs_ref))), off / scale)
        print(f"fit check: call {done[j]} (step {ans['step']} of a fit): "
              f"max|g* r| {scale!r}, max|(g - g*) r| {off!r}", file=sys.stderr)
        if not all(np.isfinite(errs)):
            return failed
        model_err, grad_err = max(model_err, float(errs[0])), max(grad_err, float(errs[1]))
    return {"fit_model_err": model_err, "fit_grad_rel_err": grad_err,
            "kernel1b_grad_err": kernel1b_err(ref, kept, mix, seed, control),
            "line_opacity_err": line_opacity_err(ref, kept, seed, control)}


def line_opacity_err(ref, kept, seed, control=None):
    """``check``'s ``line_opacity_err``: Kernel 1's output at the kept step,
    each line set's opacity at every depth, the program's (or with a
    ``control`` the control's) against ``ref``'s line sum for the step's
    model, at ``KAPPA_PIXELS`` pixels drawn from the seed, both ends of the
    grid among them (``bench.line_opacity_err``)."""
    if not kept or not kept["lines"]:
        return float("inf")
    pixels = bench.draw_pixels(np.random.default_rng(bench.seed_words(seed, 4)),
                               KAPPA_PIXELS, ref.consts.grid.shape[0])
    model = reference_fit.scaled_model(ref, kept["path"], kept["params"][0])
    want = ref.line_sums([model], pixels)
    ours = ({key: entry["opacity"][None][..., pixels] for key, entry in kept["lines"].items()}
            if control is None else control.line_sums([model], pixels))
    return bench.line_opacity_err(ours, want)


def kernel1b_err(ref, kept, mix, seed, control=None):
    """``check``'s ``kernel1b_grad_err``: Kernel 1b's outputs at the kept
    step, the program's, or with a ``control`` the control's, against
    ``ref``'s."""
    if not kept or not kept["lines"]:
        return float("inf")
    rng = np.random.default_rng(bench.seed_words(seed, 3))
    model = reference_fit.scaled_model(ref, kept["path"], kept["params"][0])
    kappa = {key: entry["kappa"] for key, entry in kept["lines"].items()}
    lines = {}

    def pick(key, reach):
        lines[key] = np.sort(rng.choice(np.flatnonzero(reach),
                                        size=min(mix["kernel1b_lines"], int(reach.sum())),
                                        replace=False))
        return lines[key]

    want = reference_fit.line_gradients(ref, model, kappa, pick)
    if control is None:
        got = {key: tuple(np.asarray(kept["lines"][key][name], np.float64)[lines[key]]
                          for name in ("alpha", "gamma", "doppler"))
               for key in want}
    else:
        got = reference_fit.line_gradients(control, model, kappa, lambda key, _r: lines[key])
    worst = 0.0
    for key, triple in want.items():
        for g_ref, g in zip(triple, got[key]):
            scale = np.max(np.abs(g_ref))
            err = (np.max(np.abs(g - g_ref)) / scale if scale > 0
                   else 0.0 if not np.any(g) else np.inf)
            worst = max(worst, float(err) if np.isfinite(err) else float("inf"))
    return worst
