"""Kind ``batch``: a grid of atmospheres in batches, closed loop.

Set-up writes a pool of models drawn from the seed (Teff stratified over
the mix's range; the radius and the rest as the configuration's model
has them), reads them with the program's reader, builds the template
plan once (``make_batch`` on the configuration's template model) and
warms up ``run_batch`` at the batch size, which captures its stage-1
graph. Each call then does what a grid scan does for a chunk:
``collect_batch_inputs`` of the next models (their file cross-sections,
molecular rows, densities and geometry, on the host) and ``run_batch``,
then reads the surface spectra back. Batches take the pool in a new
seeded order each time round, eight distinct models a batch.
"""

import time

import numpy as np
from torch.profiler import record_function

from portbench import bench, inputs


class Driver:
    def __init__(self, ctx):
        from stardis_tpu_torch import units as u
        from stardis_tpu_torch.base import parse_config_to_model, read_stellar_model
        from stardis_tpu_torch.parallel import batch as batch_mod

        self.ctx, self.batch_mod = ctx, batch_mod
        mix = ctx.mix
        self.per_call = mix["models_per_call"]
        n_pool = mix["pool"]
        teffs = bench.stratified(ctx.rng, n_pool, *mix["teff"])
        self.paths = [inputs.write_model(ctx.config, ctx.tmp / f"giant{i}.mod", teff=float(t))
                      for i, t in enumerate(teffs)]
        self.template_path = inputs.write_model(ctx.config, ctx.tmp / "template.mod")
        cfg = inputs.stardis_config(ctx.config, self.template_path, ctx.tables)
        self.config, adata, template = parse_config_to_model(cfg, atom_data=ctx.adata)
        self.models = [read_stellar_model(self.config, adata, p) for p in self.paths]
        nus = u.Quantity(ctx.lambdas, u.AA).to(u.Hz, u.spectral()).value
        self.plan, _ = batch_mod.make_batch(self.config, adata, [template], nus)
        self.order = np.concatenate([ctx.rng.permutation(n_pool) for _ in range(4096)])
        for i in range(2):  # captures the batch's stage-1 graph, then runs it
            self.call(-1 - i)

    def members(self, i):
        """Pool indices of call i (warm-up calls are negative)."""
        i = i % (len(self.order) // self.per_call)
        return self.order[i * self.per_call:(i + 1) * self.per_call]

    def call(self, i, timings=None):
        idx = self.members(i)
        t0 = time.perf_counter()
        with record_function("portbench.collect_batch_inputs"):
            batch = self.batch_mod.collect_batch_inputs(self.config,
                                                        [self.models[j] for j in idx],
                                                        self.plan)
        if timings is not None:
            timings["collect_batch_inputs"] = time.perf_counter() - t0
        with record_function("portbench.run_batch"):
            f_nu = self.batch_mod.run_batch(self.plan, batch, device=self.ctx.device,
                                            dtype=self.ctx.dtype, timings=timings)
        with record_function("portbench.readback"):
            surface = f_nu[:, -1].cpu().numpy()
        return [((self.paths[j], 1.0), s) for j, s in zip(idx, surface)]

    def close(self):
        del self.plan, self.models
