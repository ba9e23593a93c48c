"""Kind ``serve``: one client sends requests to a ``SpectralService`` and
waits for each spectrum (closed loop).

Set-up writes the configuration's model, builds the service (its plan,
device constants and captured stage 1) and warms it up with four requests.
Request i is ``synthesize`` of that model with its temperatures scaled by
a factor drawn from the seed (stratified over the mix's range in blocks of
64, so no two requests are alike); its wall runs from the call to the
surface spectrum in hand.
"""

import copy

import numpy as np
from torch.profiler import record_function

from portbench import bench, inputs

#: warm-up calls in set-up
WARMUP_CALLS = 4

BLOCK = 64


class Driver:
    def __init__(self, ctx):
        from stardis_tpu_torch import units as u
        from stardis_tpu_torch.base import read_stellar_model
        from stardis_tpu_torch.serving import SpectralService

        self.ctx = ctx
        self.template_path = inputs.write_model(ctx.config, ctx.tmp / "model.mod")
        cfg = inputs.stardis_config(ctx.config, self.template_path, ctx.tables)
        self.service = SpectralService(cfg, u.Quantity(ctx.lambdas, u.AA),
                                       device=ctx.device, dtype=ctx.dtype,
                                       atom_data=ctx.adata)
        self.base = read_stellar_model(self.service.config, self.service.atom_data,
                                       self.template_path)
        lo, hi = ctx.mix["t_scale"]
        self.scales = np.concatenate([bench.stratified(ctx.rng, BLOCK, lo, hi)
                                      for _ in range(1024)])
        for i in range(WARMUP_CALLS):
            self.call(-1 - i)

    def scale(self, i):
        return float(self.scales[i % len(self.scales)])

    def call(self, i, timings=None):
        s = self.scale(i)
        model = copy.copy(self.base)
        model.temperatures = self.base.temperatures * s
        with record_function("portbench.synthesize"):
            out = self.service.synthesize(model)
        return [((self.template_path, s), out["spectrum_nu"])]

    def close(self):
        del self.service
