"""Kernel 1's output as the measured window's own calls produce it, for
``bench.check``'s ``line_opacity_err`` and ``line_opacity_pixel_err``.

``Kernel1Tap.install`` replaces the program's two Kernel 1 entry points,
``opacities.line_kernel.accumulate_line_opacity_cuda`` and its plain
version, by wrappers that return what they return and, on a call of the
window the tap is armed for, also keep it at the check's pixels: a gather
on the device into a tensor of its own, with no read-back inside the
window.  ``around`` arms it for the driver's calls, a reservoir sample of
``n_calls`` of the window's calls drawn from the seed: whatever the
window's count of calls, each is kept with the same chance, and the kept
ones are copied to the host once the window has closed (``close``).

A record is one launch: (the line set's count of lines, the pixels of the
launch's range among the check's, [B, D, p] float64).  ``assemble`` puts a
call's launches together by line set, matched to the reference's sets by
their counts of lines.  A call whose launches do not cover every set and
pixel once (a program that no longer returns Kernel 1's output through
these entry points, say) assembles to None, which the check reads as inf.
"""

import functools
import inspect
import sys

import numpy as np
import torch

#: the program's entry points of Kernel 1: the CUDA kernel's wrapper and
#: the plain version the CPU runs
ENTRY_POINTS = ("accumulate_line_opacity_cuda", "accumulate_line_opacity_plain")


class Kernel1Tap:
    def __init__(self, pixels, n_calls, rng, n_nu, device, dtype):
        self.pixels = np.asarray(pixels, dtype=np.int64)
        self.n_calls, self.rng = n_calls, rng
        self.ranges = {}  # (device, p_begin, n_out) -> (pixels in range, device index)
        self.sample = []  # the reservoir: the calls kept, one a slot
        self.kept = {}  # call -> [(n_lines, pixels, tensor [B, D, p])]
        self.errors = []
        self.armed = None
        self.saved = []
        # in set-up: the full grid's index on the device as outputs name it
        # ("cuda:0"), and the gather's first launch
        warm = torch.zeros((1, 1, n_nu), dtype=dtype, device=device)
        warm.index_select(-1, self._range(warm.device, 0, n_nu)[1])

    def install(self):
        from stardis_tpu_torch.opacities import line_kernel

        for name in ENTRY_POINTS:
            real = getattr(line_kernel, name)
            self.saved.append((name, real))
            setattr(line_kernel, name, self._wrap(real, name.endswith("_plain")))

    def remove(self):
        from stardis_tpu_torch.opacities import line_kernel

        while self.saved:
            name, real = self.saved.pop()
            setattr(line_kernel, name, real)

    def arm(self, i):
        """Before call i of the window (from 0): keep its launches if the
        reservoir takes it, in place of the call it drops."""
        self.armed = None
        if i < self.n_calls:
            self.sample.append(i)
        else:
            slot = int(self.rng.integers(i + 1))
            if slot >= self.n_calls:
                return
            self.kept.pop(self.sample[slot], None)
            self.sample[slot] = i
        self.kept[i] = []
        self.armed = i

    def disarm(self):
        self.armed = None

    def around(self, driver):
        """``driver`` as the window's loop calls it, the tap armed for each
        call."""
        tap = self

        class Armed:
            def call(self, i, timings=None):
                tap.arm(i)
                try:
                    return driver.call(i, timings)
                finally:
                    tap.disarm()

        return Armed()

    def close(self):
        """Removes the wrappers; returns {"pixels", "calls": {call: records
        on the host}}."""
        self.remove()
        self.armed = None
        for msg in self.errors:
            print(f"kernel1 tap: {msg}", file=sys.stderr)
        calls = {i: [(n, pix, t.double().cpu().numpy()) for n, pix, t in records]
                 for i, records in self.kept.items()}
        self.kept = {}
        return {"pixels": self.pixels, "calls": calls}

    def _range(self, device, p_begin, n_out):
        key = (device, p_begin, n_out)
        if key not in self.ranges:
            pix = self.pixels[(self.pixels >= p_begin) & (self.pixels < p_begin + n_out)]
            self.ranges[key] = pix, torch.as_tensor(pix - p_begin, device=device)
        return self.ranges[key]

    def _wrap(self, real, plain):
        signature = inspect.signature(real)

        @functools.wraps(real)  # keeps the launch counters the real one adds to
        def tapped(*args, **kw):
            out = real(*args, **kw)
            if self.armed is not None:
                try:
                    self._keep(out, signature.bind(*args, **kw), plain)
                except Exception as exc:  # a tap that cannot read keeps nothing
                    self.errors.append(f"call {self.armed}: {exc!r}")
            return out

        return tapped

    def _keep(self, out, bound, plain):
        bound.apply_defaults()
        args = bound.arguments
        if plain:
            if args["alpha"].ndim != 3:  # the plain version's own per-model calls
                return
            n_lines = args["alpha"].shape[1]  # [B, L, D]
        else:
            n_lines = args["prepared"].alpha.shape[2]  # [B, D, L]
        pix, index = self._range(out.device, int(args["p_begin"]), out.shape[-1])
        if len(pix):
            self.kept[self.armed].append((n_lines, pix, out.detach().index_select(-1, index)))


def assemble(records, pixels, sets):
    """A call's launches as {line set: [B, D, P]} at ``pixels``, the sets
    matched by their counts of lines (``sets``: {line set: count}), or None
    where two sets have one count, a set or a pixel of a set is missing or
    held twice, or a launch is left over."""
    by_count = {}
    for n_lines, pix, kappa in records:
        by_count.setdefault(n_lines, []).append((pix, kappa))
    if len(set(sets.values())) != len(sets):
        return None
    out = {}
    for key, count in sets.items():
        launches = by_count.pop(count, [])  # the set's pixel ranges
        pix = np.concatenate([p for p, _k in launches]) if launches else pixels[:0]
        if len(pix) != len(pixels) or not np.array_equal(np.sort(pix), pixels):
            return None
        kappa = np.concatenate([k for _p, k in launches], axis=-1)
        out[key] = kappa[..., np.argsort(pix, kind="stable")]
    return None if by_count else out
