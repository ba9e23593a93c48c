"""Faults planted in the program under test, for the checks' own tests and
``control.py``'s readings of them; the benchmark's runs plant none.

Kernel 1's output scaled where it is produced: on the card where
``accumulate_line_opacity_cuda`` returns it, on the CPU where the plain
version returns each model's sum.  Kernel 1's windows cut where the
profile falls under a share of its peak, in the plain version.  Either
may be planted for the measured window alone (``in_window``), so that only
a check that reads the window's own calls can see it.
"""

import functools

import torch


def in_window(setattr_):
    """A predicate that is true while ``bench.closed_loop`` runs, the
    measured window, and false in set-up and in the check."""
    from portbench import bench

    state = {"open": False}
    real = bench.closed_loop

    @functools.wraps(real)
    def loop(*args, **kw):
        state["open"] = True
        try:
            return real(*args, **kw)
        finally:
            state["open"] = False

    setattr_(bench, "closed_loop", loop)
    return lambda: state["open"]


def scale_kernel1(setattr_, scale, plain=False, when=None):
    """Replace Kernel 1 (``plain``: its plain version) in the program's
    ``opacities.line_kernel`` by one whose output is ``scale`` times the
    real one's, while ``when()`` is true (always without it).
    ``setattr_(module, name, value)`` makes the replacement:
    ``monkeypatch.setattr``, or ``setattr`` for a whole process."""
    from stardis_tpu_torch.opacities import line_kernel

    name = "accumulate_line_opacity_plain" if plain else "accumulate_line_opacity_cuda"
    real = getattr(line_kernel, name)

    @functools.wraps(real)  # keeps the launch counters the real one adds to
    def scaled(*args, **kw):
        out = real(*args, **kw)
        # the plain version sums a batch model by model, through itself
        if (plain and args[3].ndim == 3) or (when is not None and not when()):
            return out
        return out * scale

    setattr_(line_kernel, name, scaled)


def cut_kernel1_wings(setattr_, share=1e-3, when=None):
    """Replace Kernel 1's plain version by one that leaves out every
    (line, depth, pixel) term whose profile is under ``share`` of the
    line's peak at that depth, as windows cut there would, while
    ``when()`` is true (always without it): the wings, which the blanket
    of lines sums at every pixel, go missing."""
    from stardis_tpu_torch.opacities import line_kernel as lk

    real = lk.accumulate_line_opacity_plain

    @functools.wraps(real)
    def cut(grid, line_nu, centers, alpha, gamma, doppler, iw, budget=None, p_begin=0,
            n_out=None):
        if alpha.ndim == 3 or (when is not None and not when()):
            return real(grid, line_nu, centers, alpha, gamma, doppler, iw, budget, p_begin,
                        n_out)
        n_out = grid.shape[0] - p_begin if n_out is None else n_out
        out = torch.zeros((alpha.shape[1], n_out), dtype=alpha.dtype, device=alpha.device)
        for sl, p0, p1, li, di, pi, dnu in lk._window_pairs(grid, line_nu, centers, iw,
                                                            budget, p_begin, p_begin + n_out):
            width, damping = doppler[sl][li, di], gamma[sl][li, di]
            phi = lk._voigt_in_window(dnu, width, damping)
            peak = lk._voigt_in_window(torch.zeros_like(dnu), width, damping)
            phi = torch.where(phi >= share * peak, phi, torch.zeros_like(phi))
            block = torch.zeros((out.shape[0], p1 - p0), dtype=out.dtype, device=out.device)
            block.index_put_((di, pi), phi * alpha[sl][li, di], accumulate=True)
            out[:, p0 - p_begin:p1 - p_begin] += block
        return out

    setattr_(lk, "accumulate_line_opacity_plain", cut)
