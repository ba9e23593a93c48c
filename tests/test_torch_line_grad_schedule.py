"""Kernel 1b's schedule (``line_kernel.line_grad_schedule``) on the CPU.

The kernel (csrc/line_opacity_grad.cu) cuts each (model, depth)'s lines into
tiles of LINE_GRAD_TILE, each tile's union window span into splits, and adds
a line's split sums in split order in its second pass.  These tests hold the
schedule, which torch ops build, to the plain version's enumeration of the
in-window (model, depth, line, pixel) quadruples (``_window_pairs``): every
one covered exactly once, whole grid and range; and a split line's sums
added in the kernel's order give the plain backward's gradients.  The
kernel's division-light region-I arithmetic is held to
``voigt.faddeeva_real_region1_grad`` and, for the far-wing combination
Re w + x dRe w/dx + y dRe w/dy, to extended precision."""

import math

import numpy as np
import pytest
import torch

from stardis_tpu_torch.opacities import line_kernel as tlk
from stardis_tpu_torch.opacities import voigt as tvoigt

N_NU = 3000
CHUNK = tlk.line_grad_chunk(torch.float64)  # 1024 pixels


def _inputs(n_models=2, n_lines=300, n_depth=4, seed=0):
    """A sorted line set over a descending grid, half-windows from 1 pixel to
    beyond the grid, in the prepared [B, D, L] layout and the plain [B, L, D]
    one."""
    rng = np.random.default_rng(seed)
    nus = np.linspace(4.6e14, 4.5e14, N_NU)
    line_nu = np.sort(rng.uniform(4.49e14, 4.61e14, n_lines))[::-1].copy()
    doppler = rng.uniform(1e9, 5e9, (n_models, n_lines, n_depth))
    gamma = rng.uniform(1e8, 2e9, (n_models, n_lines, n_depth))
    alpha = rng.uniform(0.1, 1.0, (n_models, n_lines, n_depth))
    iw = rng.choice([1, 2, 3, 10, 80, 600, N_NU + 1], size=(n_models, n_lines, n_depth),
                    p=[0.1, 0.1, 0.1, 0.3, 0.2, 0.1, 0.1])
    nu_ref = float(nus[N_NU // 2])
    t = torch.as_tensor
    centers = t(tlk.line_center_indices(nus, line_nu))
    plain = (t(nus - nu_ref), t(line_nu - nu_ref), centers, t(alpha), t(gamma), t(doppler),
             t(iw, dtype=torch.int32))
    return plain, t(iw, dtype=torch.int32).transpose(1, 2).contiguous()


def _split_bounds(sched):
    """[lo, hi) of every split, in unit order, and its tile."""
    tile = sched.unit_tile.long()
    split = torch.arange(sched.n_units) - sched.tile_start[tile].long()
    lo = sched.tile_lo[tile].long() + split * sched.split_pixels
    hi = torch.minimum(lo + sched.split_pixels, sched.tile_hi[tile].long())
    return lo, hi, tile


def _covered(sched, iw_bdl, centers, p_begin, n_out):
    """How many splits cover each in-window pixel of each pair: [B, D, L]
    counts of (split, pixel) hits, and the pairs' window lengths."""
    n_models, n_depth, n_lines = iw_bdl.shape
    lo, hi = tlk.pair_windows(centers, iw_bdl, N_NU, p_begin, n_out)
    length = torch.clamp(hi - lo, min=0).reshape(-1, n_lines)
    s_lo, s_hi, tile = _split_bounds(sched)
    hits = torch.zeros_like(length)
    bd, t = tile // sched.n_tiles, tile % sched.n_tiles
    for j in range(tlk.LINE_GRAD_TILE):
        line = t * tlk.LINE_GRAD_TILE + j
        ok = line < n_lines
        b_, l_ = bd[ok], line[ok]
        a = torch.maximum(s_lo[ok], lo.reshape(-1, n_lines)[b_, l_])
        b = torch.minimum(s_hi[ok], hi.reshape(-1, n_lines)[b_, l_])
        hits.index_put_((b_, l_), torch.clamp(b - a, min=0), accumulate=True)
    return hits, length


@pytest.mark.parametrize("max_splits", [1 << 19, 7], ids=["chunk_splits", "wide_splits"])
@pytest.mark.parametrize("p_begin, n_out", [(0, N_NU), (900, 1300)], ids=["whole", "range"])
def test_schedule_covers_each_in_window_pixel_once(monkeypatch, max_splits, p_begin, n_out):
    monkeypatch.setattr(tlk, "LINE_GRAD_MAX_SPLITS", max_splits)
    (grid, line_nu, centers, alpha, gamma, doppler, iw), iw_bdl = _inputs()
    sched = tlk.line_grad_schedule(centers, iw_bdl, N_NU, p_begin, n_out, CHUNK)
    assert sched.split_pixels % CHUNK == 0
    if max_splits < 1 << 19:
        assert sched.split_pixels > CHUNK
    s_lo, s_hi, tile = _split_bounds(sched)
    # splits are numbered tile by tile, each nonempty, inside the range,
    # and a tile's splits tile its span in increasing pixel order
    assert bool((tile[1:] >= tile[:-1]).all()) and bool((s_hi > s_lo).all())
    assert bool((s_lo >= p_begin).all()) and bool((s_hi <= p_begin + n_out).all())
    same = tile[1:] == tile[:-1]
    assert bool((s_lo[1:][same] == s_hi[:-1][same]).all())
    first = sched.tile_start[:-1].long()
    has = sched.tile_start[1:] > sched.tile_start[:-1]
    assert bool((s_lo[first[has]] == sched.tile_lo.long()[has]).all())
    last = sched.tile_start[1:].long() - 1
    assert bool((s_hi[last[has]] == sched.tile_hi.long()[has]).all())
    # every in-window pixel of every pair covered exactly once
    hits, length = _covered(sched, iw_bdl, centers, p_begin, n_out)
    assert torch.equal(hits, length)
    assert int(length.sum()) > 0
    # and the pairs' windows are the plain version's in-window pixels
    counts = torch.zeros((alpha.shape[0], alpha.shape[1], alpha.shape[2]), dtype=torch.int64)
    for b in range(alpha.shape[0]):
        for sl, _p0, _p1, li, di, _pi, _dnu in tlk._window_pairs(
                grid, line_nu, centers, iw[b], None, p_begin, p_begin + n_out):
            counts[b].index_put_((li + sl.start, di), torch.ones_like(li), accumulate=True)
    assert torch.equal(counts.transpose(1, 2).reshape(-1, alpha.shape[1]), length)


def _region1_one_division(x, y):
    """The kernel's region-I arithmetic (csrc/line_opacity_grad.cu:region1):
    sqrt(pi) (Re w, dRe w/dy, Re w + x dRe w/dx + y dRe w/dy) from one
    reciprocal of |a|^2, a = z^2 - 1/2: q = 1/a, sqrt(pi) w = i z q,
    sqrt(pi) dw/dz = -i (q + q^2), the last value Im(z q^2)."""
    ar, ai = x * x - (y * y + 0.5), x * (2 * y)
    r = 1 / (ar * ar + ai * ai)
    qr, qi = ar * r, -ai * r
    q2r, q2i = qr * qr - qi * qi, 2 * qr * qi
    return -(x * qi + y * qr), qr + q2r, x * q2i + y * q2r


def _emulated_backward(grad, plain_args, iw_bdl, p_begin, n_out):
    """Kernel 1b's two passes on the CPU in float64: per split, each line's
    sums over its window within the split (the plain version's values of
    Re w and its derivatives); then per line its tile's split sums added in
    split order, and the plain finish."""
    grid, line_nu, centers, alpha, gamma, doppler, _ = plain_args
    n_models, n_depth, n_lines = iw_bdl.shape
    sched = tlk.line_grad_schedule(centers, iw_bdl, N_NU, p_begin, n_out, CHUNK)
    lo, hi = tlk.pair_windows(centers, iw_bdl, N_NU, p_begin, n_out)
    s_lo, s_hi, tile = _split_bounds(sched)
    scratch = torch.zeros((sched.n_units, 3, tlk.LINE_GRAD_TILE), dtype=torch.float64)
    dop_bdl, gam_bdl = doppler.transpose(1, 2), gamma.transpose(1, 2)
    for u in range(sched.n_units):
        f = int(tile[u])
        bd, t = divmod(f, sched.n_tiles)
        b, d = divmod(bd, n_depth)
        for j in range(tlk.LINE_GRAD_TILE):
            line = t * tlk.LINE_GRAD_TILE + j
            if line >= n_lines:
                continue
            a = max(int(s_lo[u]), int(lo[b, d, line]))
            e = min(int(s_hi[u]), int(hi[b, d, line]))
            if a >= e:
                continue
            dop = dop_bdl[b, d, line]
            x = (grid[a:e] - line_nu[line]) / dop
            y = gam_bdl[b, d, line] / (tvoigt.SQRT_PI * tvoigt.PI) / dop
            re, wy, wd = tlk._faddeeva_grad_in_window(x, y.expand_as(x).clone())
            g = grad[b, d, a - p_begin:e - p_begin]
            scratch[u, :, j] = torch.stack([(g * re).sum(), (g * wy).sum(), (g * wd).sum()])
    sums = torch.zeros((3, n_models * n_depth, n_lines), dtype=torch.float64)
    for f in range(len(sched.tile_lo)):
        bd, t = divmod(f, sched.n_tiles)
        width = min(tlk.LINE_GRAD_TILE, n_lines - t * tlk.LINE_GRAD_TILE)
        for u in range(int(sched.tile_start[f]), int(sched.tile_start[f + 1])):
            sums[:, bd, t * tlk.LINE_GRAD_TILE:t * tlk.LINE_GRAD_TILE + width] += \
                scratch[u, :, :width]
    s_w, s_y, s_d = (s.reshape(n_models, n_depth, n_lines).transpose(1, 2) for s in sums)
    return tlk._line_grad_finish(s_w, s_y, s_d, alpha, doppler)


@pytest.mark.parametrize("p_begin, n_out", [(0, N_NU), (900, 1300)], ids=["whole", "range"])
def test_split_sums_in_kernel_order_match_plain_backward(p_begin, n_out):
    plain_args, iw_bdl = _inputs(n_models=2, n_lines=70, n_depth=3, seed=1)
    grad = torch.as_tensor(np.random.default_rng(2).normal(size=(2, 3, n_out)))
    ours = _emulated_backward(grad, plain_args, iw_bdl, p_begin, n_out)
    grid, line_nu, centers, alpha, gamma, doppler, iw = plain_args
    ref = tlk.accumulate_line_opacity_plain_backward(grad, grid, line_nu, centers, alpha, gamma,
                                                     doppler, iw, p_begin=p_begin, n_out=n_out)
    for o, r in zip(ours, ref):
        scale = r.abs().amax(dim=1, keepdim=True)  # each (model, depth)'s largest
        assert bool(((o - r).abs() <= 1e-12 * scale).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_region1_one_division_matches_plain(dtype):
    """The kernel's region-I arithmetic and the plain backward's
    (``faddeeva_real_region1_grad_euler``): Re w and dRe w/dy against the
    plain derivative ``faddeeva_real_region1_grad`` (float64), the far-wing
    combination Re w + x dRe w/dx + y dRe w/dy against the same formula in
    extended precision; 1e-13 relative in float64 (Re w, dRe w/dy held to
    1e-13 of |dRe w/dy| + |Re w| / |x| near dRe w/dy's sign change), 1e-5
    in float32 (1e-3 for the combination, where it changes sign), finite
    and nonzero far into the wing (|x| to 1e7), where the plain float32
    quotient sqrt(pi) |z^2 - 1/2|^4 overflows.  The combination summed term
    by term in float64 loses digits there."""
    rng = np.random.default_rng(3)
    n = 20000
    x = np.concatenate([rng.uniform(-300, 300, n),
                        10 ** rng.uniform(1, 7, n) * rng.choice([-1, 1], n)])
    y = 10 ** rng.uniform(-4, 2, 2 * n)
    keep = np.abs(x) + y > 15
    x, y = x[keep], y[keep]
    z = (x.astype(np.longdouble) + 1j * y.astype(np.longdouble)).astype(np.clongdouble)
    q = 1 / (z * z - 0.5)
    exact = np.imag(z * q * q) / np.sqrt(np.longdouble(np.pi))  # Re(w + z w')
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    ref = tvoigt.faddeeva_real_region1_grad(x, y)
    sq = math.sqrt(math.pi)
    kernel = [v.double() / sq for v in _region1_one_division(x.to(dtype), y.to(dtype))]
    plain = [v.double() for v in tvoigt.faddeeva_real_region1_grad_euler(x.to(dtype),
                                                                          y.to(dtype))]
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    scale = torch.maximum(ref[2].abs(), ref[0].abs() / x.abs())
    for ours in (kernel, plain):
        assert all(bool(torch.isfinite(v).all()) and bool((v != 0).all()) for v in ours)
        assert bool(((ours[0] - ref[0]).abs() <= tol * ref[0].abs()).all())
        assert bool(((ours[1] - ref[2]).abs() <= tol * scale).all())
        err = np.abs(ours[2].numpy() - exact) / np.abs(exact)
        assert float(err.max()) <= (tol if dtype == torch.float64 else 1e-3)
    if dtype == torch.float64:
        summed = (ref[0] + x * ref[1] + y * ref[2]).numpy()
        assert float((np.abs(summed - exact) / np.abs(exact)).max()) > 1e-6
    far = x.abs() > 1e5
    assert bool(far.any())
    old = tvoigt.faddeeva_real_region1_grad(x[far].float(), y[far].float())
    assert bool((old[1] == 0).all())  # the plain float32 form loses the wing


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_region2_combination_closed_form(dtype):
    """Re w + x dRe w/dx + y dRe w/dy of the region-II rational in closed
    form (``faddeeva_real_region2_euler``, the formula Kernel 1b's core_grad
    uses) against the rational evaluated in extended precision, relative to
    the size of the closed form's terms, |z| (|c5| |z|^4 + |c3| |z|^2 + |c1|)
    / |D|^2 (the combination itself changes sign in this region): 1e-13 in
    float64, 1e-5 in float32, where the three values summed term by term
    cancel by ~|z|^2 and miss by more than that."""
    rng = np.random.default_rng(4)
    n = 20000
    x = rng.uniform(-15, 15, n)
    y = rng.uniform(0, 15, n)
    keep = (np.abs(x) + y > 5.5) & (np.abs(x) + y <= 15)
    x, y = x[keep], y[keep]
    z = (x.astype(np.longdouble) + 1j * y.astype(np.longdouble)).astype(np.clongdouble)
    sq, k = np.sqrt(np.longdouble(np.pi)), np.longdouble(1.4104739589)
    num, den = 1j * z * (z * z / sq - k), z ** 4 - 3 * z * z + np.longdouble(0.75)
    w = num / den
    dw = (1j * (3 * z * z / sq - k) - w * (4 * z ** 3 - 6 * z)) / den
    exact = np.real(w + z * dw)
    r = np.abs(z)
    scale = r * (np.abs(2 * k - 6 / sq) * r ** 4 + 3 / sq * r ** 2 + 1.5 * k) / np.abs(den) ** 2
    xt, yt = torch.as_tensor(x).to(dtype), torch.as_tensor(y).to(dtype)
    ours = tvoigt.faddeeva_real_region2_euler(xt, yt).double().numpy()
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    assert float((np.abs(ours - exact) / scale).max()) <= tol
    if dtype == torch.float32:
        re, wx, wy = tvoigt.faddeeva_real_grad(xt, yt)
        summed = (re + xt * wx + yt * wy).double().numpy()
        assert float((np.abs(summed - exact) / scale).max()) > tol
