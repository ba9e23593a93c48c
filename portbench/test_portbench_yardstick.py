"""The frozen in-window evaluation count equals a brute-force count of the
window mask by Humlicek region, and its torch form equals it."""

import numpy as np
import torch

from portbench import yardstick


def brute_force(nus, line_nu, centers, gamma, doppler, iw):
    counts = dict.fromkeys(yardstick.REGIONS, 0)
    p = np.arange(len(nus))
    for l in range(len(line_nu)):
        for d in range(iw.shape[1]):
            inside = (p - centers[l] >= -iw[l, d]) & (p - centers[l] < iw[l, d])
            x = np.abs(nus[inside] - line_nu[l]) / doppler[l, d]
            y = gamma[l, d] / (np.sqrt(np.pi) * np.pi) / doppler[l, d]
            s = x + y
            counts["I"] += int((s > 15.0).sum())
            counts["II"] += int(((s <= 15.0) & (s > 5.5)).sum())
            core = s <= 5.5
            counts["III"] += int((core & (x <= (y + 0.176) / 0.195)).sum())
            counts["IV"] += int((core & (x > (y + 0.176) / 0.195)).sum())
    return counts


def case(seed=3, n=400, lines=60, depths=5):
    rng = np.random.default_rng(seed)
    nus = np.sort(rng.uniform(4.5e14, 4.6e14, n))[::-1].copy()
    line_nu = np.sort(rng.uniform(4.49e14, 4.61e14, lines))[::-1].copy()
    asc = nus[::-1]
    centers = (n - np.searchsorted(asc, line_nu)).astype(np.int64)
    step = (nus[0] - nus[-1]) / n
    doppler = rng.uniform(0.5, 30.0, (lines, depths)) * step
    gamma = rng.uniform(0.0, 40.0, (lines, depths)) * step
    iw = rng.integers(0, 120, (lines, depths))
    return nus, line_nu, centers, gamma, doppler, iw


def test_counts_equal_the_mask():
    args = case()
    assert yardstick.voigt_evaluations(*args) == brute_force(*args)


def test_torch_counts_equal_numpy():
    nus, line_nu, centers, gamma, doppler, iw = case(seed=5)
    ref = yardstick.voigt_evaluations(nus, line_nu, centers, gamma, doppler, iw)
    t = torch.as_tensor
    ours = yardstick.voigt_evaluations_torch(t(nus), t(line_nu), t(centers), t(gamma),
                                             t(doppler), t(iw))
    assert ours == ref
    # a batch of models sums its members
    two = yardstick.voigt_evaluations_torch(t(nus), t(line_nu), t(centers),
                                            t(np.stack([gamma, gamma])),
                                            t(np.stack([doppler, doppler])),
                                            t(np.stack([iw, iw])))
    assert two == {k: 2 * v for k, v in ref.items()}


def test_bound_is_the_larger_term():
    ev = {"I": 10**9, "II": 0, "III": 0, "IV": 0}
    seconds, by = yardstick.bound(yardstick.kernel1_flops(ev), 0)
    assert by == "operations" and np.isclose(seconds, 12e9 / 67e12)
    seconds, by = yardstick.bound(0, 3.35e9)
    assert by == "bytes" and np.isclose(seconds, 1e-3)
