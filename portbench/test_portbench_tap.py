"""``kernel1_tap``: which of the window's calls it keeps, and how a call's
launches are put together by line set."""

import numpy as np
import pytest
import torch

from portbench import bench, kernel1_tap

PIXELS = np.array([0, 3, 7, 9])


def armed_calls(n_window, n_calls, seed):
    tap = kernel1_tap.Kernel1Tap(PIXELS, n_calls, np.random.default_rng(
        bench.seed_words(seed, 5)), 10, "cpu", torch.float64)
    for i in range(n_window):
        tap.arm(i)
        tap.disarm()
    return sorted(tap.kept)


@pytest.mark.parametrize("n_window", [1, 2, 5, 40])
def test_keeps_a_seeded_sample_of_the_window(n_window):
    kept = armed_calls(n_window, 2, 2**33 + 5)
    assert kept == armed_calls(n_window, 2, 2**33 + 5)
    assert len(kept) == min(2, n_window) and all(0 <= i < n_window for i in kept)


def test_every_call_has_the_same_chance():
    counts = np.zeros(20)
    for seed in range(2000):
        counts[armed_calls(20, 4, seed)] += 1
    # each call is kept with chance 4/20: 400 of 2000, binomial sd ~18
    assert np.all(np.abs(counts - 400) < 90)


def test_builds_the_full_grids_index_in_set_up():
    tap = kernel1_tap.Kernel1Tap(PIXELS, 2, np.random.default_rng(0), 10, "cpu", torch.float64)
    out = torch.zeros((1, 2, 10), dtype=torch.float64)
    assert list(tap.ranges) == [(out.device, 0, 10)]


def launch(n_lines, pixels, value):
    return n_lines, np.asarray(pixels), np.full((1, 2, len(pixels)), float(value))


def test_assemble_puts_ranges_and_sets_together():
    records = [launch(5, [0, 3], 1), launch(8, [0, 3], 2), launch(5, [7, 9], 3),
               launch(8, [7, 9], 4)]
    out = kernel1_tap.assemble(records, PIXELS, {"atomic": 5, "molecular": 8})
    assert out["atomic"][0, 0].tolist() == [1, 1, 3, 3]
    assert out["molecular"][0, 0].tolist() == [2, 2, 4, 4]


@pytest.mark.parametrize("records,sets", [
    ([launch(5, [0, 3], 1)], {"atomic": 5}),  # a pixel range missing
    ([launch(5, [0, 3, 7, 9], 1), launch(5, [9], 1)], {"atomic": 5}),  # a pixel twice
    ([launch(5, [0, 3, 7, 9], 1)], {"atomic": 5, "molecular": 8}),  # a set missing
    ([launch(5, [0, 3, 7, 9], 1), launch(8, [0, 3, 7, 9], 1)], {"atomic": 5}),  # left over
    ([launch(5, [0, 3, 7, 9], 1)] * 2, {"atomic": 5, "molecular": 5}),  # sets of one count
])
def test_assemble_refuses_what_is_not_whole(records, sets):
    assert kernel1_tap.assemble(records, PIXELS, sets) is None
