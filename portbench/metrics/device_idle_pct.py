"""Share of the traced window in which no kernel, copy or memset ran on
the card (the frozen union of the profiler's device intervals)."""

NAME, UNIT, LAYER, MOVES = "device_idle_pct", "%", "device", "spectra_per_s"


def read(record):
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
