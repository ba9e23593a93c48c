"""95th percentile of the wall of every call in the window, from the call
to the host arrays in hand, host clock, ms."""

import numpy as np


def read(record):
    return float(np.percentile(record["latencies_s"], 95)) * 1e3
