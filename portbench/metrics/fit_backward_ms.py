"""Mean wall of a fit step's backward pass per step over the traced
window: ``torch.autograd.grad`` through the broadenings, Kernels 2b and
1b and stage 1, host clock, the card synchronised at both ends, ms."""

NAME, UNIT, LAYER, MOVES = ("fit_backward_ms", "ms",
                            "fit backward: autograd through postprocessing.py, Kernels 2b and 1b, "
                            "stage 1", "spectra_per_s")
STAGE = "fit_backward"


def read(record):
    walls = [t[STAGE] for t in record["timings"] if STAGE in t]
    return 1e3 * sum(walls) / len(walls) if walls else None
