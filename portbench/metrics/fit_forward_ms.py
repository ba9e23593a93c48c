"""Mean wall of a fit step's forward pass per step over the traced window:
stage 1 with autograd on, the spectrum, both broadenings, the
normalisation and the loss, host clock, the card synchronised at both
ends, ms."""

NAME, UNIT, LAYER, MOVES = ("fit_forward_ms", "ms",
                            "fit forward: pipeline.py stage_plasma_and_lines, stage_spectrum, "
                            "postprocessing.py", "spectra_per_s")
STAGE = "fit_forward"


def read(record):
    walls = [t[STAGE] for t in record["timings"] if STAGE in t]
    return 1e3 * sum(walls) / len(walls) if walls else None
