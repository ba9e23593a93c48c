"""Mean wall of the continuum stage per call over the traced window
(``run_batch(timings=)["continuum"]``, synchronised at its edges), ms."""

NAME, UNIT, LAYER, MOVES = ("continuum_ms", "ms",
                            "continuum: opacities/continuum.py, opacities/file_tables.py",
                            "spectra_per_s")
STAGE = "continuum"


def read(record):
    walls = [t[STAGE] for t in record["timings"] if STAGE in t]
    return 1e3 * sum(walls) / len(walls) if walls else None
