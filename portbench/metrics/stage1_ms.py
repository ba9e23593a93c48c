"""Mean wall of stage 1 per call over the traced window, the copies into
its graph's buffers and the replay (``run_batch(timings=)
["plasma_and_lines"]``, synchronised at its edges), ms."""

NAME, UNIT, LAYER, MOVES = ("stage1_ms", "ms",
                            "stage 1: pipeline.py stage_plasma_and_lines, CapturedStage1, "
                            "plasma/", "spectra_per_s")
STAGE = "plasma_and_lines"


def read(record):
    walls = [t[STAGE] for t in record["timings"] if STAGE in t]
    return 1e3 * sum(walls) / len(walls) if walls else None
