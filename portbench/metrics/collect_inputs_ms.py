"""Mean wall of ``collect_batch_inputs`` per call over the traced window:
the host building a batch's inputs (each member's file cross-sections,
molecular rows, densities and geometry), host clock around the call, ms."""

NAME, UNIT, LAYER, MOVES = ("collect_inputs_ms", "ms",
                            "batch inputs: parallel/batch.py collect_batch_inputs, "
                            "opacities/file_tables.py", "spectra_per_s")
STAGE = "collect_batch_inputs"


def read(record):
    walls = [t[STAGE] for t in record["timings"] if STAGE in t]
    return 1e3 * sum(walls) / len(walls) if walls else None
