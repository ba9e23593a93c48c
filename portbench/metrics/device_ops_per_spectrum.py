"""Device operations (kernels, copies, memsets) the profiler saw in the
traced window, per spectrum completed there."""

NAME, UNIT, LAYER, MOVES = ("device_ops_per_spectrum", "ops",
                            "host dispatch: base.py, pipeline.py", "spectra_per_s")


def read(record):
    if not record["spectra"]:
        return None
    return len(record["device_events"]) / record["spectra"]
