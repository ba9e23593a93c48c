"""Mean wall of a served request's inputs on the host per request of the
traced window: the program's span "serve.inputs" (the request's checks,
file sigma tables, molecular rows, ray geometry and elemental densities)
in each "serve.request", ms."""

from portbench import program_spans

NAME, UNIT, LAYER, MOVES = ("request_inputs_ms", "ms",
                            "request inputs: serving.py synthesize, pipeline.py "
                            "elemental_densities, model_geometry", "spectra_per_s")


def read(record):
    return program_spans.mean_per_root("serve.request", ("serve.inputs",))
