"""Mean wall per served request of the traced window in which the host
hands the request's device work to the card: the program's spans
"plasma_and_lines", "line_opacity", "continuum" and "formal_solution" in
each "serve.request", summed, ms."""

from portbench import program_spans

NAME, UNIT, LAYER, MOVES = ("dispatch_ms", "ms", "host dispatch: base.py, pipeline.py",
                            "spectra_per_s")
STAGES = ("plasma_and_lines", "line_opacity", "continuum", "formal_solution")


def read(record):
    return program_spans.mean_per_root("serve.request", STAGES)
