"""Mean wall per served request of the traced window in which the host is
blocked on the card: the program's spans "validate" (the line quantities'
finiteness flags) and "readback" (F_nu copied to the host) in each
"serve.request", summed, ms."""

from portbench import program_spans

NAME, UNIT, LAYER, MOVES = ("device_wait_ms", "ms", "device", "spectra_per_s")
STAGES = ("validate", "readback")


def read(record):
    return program_spans.mean_per_root("serve.request", STAGES)
