"""Process start to the first timed call: imports, inputs, the program's
plan, kernel loads, graph capture and warm-up, host clock."""


def read(record):
    return record["setup_s"]
