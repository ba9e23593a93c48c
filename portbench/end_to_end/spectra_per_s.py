"""Spectra completed in the window (each member of a batch counts one)
over the window's seconds, host clock."""


def read(record):
    return record["spectra"] / record["window_s"]
