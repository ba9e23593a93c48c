"""Mean wall of a batch's file-opacity cross-sections per batch of the
traced window: the program's span "batch.file_sigmas" (the file tables
interpolated at each member's temperatures) in each
"batch.collect_inputs", ms."""

from portbench import program_spans

NAME, UNIT, LAYER, MOVES = ("file_sigma_ms", "ms",
                            "batch inputs: parallel/batch.py collect_batch_inputs, "
                            "opacities/file_tables.py", "spectra_per_s")


def read(record):
    return program_spans.mean_per_root("batch.collect_inputs", ("batch.file_sigmas",))
