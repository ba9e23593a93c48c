"""Kernel 1's share of its roofline over the traced window: the bound of
every launch (the larger of its in-window Voigt evaluations times the
frozen operation counts over the float32 peak, and its bytes over the
memory rate; counted from the reference's own windows) over the device
time of the kernels named ``line_opacity_kernel``."""

from portbench import yardstick

NAME, UNIT, LAYER, MOVES = ("kernel1_roofline", "%", "Kernel 1: opacities/line_kernel.py, "
                            "csrc/line_opacity.cu", "spectra_per_s")
KERNEL = "line_opacity_kernel"


def read(record):
    seconds, count = yardstick.kernel_seconds(record["device_events"], KERNEL)
    if not count or not record["kernel1"]:
        return None
    bound = sum(yardstick.kernel1_bound(launch["evaluations"], launch["n_models"],
                                        launch["n_lines"], launch["n_depth"], launch["n_out"],
                                        launch["itemsize"]) for launch in record["kernel1"])
    return 100.0 * bound / seconds
