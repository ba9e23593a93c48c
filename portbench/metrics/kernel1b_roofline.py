"""Kernel 1b's share of its roofline over the traced window: the bound of
every launch (the larger of Kernel 1's in-window Voigt evaluations times
the frozen value-and-derivative operation counts, plus the per-pair work,
over the float32 peak, and its bytes over the memory rate; counted from
the reference's own windows, one launch per forward launch of Kernel 1)
over the device time of the kernels named ``line_opacity_grad`` (its two
passes)."""

from portbench import yardstick

NAME, UNIT, LAYER, MOVES = ("kernel1b_roofline", "%", "Kernel 1b: opacities/line_kernel.py, "
                            "csrc/line_opacity_grad.cu", "spectra_per_s")
KERNEL = "line_opacity_grad"


def launch_bound(launch):
    """Seconds of one Kernel 1b launch's bound."""
    pairs = launch["n_models"] * launch["n_depth"] * launch["n_lines"]
    flops = (sum(yardstick.GRAD_VOIGT_FLOPS[k] * v for k, v in launch["evaluations"].items())
             + yardstick.GRAD_PAIR_FLOPS * pairs)
    nbytes = yardstick.line_grad_bytes(launch["n_models"], launch["n_lines"], launch["n_depth"],
                                       launch["n_out"], launch["itemsize"])
    return yardstick.bound(flops, nbytes)[0]


def read(record):
    seconds, count = yardstick.kernel_seconds(record["device_events"], KERNEL)
    if not count or not record["kernel1"]:
        return None
    return 100.0 * sum(launch_bound(launch) for launch in record["kernel1"]) / seconds
