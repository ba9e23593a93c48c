"""The whole spectrum's share of the card's float32 peak over the traced
window: the operations Kernels 1 and 2 need for every spectrum of the
window (frozen counts, from the reference's own windows) over the window's
seconds times 67 TFLOP/s.  It bounds what a kernel's roofline can claim
end to end, whichever kernels carry the work."""

from portbench import yardstick

NAME, UNIT, LAYER, MOVES = ("spectrum_mfu", "%", "whole spectrum", "spectra_per_s")


def read(record):
    if not record["kernel1"]:
        return None
    flops = sum(yardstick.kernel1_flops(k["evaluations"]) for k in record["kernel1"])
    flops += sum(yardstick.kernel2_flops(k["n_models"], k["n_depth"], k["n_nu"], k["n_theta"],
                                         k["inward"]) for k in record["kernel2"])
    return 100.0 * flops / (record["window_s"] * yardstick.PEAK_FP32_FLOPS)
