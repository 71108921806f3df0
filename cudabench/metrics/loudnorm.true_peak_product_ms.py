"""Device ms a track in the true peak's matrix product (the
configuration's ``true_peak_kernels``, cuBLAS names read off the card's
trace), over the profiled calls. The product alone: the true peak's
other passes (the tiles' concatenation and bf16 rounding, the mask, the
absolute value, the maximum) run under generic kernel names that other
stages share, so they are not in it. Null where no such kernel ran or
nothing was traced."""

from cudabench.work import true_peak


def read(run):
    t = run.trace
    if t is None or not t.calls or "true_peak_kernels" not in run.config:
        return None
    kernel_s = t.device_seconds(true_peak.kernel_names(run.config))
    if kernel_s <= 0:
        return None
    return kernel_s * 1e3 / len(t.calls)
