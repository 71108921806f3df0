"""Share of its roofline that the true peak's matrix product reaches: the
least time of the true peak of the profiled tracks (``work/true_peak.py``)
over the device time of the configuration's ``true_peak_kernels``, %.
The product is where the true peak's arithmetic lies, so the least work
of the whole true peak is its bound; the stage's other passes are not in
the time (``loudnorm.true_peak_product_ms``), so the share of the whole
stage is lower. Null where no such kernel ran, nothing was traced, or the
card is not in the table of peaks."""

from cudabench.work import true_peak


def read(run):
    t = run.trace
    if (t is None or run.peaks is None or not t.calls
            or "true_peak_kernels" not in run.config):
        return None
    kernel_s = t.device_seconds(true_peak.kernel_names(run.config))
    if kernel_s <= 0:
        return None
    channels = int(run.config["channels"])
    least = sum(true_peak.least_seconds(run.calls[k].n, channels, run.peaks)
                for k in t.calls)
    return 100.0 * least / kernel_s
