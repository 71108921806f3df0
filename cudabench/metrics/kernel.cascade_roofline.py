"""Share of its roofline that the cascade kernel (K5,
``csrc/cascade_scan.cu``) reaches: the least time of the chain's cascade
work on the profiled tracks (``work/cascade.py``: each cascade reads its
[N, C] float32 input once and writes its output once) at the card's HBM
bandwidth, over the device time of the kernels that do it. Null where no
such kernel ran or the card is not in the table of peaks."""

from cudabench.work import cascade


def read(run):
    t = run.trace
    if t is None or run.peaks is None or not t.calls:
        return None
    kernel_s = t.device_seconds(cascade.kernel_names(run.config))
    if kernel_s <= 0:
        return None
    work = sum(cascade.bytes_for(run.config, run.calls[k].n)
               for k in t.calls)
    return 100.0 * work / run.peaks["hbm_bytes_per_s"] / kernel_s
