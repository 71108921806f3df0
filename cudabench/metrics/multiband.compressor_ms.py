"""Device ms a track in the 3-band compressor's own kernels (the
configuration's ``compressor_kernels``, names read off the card's trace),
over the profiled calls: the kernels that, in that configuration, run only
inside the multiband stage and are not the cascade kernel (K5), which runs
the band split and the attack smoother. Kernels under names the other
stages share (``mul``, ``clamp``, ``cat``, fills) are left out, so this is
a part of the stage's device time; PERF.md gives the share it covers. Null
where the configuration has no such key, no such kernel ran or nothing was
traced.

The names are PyTorch's generic ones: ``gemm`` is the compressor's alone
only while loudness is off (the true peak's product is a cuBLAS gemm too),
and a hand-written kernel that replaced the release scan or the level would
run under a name not in the list, so its name has to be added to
``compressor_kernels`` (a benchmark change) before this metric follows it."""


def read(run):
    t = run.trace
    names = run.config.get("compressor_kernels")
    if t is None or not t.calls or not names:
        return None
    kernel_s = t.device_seconds(names)
    if kernel_s <= 0:
        return None
    return kernel_s * 1e3 / len(t.calls)
