"""Device kernels a call that the multiband compressor's release scan
(``ame_tpu_torch.ops.window.release_scan``, a (max, x) Kogge-Stone in
PyTorch ops) enqueues: its launch counter over the window's calls. Null
where the program has no such counter or the window made no call."""

COUNTER = "window.release_scan.launches"


def read(run):
    if COUNTER not in run.counters or not run.calls:
        return None
    return run.counters[COUNTER] / len(run.calls)
