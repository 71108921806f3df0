"""On-demand performance profiler for the mastering graph (port of
``ame_tpu/utils/profiler.py``; SURVEY.md §5.1 observability — the tool a
deployment reaches for when it asks "where does the time go?").

``profile_master`` measures, for one (track, settings) pair, on ``device``
(the card unless the caller asks for the CPU):

  * ``cold_start_s``: the first ``master_graph_fused`` call to completion,
    including the kernels' ``nvcc`` builds (when nothing is built yet),
    their table preparation, the warm-up of every branch and the capture
    of the chain into one CUDA graph;
  * ``fetch_rtt_ms``: a one-scalar ``.item()`` on a finished tensor;
  * ``steady_ms``: the median over ``runs`` of a ``master_graph_fused``
    call's device time between CUDA events (a replay, with its input copy
    and output clones; the host clock on the CPU, where the chain runs
    eagerly), with ``steady_ms_min``; ``steady_host_ms`` beside it is the
    host clock from the call to completion; ``x_realtime`` = track seconds
    / ``steady_ms``;
  * ``stages_ms``: the staged chain's per-stage times
    (``master_graph(timer=)``: the CUDA events of the chain's stage spans,
    ``graph/chain._StageClock``, with no sync between stages;
    ``ame_tpu``'s stage names), with ``stages_note``;
  * ``host_rss_mb`` and ``hbm_peak_mb`` (the allocator's peak on each card
    this process uses: ``utils/telemetry``).

As in ``ame_tpu``, cold start and steady state come from the fused single
program and the stage breakdown from the staged chain.

``trace_dir`` wraps the steady loop and the stage runs in
``torch.profiler`` (``telemetry.profile_trace``) and writes a Chrome trace
there; the stage runs' spans are in it as ``ame.chain.<stage>`` ranges,
timed by the same CUDA events as ``stages_ms``. A trap:
after a long stream of small launches (the compat chain's plain gain walk
on the CPU, or a process that ran it before) torch.profiler has been seen
to drop the first kernel records of the next session; profile in a fresh
process, as ``python -m ame_tpu_torch profile`` does.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ame_tpu_torch.device import resolve_device
from ame_tpu_torch.utils import telemetry


def profile_master(x, sample_rate: float, settings, runs: int = 10,
                   stages: bool = True, trace_dir: str | None = None,
                   device="cuda") -> dict:
    """Profile the mastering graph on ``device`` for [N, 2] audio ``x``
    (numpy or tensor). Returns the report dict (keys above, plus
    ``n_samples``, ``sample_rate``, ``seconds``, ``mode``, ``runs``,
    ``device`` and, with a trace, ``trace_dir``)."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph.chain import master_graph, master_graph_fused

    dev = resolve_device(device, "profile_master")
    if isinstance(settings, dict):
        settings = MasterSettings.from_dict(settings)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    x = x.to(dev, torch.float32)
    n = int(x.shape[0])
    seconds = n / float(sample_rate)
    report: dict = {
        "n_samples": n,
        "sample_rate": float(sample_rate),
        "seconds": round(seconds, 3),
        "mode": settings.mode,
        "runs": runs,
        "device": str(dev),
    }

    # cold start: kernel builds, table preparation, warm-up and capture
    t0 = time.perf_counter()
    y, _ = master_graph_fused(x, sample_rate, settings)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    report["cold_start_s"] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    y[0, 0].item()
    report["fetch_rtt_ms"] = round((time.perf_counter() - t0) * 1e3, 3)

    def _one_run():
        """(device ms, host ms) of one fused call to completion."""
        t0 = time.perf_counter()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            master_graph_fused(x, sample_rate, settings)
            end.record()
            end.synchronize()
            host = (time.perf_counter() - t0) * 1e3
            return start.elapsed_time(end), host
        master_graph_fused(x, sample_rate, settings)
        host = (time.perf_counter() - t0) * 1e3
        return host, host

    with (telemetry.profile_trace(trace_dir) if trace_dir is not None
          else contextlib.nullcontext()):
        times = [_one_run() for _ in range(runs)]
        if stages:
            sink: dict = {}
            master_graph(x, sample_rate, settings, timer={})  # warm
            k = max(runs // 2, 1)
            for _ in range(k):
                master_graph(x, sample_rate, settings, timer=sink)
    if trace_dir is not None:
        report["trace_dir"] = trace_dir
    device_ms = [t[0] for t in times]
    med = float(np.median(device_ms))
    report["steady_ms"] = round(med, 3)
    report["steady_ms_min"] = round(float(np.min(device_ms)), 3)
    report["steady_host_ms"] = round(float(np.median([t[1] for t in times])),
                                     3)
    report["x_realtime"] = round(seconds / max(med / 1e3, 1e-9), 1)
    if stages:
        report["stages_ms"] = {name: round(t / k * 1e3, 3)
                               for name, t in sink.items()}
        report["stages_note"] = (
            "per-stage times of the staged chain: device time between CUDA "
            "events, no sync between stages (host clock on the CPU); their "
            "sum exceeds steady_ms where the staged chain waits on the "
            "host's launches and reads, which the fused program does not")

    report["host_rss_mb"] = telemetry.host_rss_mb()
    mem = telemetry.device_memory_stats()
    if mem:
        report["hbm_peak_mb"] = [
            {"device": s["device"],
             "peak_mb": round(s["peak_bytes_in_use"] / 1024 ** 2, 1)}
            for s in mem]
    return report
