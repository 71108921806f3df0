"""The mastering graph (PyTorch port).

Port of ``ame_tpu/graph/chain.py``: ``params_from_settings``, the compat
stages ``_stage_analog_compat``, ``_stage_eq_width_compat`` and
``_stage_multiband_compat``, ``_stage_pre_quality``, ``_stage_normalize``,
``_master_compat``, ``_master_quality``, ``master_graph`` and
``master_graph_fused``. The stage order
is the reference's (audio_mastering_engine.py:185-223): analog character ->
EQ -> width -> multiband -> loudness normalize -> limiter, over one [N, 2]
float32 tensor on one device.

* ``compat`` reproduces the reference chain's quirks: blend EQ (Q1-Q3),
  int16 re-quantization at every stage boundary (Q5), the subtractive
  crossover (Q4) with exact pydub compression and saturating adds (Q7),
  ffmpeg's two-pass loudnorm with silent passthrough (Q9) and the
  ffmpeg-contract alimiter, always on (Q8).
  ``compat_chunked=True`` adds the reference's 30 s segment loop (Q6): the
  filters, the compressor's detectors and its gain state restart every
  ``COMPAT_CHUNK_SECONDS`` (read at call time); loudnorm and the limiter
  stay continuous, as in the reference.
* ``quality`` is the product chain: RBJ EQ, continuous f32 state, the
  Linkwitz-Riley multiband (3 bands, or G bands with ``mb_edges``), the
  lookahead limiter.

Every data-dependent decision of the chain stays on the device (the gain
engine's sweeps, per-band fallback and silent early-out, loudnorm's
linear/dynamic choice and silent passthrough: ``ops/_branch.device_if``),
so ``master_graph_fused`` captures the whole chain into one CUDA graph and
replays it with no host round trip: ``ame_tpu``'s single program. Run
eagerly (``master_graph``), the chain reads each decision on the host once.
"""

from __future__ import annotations

import collections
import threading
import time

import torch

from ame_tpu_torch import config as C
from ame_tpu_torch import precision
from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph import multiband as mb
from ame_tpu_torch.ops import eq, quantize, saturate, stereo
from ame_tpu_torch.ops._branch import holding, new_stream, warm_all_branches
from ame_tpu_torch.ops.limiter import alimiter_compat, lookahead_limiter
from ame_tpu_torch.ops.loudness import normalize_two_pass
from ame_tpu_torch.ops.loudnorm import loudnorm_two_pass
from ame_tpu_torch.utils import telemetry


def _band_params(s: MasterSettings):
    """(thresholds, ratios): the multiband stage's per-band host values."""
    G = None if s.mb_edges is None else len(s.mb_edges) + 1
    threshs = ((s.low_thresh, s.mid_thresh, s.high_thresh) if G is None
               else s.mb_thresholds or (-20.0,) * G)
    ratios = ((s.low_ratio, s.mid_ratio, s.high_ratio) if G is None
              else s.mb_ratios or (3.0,) * G)
    return threshs, ratios


def params_from_settings(s: MasterSettings, device="cpu") -> dict:
    """The graph's parameters: scalars as host floats (they design the
    stages' filter coefficients on the host) and the per-band multiband
    vectors as float32 tensors on ``device``."""
    threshs, ratios = _band_params(s)
    return {
        "analog": float(s.analog_character),
        "bass": float(s.bass_boost),
        "mid_cut": float(s.mid_cut),
        "presence": float(s.presence_boost),
        "treble": float(s.treble_boost),
        "width": float(s.width),
        "lufs": float(s.lufs if s.lufs is not None else -14.0),
        "tp": float(s.target_tp),
        "lra": float(s.target_lra),
        "threshs": torch.tensor(threshs, dtype=torch.float32, device=device),
        "ratios": torch.tensor(ratios, dtype=torch.float32, device=device),
    }


def _stage_analog_compat(x, analog, sample_rate, chunk_len=None):
    y = saturate.analog_character_compat(x, sample_rate, analog, chunk_len)
    return quantize.int16_roundtrip(y)


def _stage_eq_width_compat(x, bass, mid_cut, presence, treble, sample_rate,
                           width_on, width=None, chunk_len=None):
    y = eq.apply_eq_compat(x, sample_rate, bass, mid_cut, presence, treble,
                           chunk_len)
    if width_on:
        y = stereo.stereo_width(y, width)
    return quantize.int16_roundtrip(y)


def _stage_multiband_compat(x, threshs, ratios, sample_rate, chunk_len=None):
    return mb.multiband_compat(x, sample_rate, threshs, ratios,
                               chunk_len=chunk_len)


def _stage_multiband_quality(x, threshs, ratios, sample_rate, mb_edges=None):
    if mb_edges is None:
        return mb.multiband_quality(x, sample_rate, threshs, ratios)
    return mb.multiband_quality_n(x, sample_rate, mb_edges, threshs, ratios)


def _stage_normalize(x, target, tp, lra, n_valid, sample_rate, requantize):
    """compat (``requantize``): ffmpeg's two-pass loudnorm flow
    (engine:227-246), written back as int16 (pass 2 writes pcm_s16le).
    quality: the clean gain of ``normalize_two_pass``."""
    if requantize:
        y, info = loudnorm_two_pass(x, sample_rate, target, tp, lra,
                                    n_valid=n_valid)
        return quantize.int16_roundtrip(y), info
    return normalize_two_pass(x, sample_rate, target, target_tp_db=tp,
                              target_lra=lra, n_valid=n_valid)


def _stage_pre_quality(x, analog, bass, mid_cut, presence, treble,
                       sample_rate, analog_on, width_on, width=None):
    if analog_on:
        x = saturate.analog_character_quality(x, sample_rate, analog)
    x = eq.apply_eq_quality(x, sample_rate, bass, mid_cut, presence, treble)
    if width_on:
        x = stereo.stereo_width_quality(x, width)
    return x


class _StageClock:
    """The chain's stages: each a span ``chain.<stage>``
    (``utils/telemetry.stage_timer``) and, into an optional ``timer``
    dict, per-stage seconds.

    On CUDA each stage is bracketed by one pair of ``torch.cuda.Event``s,
    which give both the span's device times and the ``timer`` seconds;
    these are resolved after the last stage (``finish``, for the ``timer``)
    or when the spans are read — no sync between stages. On the CPU the ops
    run synchronously and the host clock is used. With no ``timer`` and
    tracing off it is a pass-through."""

    def __init__(self, sink: dict | None, device: torch.device):
        self.sink = sink
        self.device = device
        self.cuda = device.type == "cuda"
        self.events = []

    def __call__(self, name, thunk):
        with telemetry.stage_timer("chain." + name) as span:
            # a captured graph (master_graph_fused) records no timing event
            if self.cuda and (self.sink is not None or (
                    span is not None and
                    not torch.cuda.is_current_stream_capturing())):
                start, end = telemetry.event_pair(span, self.device)
                start.record()
                out = thunk()
                end.record()
                if self.sink is not None:
                    self.events.append((name, start, end))
                return out
            if self.sink is None:
                return thunk()
            t0 = time.perf_counter()
            out = thunk()
            self._add(name, time.perf_counter() - t0)
            return out

    def _add(self, name, seconds):
        self.sink[name] = self.sink.get(name, 0.0) + seconds

    def finish(self):
        for name, start, end in self.events:
            end.synchronize()
            self._add(name, start.elapsed_time(end) / 1000.0)
        self.events = []


def _master_compat(x, sample_rate, p, *, analog_on, width_on, multiband_on,
                   lufs_on, chunked=False, n_valid=None, timer=None):
    # engine:178: the reference's 30 s segments, read at call time
    chunk_len = int(C.COMPAT_CHUNK_SECONDS * sample_rate) if chunked else None
    info = {}
    clock = _StageClock(timer, x.device)
    if analog_on:  # engine:192
        x = clock("analog", lambda: _stage_analog_compat(
            x, p["analog"], sample_rate, chunk_len))
    x = clock("eq_width", lambda: _stage_eq_width_compat(  # engine:194-196
        x, p["bass"], p["mid_cut"], p["presence"], p["treble"], sample_rate,
        width_on, p["width"], chunk_len))
    if multiband_on:  # engine:197 (host thresholds and ratios)
        x = clock("multiband", lambda: _stage_multiband_compat(
            x, p["threshs"], p["ratios"], sample_rate, chunk_len))
    if lufs_on:  # engine:216-220
        x, loud_info = clock("loudnorm", lambda: _stage_normalize(
            x, p["lufs"], p["tp"], p["lra"], n_valid, sample_rate, True))
        info.update(loud_info)
    # engine:223: alimiter, always (quirk Q8), with ffmpeg-contract ramps and
    # the default auto-level 1/limit output scale
    x = clock("limiter", lambda: alimiter_compat(
        x, sample_rate, C.LIMITER_CEILING, C.LIMITER_ATTACK_MS,
        C.LIMITER_RELEASE_MS))
    clock.finish()
    return x, info


def _master_quality(x, sample_rate, p, *, analog_on, width_on, multiband_on,
                    lufs_on, n_valid=None, timer=None, mb_edges=None):
    info = {}
    clock = _StageClock(timer, x.device)
    x = clock("analog_eq_width", lambda: _stage_pre_quality(
        x, p["analog"], p["bass"], p["mid_cut"], p["presence"], p["treble"],
        sample_rate, analog_on, width_on, p["width"]))
    if multiband_on:
        x = clock("multiband", lambda: _stage_multiband_quality(
            x, p["threshs"], p["ratios"], sample_rate, mb_edges))
    if lufs_on:
        x, loud_info = clock("loudnorm", lambda: _stage_normalize(
            x, p["lufs"], p["tp"], p["lra"], n_valid, sample_rate, False))
        info.update(loud_info)
    x = clock("limiter", lambda: lookahead_limiter(
        x, sample_rate, C.LIMITER_CEILING, C.LIMITER_ATTACK_MS,
        C.LIMITER_RELEASE_MS))
    clock.finish()
    return x, info


def _structure(settings):
    """(settings, structure key), checked; host work only."""
    if isinstance(settings, dict):
        settings = MasterSettings.from_dict(settings)
    structure = settings.structure_key()
    if structure[0] == "compat" and structure[6] is not None:
        raise ValueError("mb_edges (G-band multiband) is quality-mode only; "
                         "compat mode is pinned to the reference's 3-band "
                         "stage")
    return settings, structure


def _params(settings, structure, device) -> dict:
    """The chain's params on ``device``: the compat chain takes its band
    thresholds and ratios as host floats (they design nothing on the
    device), the quality chain as tensors."""
    precision.apply()
    p = params_from_settings(settings, device)
    if structure[0] == "compat":
        p["threshs"], p["ratios"] = _band_params(settings)
    return p


def _run(x, sample_rate, p, structure, n_valid, timer=None):
    (mode, chunked, multiband_on, analog_on, width_on, lufs_on,
     mb_edges) = structure
    if mode == "compat":
        return _master_compat(
            x, float(sample_rate), p, analog_on=analog_on, width_on=width_on,
            multiband_on=multiband_on, lufs_on=lufs_on, chunked=chunked,
            n_valid=n_valid, timer=timer)
    return _master_quality(
        x, float(sample_rate), p, analog_on=analog_on, width_on=width_on,
        multiband_on=multiband_on, lufs_on=lufs_on, n_valid=n_valid,
        timer=timer, mb_edges=mb_edges)


def master_graph(x: torch.Tensor, sample_rate: float, settings,
                 n_valid: int | None = None, timer: dict | None = None) -> tuple:
    """Run the mastering graph.

    Args:
      x: [N, 2] float32 tensor in [-1, 1) (int16-grid values in compat mode,
        as ``api.master_array`` stages them); the graph runs on its device.
      sample_rate: track sample rate.
      settings: MasterSettings (or reference settings dict).
      n_valid: true track length when x carries trailing padding.
      timer: optional dict; per-stage seconds are accumulated into it
        (the stages' spans' clock, ``_StageClock``).

    Returns:
      (y, info): mastered [N, 2] float32 and the loudness stats as 0-d
      tensors (when normalization ran).
    """
    with telemetry.stage_timer("chain"):
        settings, structure = _structure(settings)
        return _run(x, sample_rate, _params(settings, structure, x.device),
                    structure, n_valid, timer)


_FUSED_GRAPHS = 4        # captured chains kept per device, least recent out
_fused: dict = {}        # device -> OrderedDict(key -> _Fused)
_fused_locks: dict = {}  # device -> the lock its graphs sit behind
_free_streams: dict = {}  # device -> replay streams of dropped entries
                          # (graph_if.cu makes streams and frees none)
_fused_guard = threading.RLock()  # guards the three dicts above


def _device_graphs(device: torch.device):
    """(lock, graphs) of ``device``: the lock guards its graphs' lookup,
    capture, eviction and replay."""
    with _fused_guard:
        lock = _fused_locks.setdefault(device, threading.Lock())
        return lock, _fused.setdefault(device, collections.OrderedDict())


def _take_stream(device: torch.device):
    with _fused_guard:
        free = _free_streams.get(device)
        if free:
            return free.pop()
    return new_stream(device)


class _Fused:
    """One captured chain: its graph, the static input it reads, the static
    outputs it writes, the stream of its own it is captured and replayed
    on, the event of the last call's clones, and what must outlive the
    capture (the params, the cached device tables the kernels read, and
    the memory pool of its conditional bodies: the caching allocator
    sends only the capturing stream's own allocations to the graph's
    pool, so this thread's others, the bodies', go to a second pool the
    entry releases when dropped).

    Callers hold the device's lock (``_device_graphs``) around the
    construction and every call."""

    def __init__(self, x, sample_rate, p, structure, n_valid):
        self.x = x.clone()
        self.keep = p
        self.device = x.device.index
        self.pool = None
        self.stream = None
        self.done = None         # the last call's clones, on its stream
        self.clean = False

        def run():
            return _run(self.x, sample_rate, p, structure, n_valid)

        dev = x.device
        with torch.cuda.device(dev):
            self.stream = _take_stream(dev)
            # warm-up: every branch once, eagerly, so that each table,
            # library, kernel and workspace a branch can reach is ready
            # before the capture (an upload inside it is a fault)
            self.stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self.stream), warm_all_branches():
                run()
            torch.cuda.synchronize(dev)
            self.graph = torch.cuda.CUDAGraph()
            pool = torch.cuda.graph_pool_handle()
            # thread_local: another thread's eager CUDA work (a host read,
            # an allocation) neither fails this capture nor is refused
            with holding() as self.tables, torch.cuda.graph(
                    self.graph, stream=self.stream,
                    capture_error_mode="thread_local"):
                torch._C._cuda_beginAllocateCurrentThreadToPool(self.device,
                                                                pool)
                self.pool = pool
                try:
                    self.y, self.info = run()
                finally:
                    torch._C._cuda_endAllocateToPool(self.device, self.pool)
        self.clean = True

    def __call__(self, x):
        """Copy in and replay on the entry's stream, after the caller's
        stream and after the last call's clones (``done``); clone out on
        the caller's stream, after the replay. So one call's clones read
        the static outputs before the next call's replay writes them,
        whatever streams the two callers run on, and the clones are
        ordinary allocations of the caller's stream."""
        s = self.stream
        caller = torch.cuda.current_stream(x.device)
        s.wait_stream(caller)
        if self.done is not None:
            s.wait_event(self.done)
        with torch.cuda.stream(s):
            self.x.copy_(x)
            self.graph.replay()
        x.record_stream(s)
        caller.wait_stream(s)
        y = self.y.clone()
        info = {k: v.clone() for k, v in self.info.items()}
        self.done = caller.record_event()
        return y, info

    def __del__(self):
        if self.stream is not None:
            self.stream.synchronize()
        if self.done is not None:
            self.done.synchronize()
        graph = getattr(self, "graph", None)
        if graph is not None:
            graph.reset()
        if self.pool is not None:
            torch._C._cuda_releasePool(self.device, self.pool)
        if self.clean:
            with _fused_guard:
                _free_streams.setdefault(self.stream.device,
                                         []).append(self.stream)


def master_graph_fused(x: torch.Tensor, sample_rate: float, settings,
                       n_valid: int | None = None) -> tuple:
    """One-program variant of ``master_graph`` (``ame_tpu``'s
    ``master_graph_fused``): on a card the whole chain is one CUDA graph,
    captured on the first call for a key and replayed on later ones, one
    launch and no host round trip a call; every data-dependent branch is a
    conditional node the card decides. Returns clones of the graph's
    outputs, so a result never aliases its buffers.

    The key is the settings (every value), N, ``n_valid``, the sample rate,
    the chunk length of chunked compat, dtype and device. Settings are
    captured by value: their filters are designed on the host (K5's
    coefficients travel in its launch parameters), so a new settings value
    captures anew, where ``ame_tpu`` shares one compile across values. The
    first call warms every branch once, then captures. The last
    ``_FUSED_GRAPHS`` graphs are kept per device; dropping one waits for
    its stream and frees its memory pools. A failed capture raises; the
    staged chain never runs in its place on a card. On the CPU (CPU
    tensors only) the same chain runs eagerly.

    Any thread may call it, on any stream: a lock per device orders the
    lookup, the capture, the eviction and the replay, and each graph runs
    on a stream of its own that waits for the caller's stream and for the
    last call's clones; the caller's stream waits for the replay and
    clones the outputs."""
    settings, structure = _structure(settings)
    if x.device.type == "cpu":
        return _run(x, sample_rate, _params(settings, structure, x.device),
                    structure, n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"master_graph_fused: unsupported device "
                         f"{x.device}")
    key = (settings, x.shape, n_valid, float(sample_rate),
           C.COMPAT_CHUNK_SECONDS, x.dtype)
    lock, graphs = _device_graphs(x.device)
    with lock:
        entry = graphs.get(key)
        if entry is None:
            try:
                entry = _Fused(x, sample_rate,
                               _params(settings, structure, x.device),
                               structure, n_valid)
            except Exception as e:
                raise RuntimeError(f"master_graph_fused: capturing the "
                                   f"chain failed on {x.device}: {e}") from e
            if len(graphs) >= _FUSED_GRAPHS:
                graphs.popitem(last=False)
            graphs[key] = entry
        graphs.move_to_end(key)
        return entry(x)
