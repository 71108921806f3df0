"""Streaming mastering (PyTorch port of ``ame_tpu/streaming.py``).

``StreamingMaster`` runs the QUALITY chain (analog character -> RBJ EQ ->
stereo width -> optional multiband compression -> static gain -> lookahead
limiter) block by block, equal to the offline chain:

  * every IIR stage carries its scipy-layout ``zi`` between blocks (on the
    card each cascade is one launch of K5, ``ops/cascade_scan``, with zi in
    and zf out);
  * tanh, width and gain are stateless;
  * the multiband compressor (3 bands, or G with ``mb_edges``) carries the
    crossover zi, the RMS detector's window history, the release seed and
    the attack smoother's zi, and adds no latency;
  * the lookahead limiter lags the input by ``attack - 1`` samples: its
    sliding-min / mean windows are recomputed over a carried context
    [past | pend | block], and the release recursion is seeded from the
    previous block's last state.

Every cascade is designed once, in float64 on the host, when the streamer
is built (as the offline quality chain designs them), so the kernel's
per-cascade tables are cached across blocks. A block's emit indices follow
from shapes alone: ``process`` syncs once, to return the block as numpy.

``StreamingCompatMaster`` has the REFERENCE's semantics: 30 s blocks, each
through the compat stages with fresh state (quirks Q5, Q6), and the compat
limiter (``ops/limiter.alimiter_stream_step``) continuous across blocks.

Two-pass loudness normalization is offline by nature; a stream takes a
static ``gain_db`` instead. Both streamers run on ``device`` ("cuda" by
default; "cpu" runs the plain versions on the host).

Typical use::

    sm = StreamingMaster(48000, {"bass_boost": 2.0, "width": 1.2})
    for chunk in capture():          # [n, 2] float32, n >= 2*attack
        play(sm.process(chunk))
    play(sm.flush())
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ame_tpu_torch import config as C
from ame_tpu_torch import precision
from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph import multiband as mb
from ame_tpu_torch.ops import window as W
from ame_tpu_torch.ops.compressor import attack_sos
from ame_tpu_torch.ops.eq import eq_quality_sos
from ame_tpu_torch.ops.saturate import analog_sos
from ame_tpu_torch.ops.scan_iir import biquad_scan, sosfilt
from ame_tpu_torch.ops.stereo import stereo_width_quality


def _coerce_settings(settings) -> MasterSettings:
    if settings is None:
        return MasterSettings()
    if not isinstance(settings, MasterSettings):
        settings = MasterSettings.from_dict(dict(settings))
    return settings


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: streaming runs on the card "
                           "(device='cpu' runs it on the host)")
    return dev


def _f32(v: float) -> float:
    return float(np.float32(v))


def _mb_stream(y, state, new_state, cfg):
    """Streaming multiband compression (``compress_quality_multi``'s
    semantics, 3-band or G-band): the crossover zi, the detector window's
    history, the release seed and the attack smoother's zi carry across
    blocks. Adds no latency (the quality compressor has no lookahead)."""
    n = y.shape[0]
    rms_w = cfg["rms_w"]
    bands = []
    for i, sos in enumerate(cfg["mb_sos"]):
        b, new_state[f"zi_mb{i}"] = sosfilt(sos, y, zi=state[f"zi_mb{i}"])
        bands.append(b)
    sq = torch.stack([torch.mean(b * b, dim=1) for b in bands], dim=1)
    seq = torch.cat([state["mb_sq_hist"], sq], dim=0)
    s = W.moving_sum_past(seq, rms_w)[rms_w - 1:]
    count = torch.clamp(state["mb_n_seen"] + torch.arange(
        n, dtype=torch.float32, device=y.device) + 1.0, max=float(rms_w))
    level_db = 10.0 * torch.log10(torch.clamp(s / count[:, None], min=1e-12))
    over = torch.clamp(level_db - cfg["threshs"][None, :], min=0.0)
    gr_db = over * (1.0 - 1.0 / cfg["ratios"][None, :])
    gr_rel = W.release_scan(torch.cat([state["mb_u_prev"][None], gr_db]),
                            cfg["mb_rel"])[1:]
    gr_smooth, new_state["mb_zi_att"] = biquad_scan(
        gr_rel, cfg["att_coeffs"], zi=state["mb_zi_att"])
    gains = 10.0 ** (-gr_smooth / 20.0)
    new_state["mb_sq_hist"] = seq[seq.shape[0] - (rms_w - 1):]
    new_state["mb_n_seen"] = state["mb_n_seen"] + n
    new_state["mb_u_prev"] = gr_rel[-1]
    out = bands[0] * gains[:, 0:1]
    for g in range(1, len(bands)):
        out = out + bands[g] * gains[:, g:g + 1]
    return out


def _stream_step(x, state, cfg, phase):
    """One streaming step. phase: 'first' | 'steady' | 'flush'.

    The filters advance their zi; the limiter recomputes its windows over
    the [past(A-1) | pend(A-1) | block] context and emits every sample whose
    lookahead window is complete."""
    new_state = dict(state)
    y = x
    if phase != "flush":
        if cfg["analog_sos"] is not None:
            y = torch.tanh(y * cfg["drive"])
            y, new_state["zi_a"] = sosfilt(cfg["analog_sos"], y,
                                           zi=state["zi_a"])
        y, new_state["zi_e"] = sosfilt(cfg["eq_sos"], y, zi=state["zi_e"])
        if cfg["width"] is not None:
            y = stereo_width_quality(y, cfg["width"])
        if cfg["mb_sos"] is not None:
            y = _mb_stream(y, state, new_state, cfg)
        y = y * cfg["gain"]
    return _limiter_tail(y, state, new_state, cfg["sample_rate"],
                         cfg["attack"], phase)


def _limiter_tail(y, state, new_state, sr, A, phase):
    """The streaming lookahead limiter: carries the past / pend context and
    the release state, so the emitted gains equal the offline
    ``lookahead_limiter``'s."""
    rho = _f32(math.exp(-1.0 / (0.05 * sr)))
    if phase == "first":
        z = y
    elif phase == "flush":
        z = torch.cat([state["past"], state["pend"]], dim=0)
    else:
        z = torch.cat([state["past"], state["pend"], y], dim=0)
    L = z.shape[0]
    P = 0 if phase == "first" else A - 1

    peak = torch.amax(z.abs(), dim=1)
    g_t = torch.clamp(peak.new_tensor(C.LIMITER_CEILING)
                      / torch.clamp(peak, min=1e-9), max=1.0)
    g_a = W.sliding_min_ahead(g_t, A)
    g_r = W.moving_mean_past(g_a, A)

    e1 = L if phase == "flush" else L - A + 1  # emit z[P : e1]
    # the release recursion seeded from the previous emitted sample's state
    # by prepending it as a virtual element (y[-1] = u_prev exactly)
    seg = torch.cat([state["u_prev"][None], 1.0 - g_r[P:e1]])
    u = W.release_scan(seg, rho)[1:]
    y_out = z[P:e1] * (1.0 - u)[:, None]

    new_state["u_prev"] = u[-1] if u.shape[0] else state["u_prev"]
    if phase != "flush":
        new_state["pend"] = z[L - A + 1:]
        new_state["past"] = z[L - 2 * A + 2:L - A + 1]
    return y_out, new_state


class StreamingMaster:
    """Incremental quality-chain mastering with exact block handoff.

    settings: MasterSettings or reference settings dict (quality fields:
    analog_character, bass/mid/presence/treble, width, multiband / mb_edges
    and their thresholds and ratios). ``lufs`` is ignored (two-pass
    normalization is offline); pass ``gain_db`` instead.

    ``process(chunk)`` takes [n, 2] float32 (numpy or a tensor) with n >=
    2*attack and returns, as numpy, the samples whose lookahead completed
    (n per call in steady state; the stream lags by ``latency_samples``).
    ``flush()`` drains the tail. Block sizes may vary.
    """

    def __init__(self, sample_rate: float, settings=None,
                 gain_db: float = 0.0, device="cuda"):
        settings = _coerce_settings(settings)
        self.device = _device(device)
        precision.apply()
        sr = float(sample_rate)
        self.sample_rate = sr
        self.attack = max(int(C.LIMITER_ATTACK_MS * sr / 1000.0), 1)
        mb_edges = (tuple(float(e) for e in settings.mb_edges)
                    if settings.mb_edges is not None else None)
        multiband_on = bool(settings.multiband) or mb_edges is not None
        analog = float(settings.analog_character)
        # every cascade designed once, float64 on the host
        cfg = {
            "sample_rate": sr, "attack": self.attack,
            "analog_sos": analog_sos(sr, analog) if analog != 0 else None,
            "drive": 1.0 + analog / 100.0 * 0.5,
            "eq_sos": eq_quality_sos(sr, settings.bass_boost,
                                     settings.mid_cut,
                                     settings.presence_boost,
                                     settings.treble_boost),
            "width": (float(settings.width) if settings.width != 1.0
                      else None),
            "gain": _f32(np.float32(10.0) ** (np.float32(gain_db)
                                              / np.float32(20.0))),
            "mb_sos": None,
        }
        A = self.attack
        dev = self.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        self._state = {"zi_a": zeros(2, 2, 2), "zi_e": zeros(4, 2, 2),
                       "past": zeros(A - 1, 2), "pend": zeros(A - 1, 2),
                       "u_prev": zeros()}
        if multiband_on:
            if mb_edges is not None:
                G = len(mb_edges) + 1
                threshs = settings.mb_thresholds or (-20.0,) * G
                ratios = settings.mb_ratios or (3.0,) * G
            else:
                threshs = (settings.low_thresh, settings.mid_thresh,
                           settings.high_thresh)
                ratios = (settings.low_ratio, settings.mid_ratio,
                          settings.high_ratio)
            # one cascade straight off the input a band, as offline
            cascades = (mb._band_cascades_3(sr) if mb_edges is None
                        else mb._band_cascades_n(sr, mb_edges))
            G = len(cascades)
            cfg.update({
                "mb_sos": cascades,
                "rms_w": max(int(C.MB_RMS_MS * sr / 1000.0), 1),
                "mb_rel": math.exp(-1.0 / (C.MB_RELEASE_MS * sr / 1000.0)),
                "att_coeffs": attack_sos(sr, C.MB_ATTACK_MS)[0],
                "threshs": torch.tensor(threshs, dtype=torch.float32,
                                        device=dev),
                "ratios": torch.tensor(ratios, dtype=torch.float32,
                                       device=dev),
            })
            for i, sos in enumerate(cascades):
                self._state[f"zi_mb{i}"] = zeros(sos.shape[0], 2, 2)
            self._state.update({
                "mb_sq_hist": zeros(cfg["rms_w"] - 1, G),
                "mb_n_seen": zeros(),
                "mb_u_prev": zeros(G),
                "mb_zi_att": zeros(G, 2),
            })
        self._cfg = cfg
        self._first = True
        self._done = False

    @property
    def latency_samples(self) -> int:
        return self.attack - 1

    def resume(self, state: dict) -> None:
        """Continue a stream from another streamer's state (the same keys
        and shapes, e.g. ``convert.streaming_state`` of an ``ame_tpu``
        streamer's after at least one block), moved to this device."""
        if self._done:
            raise RuntimeError("stream already flushed")
        bad = [k for k in set(state) | set(self._state)
               if k not in state or k not in self._state
               or tuple(state[k].shape) != tuple(self._state[k].shape)]
        if bad:
            raise ValueError(f"state does not fit this streamer: {bad}")
        self._state = {k: torch.as_tensor(state[k], dtype=torch.float32)
                       .to(self.device) for k in self._state}
        self._first = False

    def process(self, chunk) -> np.ndarray:
        if self._done:
            raise RuntimeError("stream already flushed")
        if not isinstance(chunk, torch.Tensor):
            chunk = np.asarray(chunk, np.float32)
        if chunk.ndim != 2 or chunk.shape[1] != 2:
            raise ValueError("chunk must be [n, 2]")
        if chunk.shape[0] < 2 * self.attack:
            raise ValueError(f"chunk must be >= {2 * self.attack} samples "
                             f"(2x the limiter lookahead)")
        x = torch.as_tensor(chunk, dtype=torch.float32).to(self.device)
        phase = "first" if self._first else "steady"
        self._first = False
        y, self._state = _stream_step(x, self._state, self._cfg, phase)
        return y.cpu().numpy()

    def flush(self) -> np.ndarray:
        """Emit the final ``latency_samples`` samples (end-clipped
        lookahead, as the offline limiter ends a track)."""
        if self._done or self._first:
            self._done = True
            return np.zeros((0, 2), np.float32)
        self._done = True
        y, self._state = _stream_step(None, self._state, self._cfg, "flush")
        return y.cpu().numpy()


class StreamingCompatMaster:
    """Streaming mastering with the REFERENCE's semantics: input is cut
    into 30 s blocks and each block runs the compat chain with fresh
    filter / compressor state (quirk Q6, audio_mastering_engine.py:178,
    185-204) and per-stage int16 requantization (Q5), while the final
    limiter runs continuously across blocks, as the reference's
    whole-track alimiter pass does (engine:223).

    Two-pass loudnorm is offline; pass ``gain_db`` instead (applied before
    the limiter, then requantized as loudnorm pass 2's pcm_s16le output is
    when nonzero). Latency is one 30 s block plus the limiter's hold: this
    mode is for parity and regression use; ``StreamingMaster`` is the
    low-latency path.

    ``process(chunk)`` accepts [n, 2] float32 of any size (buffered on the
    host into blocks) and returns, as numpy, whatever samples completed;
    ``flush`` runs the final partial block and drains the limiter."""

    def __init__(self, sample_rate: float, settings=None,
                 gain_db: float = 0.0, device="cuda"):
        from ame_tpu_torch.graph.chain import params_from_settings
        from ame_tpu_torch.ops.limiter import alimiter_stream_init
        settings = _coerce_settings(settings)
        if settings.mb_edges is not None:
            raise ValueError("mb_edges (G-band multiband) is quality-mode "
                             "only; compat streaming is pinned to the "
                             "reference's 3-band stage")
        self.device = _device(device)
        precision.apply()
        self.sample_rate = float(sample_rate)
        self.block_len = int(C.COMPAT_CHUNK_SECONDS * sample_rate)
        self.attack = max(int(C.LIMITER_ATTACK_MS * sample_rate / 1000.0), 1)
        self._s = settings
        self._gain = float(gain_db)
        p = params_from_settings(settings)
        # thresholds and ratios design nothing on the device: host floats
        p["threshs"], p["ratios"] = p["threshs"].tolist(), p["ratios"].tolist()
        self._p = p
        self._state = alimiter_stream_init(
            sample_rate, C.LIMITER_CEILING, C.LIMITER_ATTACK_MS,
            C.LIMITER_RELEASE_MS, device=self.device)
        self._chunks: list[np.ndarray] = []   # pending input, in order
        self._buffered = 0
        self._done = False

    @property
    def latency_samples(self) -> int:
        return self.block_len + self._state["hold"]

    def _run_block(self, block: torch.Tensor) -> torch.Tensor:
        """One 30 s (or final partial) block through the compat stages with
        fresh state: graph/chain.py's stages with chunk_len=None."""
        from ame_tpu_torch.graph import chain as G
        from ame_tpu_torch.ops import quantize
        s, p, sr = self._s, self._p, self.sample_rate
        y = block
        if s.analog_character > 0:
            y = G._stage_analog_compat(y, p["analog"], sr, None)
        y = G._stage_eq_width_compat(y, p["bass"], p["mid_cut"],
                                     p["presence"], p["treble"], sr,
                                     s.width != 1.0, p["width"], None)
        if s.multiband:
            y = G._stage_multiband_compat(y, p["threshs"], p["ratios"], sr,
                                          None)
        if self._gain != 0.0:
            y = quantize.int16_roundtrip(y * 10.0 ** (self._gain / 20.0))
        return y

    def _emit(self, y: torch.Tensor, flush: bool = False) -> np.ndarray:
        from ame_tpu_torch.ops.limiter import alimiter_stream_step
        out, self._state = alimiter_stream_step(y, self._state, flush=flush)
        return out.cpu().numpy()

    def _take(self, n: int) -> torch.Tensor:
        """Pop exactly n buffered samples, one host concatenate and one
        upload a block."""
        parts, got = [], 0
        while got < n:
            c = self._chunks.pop(0)
            take = min(n - got, c.shape[0])
            parts.append(c[:take])
            if take < c.shape[0]:
                self._chunks.insert(0, c[take:])
            got += take
        self._buffered -= n
        return torch.from_numpy(np.concatenate(parts, axis=0)).to(self.device)

    def process(self, chunk) -> np.ndarray:
        if self._done:
            raise RuntimeError("stream already flushed")
        x = np.asarray(chunk, np.float32)
        if x.ndim != 2 or x.shape[1] != 2:
            raise ValueError("chunk must be [n, 2]")
        if x.shape[0]:
            self._chunks.append(x)
            self._buffered += x.shape[0]
        outs = []
        while self._buffered >= self.block_len:
            outs.append(self._emit(self._run_block(self._take(
                self.block_len))))
        if not outs:
            return np.zeros((0, 2), np.float32)
        return np.concatenate(outs, axis=0)

    def flush(self) -> np.ndarray:
        if self._done:
            return np.zeros((0, 2), np.float32)
        self._done = True
        if self._buffered:
            tail = self._run_block(self._take(self._buffered))
        else:
            tail = torch.zeros((0, 2), dtype=torch.float32,
                               device=self.device)
        return self._emit(tail, flush=True)
