"""Streaming in the port against ame_tpu's on the same numpy inputs, on the
CPU: ``StreamingMaster`` (quality, plain / 3-band / G-band multiband, at a
fixed and a ragged block size) against ame_tpu's streamer (2e-4: the port
designs its RBJ cascades in float64, the JAX streamer in f32) and against
the port's offline chain (1e-4 plain, 2e-4 multiband), with no error spike
at block boundaries; ``StreamingCompatMaster`` against ame_tpu's and the
port's offline chunked compat chain; the compat limiter's streaming form;
a mid-stream handoff from ame_tpu's streamer (``convert.streaming_state``);
and the kernels' designs (K5's and K1's float32 emulations) at the block
lengths a stream gives them."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ame_tpu_torch import convert
from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph import multiband
from ame_tpu_torch.graph.chain import master_graph
from ame_tpu_torch.ops import eq, limiter, saturate, stereo
from ame_tpu_torch.ops.scan_iir import biquad_scan, sosfilt
from ame_tpu_torch.streaming import StreamingCompatMaster, StreamingMaster
from tests.conftest import make_test_signal

SR = 44100
LSB = 1.0 / 32768.0
EDGES = (200.0, 1200.0, 5000.0)
SETTINGS = {
    "plain": {"analog_character": 30.0, "bass_boost": 2.5, "mid_cut": 1.0,
              "presence_boost": -1.5, "treble_boost": 3.0, "width": 1.3},
    "mb3": {"bass_boost": 1.5, "multiband": True,
            "low_thresh": -30.0, "low_ratio": 6.0,
            "mid_thresh": -25.0, "mid_ratio": 3.0,
            "high_thresh": -20.0, "high_ratio": 4.0},
    "g4": {"analog_character": 10.0, "mb_edges": EDGES,
           "mb_thresholds": (-32.0, -30.0, -26.0, -24.0),
           "mb_ratios": (4.0, 3.0, 3.0, 5.0)},
}
# block sizes: 4096 throughout, or a ragged list (each distinct size
# compiles once on the JAX side, so the sizes repeat)
BLOCKS = {"fixed": [4096] * 3, "ragged": [4096, 3000, 5000, 3000, 5000]}
GAIN_DB = -2.0


def _program(n):
    x = make_test_signal("noise", n, SR, seed=3) * 0.1
    x[n // 3: n // 2] *= 9.0  # hot section engages the limiter
    return np.clip(x, -1, 1).astype(np.float32)


def _stream(sm, x, blocks):
    outs, i = [], 0
    for b in blocks:
        outs.append(np.asarray(sm.process(x[i:i + b])))
        i += b
    outs.append(np.asarray(sm.flush()))
    return np.concatenate(outs, axis=0)


def _offline(x, s: dict, gain_db: float) -> np.ndarray:
    """The port's offline quality chain, lufs replaced by a static gain
    (graph/chain._master_quality's wiring)."""
    ms = MasterSettings.from_dict(s)
    y = torch.from_numpy(x)
    if ms.analog_character:
        y = saturate.analog_character_quality(y, SR, ms.analog_character)
    y = eq.apply_eq_quality(y, SR, ms.bass_boost, ms.mid_cut,
                            ms.presence_boost, ms.treble_boost)
    if ms.width != 1.0:
        y = stereo.stereo_width_quality(y, ms.width)
    if ms.mb_edges is not None:
        y = multiband.multiband_quality_n(y, SR, ms.mb_edges,
                                          ms.mb_thresholds, ms.mb_ratios)
    elif ms.multiband:
        y = multiband.multiband_quality(
            y, SR, [ms.low_thresh, ms.mid_thresh, ms.high_thresh],
            [ms.low_ratio, ms.mid_ratio, ms.high_ratio])
    y = y * 10.0 ** (gain_db / 20.0)
    return limiter.lookahead_limiter(y, SR).numpy()


_RUNS = {}


def _runs(name, blocking):
    """(port stream, ame_tpu stream, port offline, port streamer), once a
    case: the JAX streamer's compiles are the slow part of this file."""
    key = (name, blocking)
    if key not in _RUNS:
        from ame_tpu.streaming import StreamingMaster as Ref
        blocks = BLOCKS[blocking]
        x = _program(sum(blocks))
        sm = StreamingMaster(SR, SETTINGS[name], gain_db=GAIN_DB,
                             device="cpu")
        ref = Ref(SR, SETTINGS[name], gain_db=GAIN_DB)
        got = _stream(sm, x, blocks)
        want = _stream(ref, x, blocks)
        assert sm.latency_samples == ref.latency_samples == sm.attack - 1
        _RUNS[key] = (got, want, _offline(x, SETTINGS[name], GAIN_DB), sm)
    return _RUNS[key]


@pytest.mark.parametrize("blocking", sorted(BLOCKS))
@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_stream_matches_reference_streamer(name, blocking):
    """Port stream vs ame_tpu's stream, same blocks: every input sample
    emitted by both, within 2e-4."""
    got, want, _, _ = _runs(name, blocking)
    assert got.shape == want.shape == (sum(BLOCKS[blocking]), 2)
    assert np.abs(got - want).max() <= 2e-4
    assert np.abs(want).max() > 0.4          # the hot section comes out


@pytest.mark.parametrize("blocking", sorted(BLOCKS))
@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_stream_matches_offline_chain(name, blocking):
    """Port stream vs the port's offline quality chain on the whole input:
    1e-4 plain, 2e-4 with multiband (tests/test_streaming.py's bounds)."""
    got, _, want, _ = _runs(name, blocking)
    assert got.shape == want.shape
    tol = 1e-4 if name == "plain" else 2e-4
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_stream_no_boundary_artifacts(name):
    """The handoff is exact: the error against the offline chain around a
    block boundary is no larger than anywhere else."""
    got, _, want, _ = _runs(name, "ragged")
    err = np.abs(got - want).max(axis=1)
    for b in np.cumsum(BLOCKS["ragged"])[:-1]:
        around = err[b - 64:b + 64].max()
        assert around <= max(err.max() + 1e-12, 1e-6)


def test_stream_input_validation():
    """tests/test_streaming.py's ValueError / RuntimeError cases."""
    sm = StreamingMaster(SR, {}, device="cpu")
    with pytest.raises(ValueError):
        sm.process(np.zeros((10, 2), np.float32))  # below 2x lookahead
    with pytest.raises(ValueError):
        sm.process(np.zeros((5000,), np.float32))
    sm.process(np.zeros((4096, 2), np.float32))
    sm.flush()
    with pytest.raises(RuntimeError):
        sm.process(np.zeros((4096, 2), np.float32))
    assert sm.flush().shape == (0, 2)


def test_stream_takes_tensors_and_empty_flush():
    """process takes a tensor as well as numpy and returns numpy; a stream
    flushed before any block emits nothing."""
    x = _program(2 * 4096)
    a = StreamingMaster(SR, SETTINGS["plain"], device="cpu")
    b = StreamingMaster(SR, SETTINGS["plain"], device="cpu")
    ya = _stream(a, x, [4096, 4096])
    yb = _stream(b, torch.from_numpy(x), [4096, 4096])
    assert isinstance(yb, np.ndarray) and np.array_equal(ya, yb)
    assert StreamingMaster(SR, {}, device="cpu").flush().shape == (0, 2)


def test_handoff_from_reference_streamer():
    """A mid-stream handoff: two blocks through ame_tpu's streamer, its
    state through ``convert.streaming_state`` into the port's, two more
    blocks and the flush there: equal to ame_tpu's streamer continuing,
    within 2e-4 (3-band multiband, so every state key crosses)."""
    from ame_tpu.streaming import StreamingMaster as Ref
    s = SETTINGS["mb3"]
    x = _program(4 * 4096)
    ref = Ref(SR, s, gain_db=GAIN_DB)
    head = [np.asarray(ref.process(x[i:i + 4096])) for i in (0, 4096)]
    state = convert.streaming_state(
        {k: np.asarray(v) for k, v in ref._state.items()}, device="cpu")
    sm = StreamingMaster(SR, s, gain_db=GAIN_DB, device="cpu")
    sm.resume(state)
    tail = _stream(sm, x[2 * 4096:], [4096, 4096])
    want = np.concatenate(head + [np.asarray(ref.process(x[i:i + 4096]))
                                  for i in (2 * 4096, 3 * 4096)]
                          + [np.asarray(ref.flush())])
    got = np.concatenate(head + [tail])
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() <= 2e-4


def test_streaming_state_checks_keys():
    """The conversion is a key check plus a move: a state with a key
    missing or one too many is refused; a compat limiter state keeps its
    two arrays and leaves its host constants to the port."""
    from ame_tpu.ops.limiter import alimiter_stream_init as ref_init
    sm = StreamingMaster(SR, SETTINGS["plain"], device="cpu")
    state = {k: v.numpy() for k, v in sm._state.items()}
    assert set(convert.streaming_state(state)) == set(state)
    with pytest.raises(ValueError, match="missing"):
        convert.streaming_state({k: v for k, v in state.items()
                                 if k != "zi_e"})
    with pytest.raises(ValueError, match="unexpected"):
        convert.streaming_state({**state, "zi_mb0": state["zi_a"]})
    lim = convert.streaming_state(ref_init(SR))
    assert set(lim) == {"pend", "carry"} and lim["carry"].shape == (6,)


def test_biquad_scan_carries_state():
    """``biquad_scan`` is a k = 1 sosfilt with zi [C, 2] in and zf [C, 2]
    out (the streaming attack smoother): two halves carried equal one
    call, and it matches ame_tpu's."""
    from ame_tpu.ops.scan_iir import biquad_scan as ref
    from ame_tpu_torch.ops.compressor import attack_sos
    coeffs = attack_sos(SR, 5.0)[0]
    u = np.abs(np.random.default_rng(1).standard_normal((3000, 3))).astype(
        np.float32)
    y, zf = biquad_scan(torch.from_numpy(u), coeffs)
    y1, z1 = biquad_scan(torch.from_numpy(u[:1234]), coeffs)
    y2, z2 = biquad_scan(torch.from_numpy(u[1234:]), coeffs, zi=z1)
    assert zf.shape == (3, 2)
    assert np.abs(torch.cat([y1, y2]).numpy() - y.numpy()).max() <= 1e-5
    assert np.abs(z2.numpy() - zf.numpy()).max() <= 1e-5
    y_r, zf_r = ref(jnp.asarray(u), jnp.asarray(coeffs))
    assert np.abs(y.numpy() - np.asarray(y_r)).max() <= 1e-5
    assert np.abs(zf.numpy() - np.asarray(zf_r)).max() <= 1e-5


def test_sosfilt_zf_chain_equals_one_call():
    """zf -> zi over 64 consecutive 512-sample blocks equals one call on
    the whole input within 1e-5, with no drift (the 4-band EQ and a
    16-band tree's 30-section top band, cut into pieces of 8)."""
    x = (0.3 * np.random.default_rng(2).standard_normal((64 * 512, 2))
         ).astype(np.float32)
    top = multiband._band_cascades_n(SR, tuple(np.geomspace(
        60.0, 16000.0, 15).round(1)))[-1]
    for sos in (eq.eq_quality_sos(SR, 2.0, 1.0, 1.5, -2.0), top):
        want, want_zf = sosfilt(sos, torch.from_numpy(x))
        zi, outs = None, []
        for i in range(0, x.shape[0], 512):
            y, zi = sosfilt(sos, torch.from_numpy(x[i:i + 512]), zi)
            outs.append(y)
        err = (torch.cat(outs) - want).abs().amax(dim=1).numpy()
        assert err.max() <= 1e-5
        assert err[-512:].max() <= max(4 * err[:512].max(), 1e-6)
        assert (zi - want_zf).abs().max() <= 1e-5


# ---------------------------------------------------------------------------
# The compat streamer and the compat limiter's streaming form
# ---------------------------------------------------------------------------

SRC = 16000  # keeps the 30 s block tractable on the CPU
COMPAT_PLAIN = dict(bass_boost=2.0, presence_boost=1.0, width=1.2,
                    analog_character=15.0, lufs=None, mode="compat",
                    compat_chunked=True)
COMPAT_MB = dict(multiband=True, low_thresh=-30.0, low_ratio=5.0,
                 mid_thresh=-25.0, mid_ratio=3.0, high_thresh=-22.0,
                 high_ratio=4.0, lufs=None, mode="compat",
                 compat_chunked=True)


def _compat_x(n, seed=2):
    """tests/test_streaming.py's compat input: two tones and noise with a
    slow swell, on the int16 grid."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SRC
    x = (0.2 * np.sin(2 * np.pi * 220 * t)
         + 0.1 * np.sin(2 * np.pi * 3000 * t)
         + 0.02 * rng.standard_normal(n))
    x *= 0.4 + 0.6 * np.sin(2 * np.pi * 0.25 * t) ** 2
    x = np.stack([x, 0.85 * x], axis=1).astype(np.float32)
    return (np.round(np.clip(x, -1, 1) * 32767) / 32768).astype(np.float32)


def _push(sm, x, step):
    outs = [sm.process(x[i:i + step]) for i in range(0, x.shape[0], step)]
    outs.append(sm.flush())
    return np.concatenate([o for o in outs if len(o)], axis=0)


def _held_to_blocks_bounds(err):
    """tests/test_streaming.py:203-206: a few LSBs on isolated samples."""
    assert err.max() <= 8.0 * LSB
    assert np.quantile(err, 0.999) <= LSB + 1e-6
    assert np.median(err) == 0.0


def test_compat_stream_matches_reference():
    """2.4 blocks of 30 s pushed in 100 000-sample pieces (not aligned to
    the block): against ame_tpu's compat streamer within 2/32768, under
    0.1 % of samples off by more than 1e-6; against the port's offline
    chunked compat chain within 1/32768 (tests/test_streaming.py's
    bounds)."""
    from ame_tpu.config import MasterSettings as RefSettings
    from ame_tpu.streaming import StreamingCompatMaster as Ref
    x = _compat_x(int(2.4 * 30 * SRC))
    got = _push(StreamingCompatMaster(SRC, MasterSettings(**COMPAT_PLAIN),
                                      device="cpu"), x, 100000)
    want = _push(Ref(SRC, RefSettings(**COMPAT_PLAIN)), x, 100000)
    assert got.shape == want.shape == x.shape
    err = np.abs(got - want)
    assert err.max() <= 2 * LSB and (err > 1e-6).mean() < 0.001
    off = master_graph(torch.from_numpy(x), SRC,
                       MasterSettings(**COMPAT_PLAIN))[0].numpy()
    err = np.abs(got - off)
    assert err.max() <= LSB + 1e-6 and (err > 1e-6).mean() < 0.001


def test_compat_stream_multiband_blocks():
    """1.5 blocks with the exact multiband (the gain engine per block):
    against the port's offline chunked chain and ame_tpu's streamer, each
    to tests/test_streaming.py:203-206's bounds."""
    from ame_tpu.config import MasterSettings as RefSettings
    from ame_tpu.streaming import StreamingCompatMaster as Ref
    x = _compat_x(int(1.5 * 30 * SRC), seed=9)
    sm = StreamingCompatMaster(SRC, MasterSettings(**COMPAT_MB),
                               device="cpu")
    got = np.concatenate([sm.process(x), sm.flush()], axis=0)
    assert sm.latency_samples == 30 * SRC + 16 * 80
    off = master_graph(torch.from_numpy(x), SRC,
                       MasterSettings(**COMPAT_MB))[0].numpy()
    assert got.shape == off.shape == x.shape
    _held_to_blocks_bounds(np.abs(got - off))
    ref = Ref(SRC, RefSettings(**COMPAT_MB))
    want = np.concatenate([ref.process(x), ref.flush()], axis=0)
    _held_to_blocks_bounds(np.abs(got - want))


@pytest.mark.parametrize("tail", [1, 31])
def test_compat_stream_short_tails(tail):
    """A flush after a whole block and a ``tail``-sample remainder: the
    remainder's block runs the compat stages and the gain engine on fewer
    samples than one 32-sample group, and the limiter drains; equal to the
    offline chunked chain within tests/test_streaming.py's bounds."""
    x = _compat_x(30 * SRC + tail, seed=4)
    sm = StreamingCompatMaster(SRC, MasterSettings(**COMPAT_MB),
                               device="cpu")
    got = _push(sm, x, 100000)
    off = master_graph(torch.from_numpy(x), SRC,
                       MasterSettings(**COMPAT_MB))[0].numpy()
    assert got.shape == off.shape == x.shape
    _held_to_blocks_bounds(np.abs(got - off))
    assert np.abs(got[-tail:] - off[-tail:]).max() <= LSB


def test_compat_short_stream():
    """A stream shorter than one block still masters, at flush."""
    x = _compat_x(2000)
    sm = StreamingCompatMaster(SRC, {"bass_boost": 1.0, "mode": "compat"},
                               device="cpu")
    assert sm.process(x).shape == (0, 2)
    out = sm.flush()
    assert out.shape == x.shape and np.isfinite(out).all()
    assert sm.flush().shape == (0, 2)
    with pytest.raises(RuntimeError):
        sm.process(x)


def test_compat_rejects_gband_and_bad_chunks():
    with pytest.raises(ValueError):
        StreamingCompatMaster(SR, {"mb_edges": (250.0, 2000.0)},
                              device="cpu")
    sm = StreamingCompatMaster(SR, {"mode": "compat"}, device="cpu")
    with pytest.raises(ValueError):
        sm.process(np.zeros((5000,), np.float32))


def _limiter_blocks():
    from tests.test_golden_ffmpeg import limiter_signal
    x = limiter_signal("hot_music")[: 1 << 15]
    return x, [3000, 1000, 9000, 4000, 15768]


def test_alimiter_stream_step_matches_reference():
    """The compat limiter's streaming form against ame_tpu's on the same
    blocks (one shorter than the hold, so it emits nothing), flush
    included: the same emitted lengths, within 1/32768; the stream within
    1/32768 of the offline ``alimiter_compat``."""
    from ame_tpu.ops import limiter as ref
    x, blocks = _limiter_blocks()
    st = limiter.alimiter_stream_init(SR)
    st_r = ref.alimiter_stream_init(SR)
    assert st["hold"] == st_r["hold"] == 16 * 220
    outs, i = [], 0
    for b in blocks + [0]:
        blk = x[i:i + b]
        y, st = limiter.alimiter_stream_step(torch.from_numpy(blk), st,
                                             flush=b == 0)
        y_r, st_r = ref.alimiter_stream_step(jnp.asarray(blk), st_r,
                                             flush=b == 0)
        assert y.shape == y_r.shape
        assert np.abs(y.numpy() - np.asarray(y_r)).max(initial=0.0) <= LSB
        assert np.abs(st["carry"].numpy() - np.asarray(st_r["carry"])
                      ).max() <= 1e-5 * max(np.abs(st_r["carry"]).max(), 1)
        outs.append(y.numpy())
        i += b
    got = np.concatenate(outs)
    assert outs[0].shape == (0, 2)
    off = limiter.alimiter_compat(torch.from_numpy(x), SR).numpy()
    assert got.shape == off.shape and np.abs(got - off).max() <= LSB


def test_alimiter_stream_handoff_from_reference():
    """The compat limiter's state handed over mid-stream: one block in
    ame_tpu's form, ``convert.streaming_state`` into the port's
    ``alimiter_stream_init`` state, the rest in the port's form: equal to
    ame_tpu's continuing within 1/32768."""
    from ame_tpu.ops import limiter as ref
    x, blocks = _limiter_blocks()
    st_r = ref.alimiter_stream_init(SR)
    y0, st_r = ref.alimiter_stream_step(jnp.asarray(x[:blocks[0] + 5000]),
                                        st_r)
    st = {**limiter.alimiter_stream_init(SR),
          **convert.streaming_state(st_r)}
    rest = x[blocks[0] + 5000:]
    y1, _ = limiter.alimiter_stream_step(torch.from_numpy(rest), st,
                                         flush=True)
    y1_r, _ = ref.alimiter_stream_step(jnp.asarray(rest), st_r, flush=True)
    assert y1.shape == y1_r.shape and np.asarray(y0).shape[0] > 0
    assert np.abs(y1.numpy() - np.asarray(y1_r)).max() <= LSB


def test_alimiter_depth_zero_carry_equals_no_carry():
    """The carry route (release side on the per-piece scans, attack side
    the same envelope as offline) at a zero carry equals the no-carry
    route within 1e-6."""
    x, _ = _limiter_blocks()
    peak = np.abs(x).max(axis=1)
    dep = torch.from_numpy(np.maximum(0.0, 1.0 - 0.98 / np.maximum(
        peak, 1e-9)).astype(np.float32))
    pr, pa = limiter._wedge_pieces(2205.0), limiter._wedge_pieces(220.0)
    d0, s0 = limiter._alimiter_depth(dep, pr, pa)
    d1, s1 = limiter._alimiter_depth(dep, pr, pa, rel_carry=torch.zeros(6))
    assert s0 is None and s1.shape == (6, dep.shape[0])
    assert (d1 - d0).abs().max() <= 1e-6 and d0.max() > 0.5


# ---------------------------------------------------------------------------
# The kernels' designs at stream lengths (float32 emulations on the CPU;
# chip_smoke.py holds the kernels themselves on the card)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 63, 440, 4097])
def test_k5_design_at_block_lengths(n):
    """K5's decomposition at the card's stereo geometry on a block shorter
    than one tile (all but a few sub-block threads masked; zf from the
    last sample's thread), from a non-zero zi: y and zf within 2e-5 of the
    plain version."""
    from tests.test_torch_cascade_scan import _emulate_kernel
    from ame_tpu_torch.ops import cascade_scan
    from ame_tpu_torch.ops.tile_conv import sosfilt_tileconv
    sos = eq.eq_quality_sos(SR, 2.0, 1.0, 1.5, -2.0)
    rng = np.random.default_rng(n)
    x = (0.3 * rng.standard_normal((n, 2))).astype(np.float32)
    _, zi = sosfilt_tileconv(sos, torch.from_numpy(
        (0.3 * rng.standard_normal((777, 2))).astype(np.float32)))
    logP = cascade_scan._geometry(2)[1]
    y, zf = _emulate_kernel(sos, x, zi.numpy(), logP, 32, 32)
    y_p, zf_p = sosfilt_tileconv(sos, torch.from_numpy(x), zi)
    assert np.abs(y - y_p.numpy()).max() <= 2e-5
    assert np.abs(zf - zf_p.numpy()).max() <= 2e-5


@pytest.mark.parametrize("n", [1, 31, 2000, 3520])
def test_k1_reverse_design_at_stream_lengths(n):
    """K1's reverse direction (the streaming limiter's attack side) at its
    own geometry on depth arrays of a short flush tail up to the hold
    (16·A = 3520 at 44.1 kHz), all inside one 8192-sample tile: within
    1e-5 of the plain version."""
    from tests.test_torch_compat_ops import _wedge_depths, _wedge_tiled
    from ame_tpu_torch.ops import wedge_env as wk
    pieces = limiter._wedge_pieces(220.0)
    dep = _wedge_depths(n, seed=n + 5)
    dep[n // 2] = 0.7                            # one deep sample at least
    sub, log_tp, _ = wk._geometry(n)
    got = _wedge_tiled(dep, pieces, True, sub, log_tp, wk._CARRY_THREADS)
    want = wk.wedge_env_plain(torch.from_numpy(dep), pieces, True).numpy()
    assert np.abs(got - want).max() <= 1e-5
