"""The port's compat-mode ops (filter design, quantize, blend EQ, analog
character, width, the pydub detector window, the ffmpeg-contract alimiter
and its wedge envelope) against their ame_tpu counterparts on the same numpy
inputs. All on the CPU, where every stage runs its plain PyTorch version."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ame_tpu_torch.dsp import design
from ame_tpu_torch.ops import (compressor, eq, limiter, quantize, saturate,
                               stereo, window)
from ame_tpu_torch.ops.scan_iir import sosfilt
from tests.conftest import make_test_signal

SR = 44100
LSB = 1.0 / 32768.0


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _int16_grid(x):
    return (np.trunc(np.clip(x, -1, 1) * 32767.0) / 32768.0).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Filter design (numpy/scipy float64 on both sides)
# ---------------------------------------------------------------------------

DESIGNS = {
    "butter_ba_low": lambda d: np.concatenate(d.butter_ba(2, 0.0113, "low")),
    "butter_ba_high": lambda d: np.concatenate(d.butter_ba(2, 0.54, "high")),
    "butter_sos_low": lambda d: d.butter_sos(4, 250.0, "lowpass", fs=SR),
    "butter_sos_high": lambda d: d.butter_sos(4, 4000.0, "highpass", fs=SR),
    "peak_band_1k": lambda d: d.reference_peak_band_sos(SR, 1000.0),
    "peak_band_q14": lambda d: d.reference_peak_band_sos(8000.0, 4000.0),
    "shelf_biquad": lambda d: d._shelf_biquad(SR, 1500.0, 3.0, 0.7),
    "k_dynamic_44k": lambda d: d.k_weighting_dynamic_sos(44100.0),
    "k_dynamic_48k": lambda d: d.k_weighting_dynamic_sos(48000.0),
}


@pytest.mark.parametrize("name", sorted(DESIGNS))
def test_design_matches_reference(name):
    """The jax-free copies design the same float64 coefficients."""
    from ame_tpu.dsp import design as ref
    np.testing.assert_allclose(DESIGNS[name](design), DESIGNS[name](ref),
                               rtol=1e-12, atol=1e-15)


def test_q14_clamped_bandpass_stays_in_kernel_tolerance():
    """Quirk Q14: at 8 kHz the 4 kHz presence band's upper edge clamps to
    0.999999 of Nyquist, so its top pole pair sits next to z = -1. The
    port's f32 cascade (the plain version of the CUDA kernel, same
    section forms) stays within the kernels' 1e-4 of float64 scipy and of
    the reference's f32 scan."""
    from scipy.signal import sosfilt as scipy_sosfilt
    from ame_tpu.ops.scan_iir import sosfilt_scan
    sos = design.reference_peak_band_sos(8000.0, 4000.0)
    assert np.abs(np.roots(sos[-1, 3:])).max() > 0.999   # the clamp binds
    x = make_test_signal("noise", 1 << 14, 8000)
    exact = scipy_sosfilt(sos, x.astype(np.float64), axis=0)
    got, _ = sosfilt(sos, _t(x))
    ref, _ = sosfilt_scan(sos, jnp.asarray(x))
    assert np.abs(got.numpy() - exact).max() <= 1e-4
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-4


# ---------------------------------------------------------------------------
# int16 round trip (quirks Q5, Q7)
# ---------------------------------------------------------------------------

def test_quantize_ops_match_reference_exactly():
    from ame_tpu.ops import quantize as ref
    rng = np.random.default_rng(1)
    x = (1.2 * rng.standard_normal((4096, 2))).astype(np.float32)
    a = np.trunc(rng.uniform(-32768, 32767, (4096, 2))).astype(np.float32)
    b = np.trunc(rng.uniform(-32768, 32767, (4096, 2))).astype(np.float32)
    np.testing.assert_array_equal(quantize.int16_roundtrip(_t(x)).numpy(),
                                  np.asarray(ref.int16_roundtrip(
                                      jnp.asarray(x))))
    np.testing.assert_array_equal(quantize.int16_to_float(_t(a)).numpy(),
                                  np.asarray(ref.int16_to_float(
                                      jnp.asarray(a))))
    np.testing.assert_array_equal(
        quantize.saturating_add_int16(_t(a), _t(b)).numpy(),
        np.asarray(ref.saturating_add_int16(jnp.asarray(a), jnp.asarray(b))))


# ---------------------------------------------------------------------------
# Compat EQ, analog character, width: within 1 int16 LSB after the round
# trip each stage ends in
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gains", [(2.0, 0.0, 1.5, 0.0),
                                   (-3.0, 2.0, -1.0, 4.0),
                                   (0.0, -1.5, 0.0, -2.0)],
                         ids=["boost", "mixed_q1", "negative_q1"])
def test_apply_eq_compat_matches_reference(gains):
    """Blend EQ incl. the Q1 negative-gain collapse and the Q3 negated mid
    cut; zero gains are skipped on the host, as the reference does."""
    from ame_tpu.ops.eq import apply_eq_compat as ref
    x = _int16_grid(make_test_signal("noise", 1 << 14, SR))
    want = np.asarray(ref(jnp.asarray(x), float(SR),
                          *(jnp.float32(g) for g in gains)))
    got = eq.apply_eq_compat(_t(x), SR, *gains)
    diff = np.abs(quantize.int16_roundtrip(got).numpy()
                  - _int16_grid(want))
    assert diff.max() <= LSB, diff.max()


@pytest.mark.parametrize("percent", [20.0, 100.0])
def test_analog_character_compat_matches_reference(percent):
    from ame_tpu.ops.saturate import analog_character_compat as ref
    x = _int16_grid(make_test_signal("sweep", 1 << 14, SR))
    want = np.asarray(ref(jnp.asarray(x), float(SR), jnp.float32(percent)))
    got = saturate.analog_character_compat(_t(x), SR, percent)
    diff = np.abs(quantize.int16_roundtrip(got).numpy()
                  - _int16_grid(want))
    assert diff.max() <= LSB, diff.max()


@pytest.mark.parametrize("width", [0.5, 1.8])
def test_stereo_width_clips_like_reference(width):
    from ame_tpu.ops.stereo import stereo_width as ref
    x = make_test_signal("noise", 4096, SR) * 3.0      # hits the clip
    want = np.asarray(ref(jnp.asarray(x), jnp.float32(width)))
    got = stereo.stereo_width(_t(x), width).numpy()
    assert np.abs(got).max() <= 1.0
    assert np.abs(got - want).max() <= 1e-6
    mono = _t(x[:, :1])
    assert stereo.stereo_width(mono, width) is mono


# ---------------------------------------------------------------------------
# The pydub detector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 220, 1500])
def test_windowed_sum_exclusive_matches_reference(w):
    from ame_tpu.ops.window import windowed_sum_exclusive as ref
    x = np.abs(make_test_signal("noise", 5000, SR)[:, 0]) * 1000.0
    want = np.asarray(ref(jnp.asarray(x), w))
    got = window.windowed_sum_exclusive(_t(x), w).numpy()
    assert np.all(got[:w] == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("thresh,ratio", [(-20.0, 4.0), (-25.0, 6.0)])
def test_pydub_detector_matches_reference(thresh, ratio):
    """Integer rms and max-attenuation (within 1e-5 dB) as the reference
    computes them. The f32 window sums of squared int16 samples (~1e11)
    are rounded in another summation order on each side, so the floored
    rms may flip by one on a handful of samples (tests/test_compressor.py
    allows the same against its oracle); there only, max_att moves with
    it."""
    from ame_tpu.ops.compressor import pydub_detector as ref
    x = make_test_signal("noise", 1 << 14, SR) * 0.05
    x[5000:11000] *= 12.0
    x_int = np.trunc(np.clip(x, -1, 1) * 32767.0).astype(np.float32)
    rms_r, att_r, th_r = ref(jnp.asarray(x_int), float(SR), thresh, ratio)
    rms, att, th = compressor.pydub_detector(_t(x_int), SR, thresh, ratio)
    rms_r, att_r = np.asarray(rms_r), np.asarray(att_r)
    same = rms.numpy() == rms_r
    assert np.abs(rms.numpy() - rms_r).max() <= 1.0
    assert same.mean() > 0.999
    assert np.abs(att.numpy() - att_r)[same].max() <= 1e-5
    assert th == pytest.approx(float(th_r), rel=1e-7)
    assert att.numpy().max() > 0.0


# ---------------------------------------------------------------------------
# The ffmpeg-contract alimiter and its wedge envelope (K1's plain version)
# ---------------------------------------------------------------------------

def _limiter_signal(kind):
    from tests.test_golden_ffmpeg import limiter_signal
    return limiter_signal(kind)


def test_alimiter_compat_matches_reference():
    """Port vs ame_tpu's alimiter_compat (the 12-scan form off the TPU):
    within 1/32768 on the output, 1e-5 on the gain."""
    from ame_tpu.ops.limiter import alimiter_compat as ref
    x = _limiter_signal("hot_music")[: 1 << 16]
    y_r, g_r = ref(jnp.asarray(x), float(SR), return_gain=True)
    y, g = limiter.alimiter_compat(_t(x), SR, return_gain=True)
    assert np.abs(y.numpy() - np.asarray(y_r)).max() <= LSB
    assert np.abs(g.numpy() - np.asarray(g_r)).max() <= 1e-5
    assert g.numpy().min() < 0.9                          # it limits


def test_alimiter_depth_release_carry_matches_reference():
    """The streaming form of the depth envelope (``rel_carry``: the plain
    scans re-seeded from the previous block's per-piece release states):
    a second block carried from the first against ame_tpu's: the depth
    within 1e-5, the per-piece forward scans (scaled by piece gains up to
    ~1e7) within 1e-5 relative; and the carried depth within 1e-5 of the
    unsplit track's."""
    from ame_tpu.ops.limiter import _alimiter_depth as ref
    x = _limiter_signal("hot_music")[: 1 << 14]
    peak = np.abs(x).max(axis=1)
    dep = np.maximum(0.0, 1.0 - 0.98 / np.maximum(peak, 1e-9)).astype(
        np.float32)
    pr, pa = limiter._wedge_pieces(2205.0), limiter._wedge_pieces(220.0)
    h = dep.shape[0] // 2
    carry = np.asarray(ref(jnp.asarray(dep[:h]), pr, pa)[1])[:, -1]
    assert carry.max() > 0.0
    d_r, s_r = ref(jnp.asarray(dep[h:]), pr, pa, rel_carry=jnp.asarray(carry))
    d, s = limiter._alimiter_depth(_t(dep[h:]), pr, pa, rel_carry=_t(carry))
    assert np.abs(d.numpy() - np.asarray(d_r)).max() <= 1e-5
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-5, atol=0)
    d_full, _ = limiter._alimiter_depth(_t(dep), pr, pa)
    assert np.abs(d.numpy() - d_full.numpy()[h:]).max() <= 1e-5
    assert d.numpy().max() > 0.5


@pytest.mark.parametrize("kind", ("hot_music", "impulses", "bursts"))
def test_alimiter_compat_matches_ffmpeg_fixture(kind):
    """The recorded real-filter alimiter numbers, held as
    tests/test_golden_ffmpeg.py holds ame_tpu: peak within 2e-3 and the
    1024-block RMS envelope within the fixture's bound."""
    import json
    import os
    fx_path = os.path.join(os.path.dirname(__file__), "fixtures",
                           "golden_ffmpeg.json")
    with open(fx_path) as f:
        fx = json.load(f)["limiter"][kind]
    x = _limiter_signal(kind)
    ours = limiter.alimiter_compat(_t(x), SR).numpy()
    assert abs(np.abs(ours).max() - fx["peak"]) < 2e-3
    env_ff = np.asarray(fx["block_rms"], np.float32)
    nb = min(len(ours) // 1024, len(env_ff))
    env = np.sqrt((ours[:nb * 1024, 0].reshape(nb, 1024) ** 2).mean(1))
    err = 20 * np.log10((env + 1e-6) / (env_ff[:nb] + 1e-6))
    assert np.abs(err).max() < fx["env_bound_db"], np.abs(err).max()


def test_wedge_pieces_match_reference():
    from ame_tpu.ops.limiter import _wedge_pieces as ref
    for width in (220.0, 2205.0):
        assert limiter._wedge_pieces(width) == ref(width)


def _wedge_tiled(dep, pieces, reverse, sub, log_tp, carry_threads):
    """float32 numpy emulation of csrc/wedge_env.cu's decomposition, on the
    exact f32 pieces and power table the kernel receives. Tiles of 2^log_tp
    rows x ``sub`` samples sit at multiples of the tile in memory (zero
    past n; REVERSE walks the mirrored tiles and rows). (1) Each row is
    walked from zero state; the row ends are scanned inside the tile: a
    shuffle scan in each 32-row warp with rho^(sub*2^l), the earlier warps'
    totals folded with rho^(32*sub) and added with rho^(sub*(lane+1)).
    (2) The tile totals are scanned in chunks of ``carry_threads``: thread
    0 folds in the chunk's carry-in with rho^T, a shuffle scan in each warp
    with rho^(T*2^l), warp 0 scans the warp totals with rho^(32*T*2^l),
    and each lane adds the earlier warps' prefix with rho^(T*(lane+1)).
    (3) Each row is re-walked from max(S_{j-1}, rho^(sub*j) c_b)."""
    from ame_tpu_torch.ops import wedge_env as wk
    f32 = np.float32
    pieces = tuple(pieces)
    P, n, tp = len(pieces), dep.shape[0], 1 << log_tp
    T = sub * tp
    nb = -(-n // T)
    a, rho = wk._piece_arrays(pieces)
    pw = wk._power_table(pieces, sub, log_tp)[:, :P]
    row_t, row_w = tp + 1, tp + 34
    up = np.zeros(nb * T, f32)
    up[:n] = dep
    x = up.reshape(nb, tp, sub)
    if reverse:
        x = x[::-1, ::-1, ::-1]
    lanes = np.arange(32)

    def shuffle_scan(v, rows):          # in-warp Hillis-Steele over axis -2
        for l, r in enumerate(rows):
            off = 1 << l
            v[..., off:, :] = np.maximum(v[..., off:, :],
                                         pw[r] * v[..., :-off, :])
        return v

    # 1. rows from zero, then the scan inside the tile
    s = np.zeros((nb, tp, P), f32)
    for i in range(sub):
        s = np.maximum(x[:, :, i, None], rho * s)
    s = shuffle_scan(s.reshape(nb, tp // 32, 32, P), [1, 2, 4, 8, 16])
    wt = s[:, :, 31].copy()
    c = np.zeros((nb, P), f32)
    for w in range(1, tp // 32):
        c = np.maximum(wt[:, w - 1], pw[32] * c)
        s[:, w] = np.maximum(s[:, w], pw[lanes + 1] * c[:, None])
    S = s.reshape(nb, tp, P)
    # 2. the carries across tiles
    E, C, cin = S[:, tp - 1], np.zeros((nb, P), f32), np.zeros(P, f32)
    W = carry_threads // 32
    for base in range(0, nb, carry_threads):
        v = np.zeros((carry_threads, P), f32)
        cnt = max(0, min(carry_threads, nb - 1 - base))
        v[:cnt] = E[base:base + cnt]
        v[0] = np.maximum(v[0], pw[row_t + 1] * cin)
        v = shuffle_scan(v.reshape(W, 32, P),
                         [row_t + (1 << l) for l in range(5)])
        xw = np.zeros((32, P), f32)
        xw[:W] = v[:, 31]
        xw = shuffle_scan(xw, [row_w + l for l in range(5)])
        v[1:] = np.maximum(v[1:], pw[row_t + 1 + lanes] * xw[:W - 1, None])
        v = v.reshape(carry_threads, P)
        b = base + np.arange(carry_threads)
        C[b[b + 1 < nb] + 1] = v[b + 1 < nb]
        cin = v[-1]
    # 3. every row re-walked from its start state
    prev = np.zeros_like(S)
    prev[:, 1:] = S[:, :-1]
    s = np.maximum(prev, pw[:tp] * C[:, None])
    env = np.empty((nb, tp, sub), f32)
    for i in range(sub):
        s = np.maximum(x[:, :, i, None], rho * s)
        env[:, :, i] = np.min(a * s, axis=-1)
    if reverse:
        env = env[::-1, ::-1, ::-1]
    return env.reshape(-1)[:n]


def _wedge_depths(n, seed):
    """Compat depths of |N(0,1)| peaks: zero below 0.98, up to ~0.8."""
    peak = np.abs(np.random.default_rng(seed).standard_normal(n))
    return np.maximum(0.0, 1.0 - 0.98 / np.maximum(peak, 1e-9)).astype(
        np.float32)


# (pieces' width, reverse): the chain's release and attack sides, and the
# long release wedge run backwards, whose carries cross many tiles
WEDGE_SIDES = {"release": (2205.0, False), "attack": (220.0, True),
               "release_reversed": (2205.0, True)}


@pytest.mark.parametrize("n", [20, 777, 8192, 8193, 2 * 8192 + 5 * 32 + 7,
                               3 * 8192 + 1234],
                         ids=["sub_block", "one_tile_ragged", "one_tile",
                              "tile_plus_1", "two_tiles_ragged",
                              "three_tiles_ragged"])
@pytest.mark.parametrize("side", sorted(WEDGE_SIDES))
def test_wedge_env_tiled_matches_plain(side, n):
    """K1's decomposition at the kernel's own geometry (32-sample rows, 256
    rows a tile, 1024-tile carry chunks), emulated in float32 numpy,
    against the plain 12-scan form within the 1e-5 the card is held to:
    shorter than a row, inside one tile, exactly one tile, a tile + 1, and
    several tiles with a ragged end."""
    from ame_tpu_torch.ops import wedge_env as wk
    width, reverse = WEDGE_SIDES[side]
    pieces = limiter._wedge_pieces(width)
    dep = _wedge_depths(n, seed=n)
    sub, log_tp, _ = wk._geometry(n)
    got = _wedge_tiled(dep, pieces, reverse, sub, log_tp, wk._CARRY_THREADS)
    want = wk.wedge_env_plain(_t(dep), pieces, reverse).numpy()
    assert np.abs(got - want).max() <= 1e-5
    assert want.max() > 0.1


@pytest.mark.parametrize("side", ["release", "attack"])
def test_wedge_env_tiled_matches_reference_kernel(side):
    """The same emulation against ame_tpu's Pallas wedge kernel
    (``_wedge_env``, run in the interpreter) on 70000 samples: two of its
    [128, 512] tiles, nine of the port's."""
    from ame_tpu.ops.limiter import _wedge_env as ref
    from ame_tpu_torch.ops import wedge_env as wk
    width, reverse = WEDGE_SIDES[side]
    pieces = limiter._wedge_pieces(width)
    dep = _wedge_depths(70000, seed=11)
    want = np.asarray(ref(jnp.asarray(dep), pieces, reverse, interpret=True))
    sub, log_tp, _ = wk._geometry(dep.shape[0])
    got = _wedge_tiled(dep, pieces, reverse, sub, log_tp, wk._CARRY_THREADS)
    assert np.abs(got - want).max() <= 1e-5
    assert want.max() > 0.5


@pytest.mark.parametrize("n", [3, 256, 257, 129 * 256 - 100],
                         ids=["sub_block", "one_tile", "tile_plus_1",
                              "three_chunks"])
@pytest.mark.parametrize("side", sorted(WEDGE_SIDES))
def test_wedge_env_tiled_small_geometry_matches_plain(side, n):
    """The same decomposition at a small geometry (4-sample rows, 64 rows in
    two warps a tile, 64-tile carry chunks in two warps), so the warp fold,
    the lane powers and the chunk carry-in all run at test size: 129 tiles
    make three chunks."""
    width, reverse = WEDGE_SIDES[side]
    pieces = limiter._wedge_pieces(width)
    dep = _wedge_depths(n, seed=n + 1)
    from ame_tpu_torch.ops.wedge_env import wedge_env_plain
    got = _wedge_tiled(dep, pieces, reverse, 4, 6, 64)
    want = wedge_env_plain(_t(dep), pieces, reverse).numpy()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("width", [220.0, 240.0, 2205.0, 2400.0])
def test_wedge_power_table_is_the_rounded_float64_power(width):
    """Every entry of K1's power table lies in [0, 1] and is the float64
    power of the f32 rho the walks use, rounded to f32 once: rho^(SUB*j)
    for j <= 256, rho^(T*k) for k <= 32, rho^(32*T*2^l) for l < 5 (44.1
    and 48 kHz attack and release widths)."""
    from ame_tpu_torch.ops import wedge_env as wk
    pieces = limiter._wedge_pieces(width)
    sub, log_tp, _ = wk._geometry(1)
    table = wk._power_table(pieces, sub, log_tp)
    tp = 1 << log_tp
    T = sub * tp
    assert table.shape == (tp + 39, wk._PW) and table.dtype == np.float32
    assert np.all(table >= 0.0) and np.all(table <= 1.0)
    assert np.all(table[:, len(pieces):] == 0.0)
    rho = np.float32([r for _, r in pieces]).astype(np.float64)
    exps = ([sub * j for j in range(tp + 1)] + [T * k for k in range(33)]
            + [32 * T * 2 ** l for l in range(5)])
    for row, e in zip(table, exps):
        np.testing.assert_array_equal(row[:len(pieces)],
                                      (rho ** e).astype(np.float32))
    assert np.all(table[0, :len(pieces)] == 1.0)
    assert np.all(table[tp + 1, :len(pieces)] == 1.0)


def test_wedge_env_geometry():
    """K1's tiles: 32-sample rows (one walker each), 256 rows = 8 warps a
    tile (8192 samples, 32 KB), tiles counted up to the ragged end; the
    carry scan takes 1024 tiles a chunk, so the main path's [2^23 + 1234]
    makes 1025 tiles in two chunks and 2^18 walkers per pass."""
    from ame_tpu_torch.ops import wedge_env as wk
    assert wk._geometry((1 << 23) + 1234) == (32, 8, 1025)
    assert wk._geometry(1 << 23)[2] == 1024
    for n in (1, 31, 32, 8191, 8192, 8193, 100000):
        sub, log_tp, nb = wk._geometry(n)
        tile = sub << log_tp
        assert (nb - 1) * tile < n <= nb * tile
        assert (1 << log_tp) % 32 == 0 and tile * 4 == 32 * 1024
    assert wk._CARRY_THREADS % 32 == 0 and wk._CARRY_THREADS // 32 <= 32


def test_cuda_wrappers_raise_on_cpu_tensors():
    """No wrapper falls back to its plain version: a CPU tensor raises and
    counts no launch."""
    from ame_tpu_torch.ops import pydub_gain as pg
    from ame_tpu_torch.ops.wedge_env import wedge_env_cuda
    pieces = limiter._wedge_pieces(220.0)
    m, c = torch.zeros(3, 64), torch.zeros(3)
    calls = [
        (wedge_env_cuda, lambda: wedge_env_cuda(torch.zeros(64), pieces,
                                                False)),
        (pg.gain_p1_cuda, lambda: pg.gain_p1_cuda(m, None, c, 0.1, 0.01)),
        (pg.gain_p2_cuda, lambda: pg.gain_p2_cuda(m, torch.zeros(3, 2),
                                                  0.1, 0.01)),
        (pg.gain_jacobi_cuda, lambda: pg.gain_jacobi_cuda(
            torch.zeros(64, 3), c, 0.1, 0.01, True)),
    ]
    for fn, call in calls:
        before = fn.launches
        with pytest.raises(ValueError, match="CUDA"):
            call()
        assert fn.launches == before
