"""The quality limiter's kernel, host side (``ops/limiter.py``,
``csrc/lookahead_limiter.cu``): a float32 numpy emulation of the kernel's
decomposition (halo'd tiles, min-ahead by doubling, float64 prefix sums,
8-frame walks, the block's carry, the carry across tiles with the power
table) against the plain limiter; the power table; the geometry; and that
a CPU tensor still runs the plain path. No JAX: the plain path is held to
``ame_tpu`` by ``tests/test_torch_ops.py``."""

import math

import numpy as np
import pytest
import torch

from ame_tpu_torch.ops import limiter

SR = 44100


def _signal(n: int, c: int, seed: int) -> np.ndarray:
    """Noise that the limiter leaves alone in places, with clicks and a hot
    stretch that drive the gain down."""
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal((n, c))
    for at in rng.integers(0, n, size=max(n // 700, 1)):
        x[at] *= 12.0
    x[n // 3: n // 3 + n // 10] *= 5.0
    return x.astype(np.float32)


def _limiter_tiled(x: np.ndarray, w: int, rho: float, ceiling: float,
                   tile: int = limiter._LIM_TILE, chunk: int = 8):
    """The kernel's arithmetic in numpy: returns (y, gain). The block's
    scan of chunk ends is a sequential fold here (the kernel's shuffle scan
    re-associates it); the tiles' carries are each tile's inclusive state,
    as when every look-back meets a finished predecessor."""
    n = x.shape[0]
    r32 = np.float32(rho)
    pw = (np.float64(r32) ** np.arange(tile + 1, dtype=np.float64)
          ).astype(np.float32)
    pw_tile = pw[tile]
    peak = np.abs(x).max(axis=1)
    gt = np.minimum(np.float32(1.0), np.float32(ceiling)
                    / np.maximum(peak, np.float32(1e-9))).astype(np.float32)
    G, R = tile + 2 * (w - 1), tile + w - 1
    gain = np.empty(n, np.float32)
    carry = np.float32(0.0)
    for t in range(-(-n // tile)):
        s = t * tile
        f = s - (w - 1) + np.arange(G)
        m = np.where((f >= 0) & (f < n), gt[np.clip(f, 0, n - 1)],
                     np.float32(1.0)).astype(np.float32)
        span = 1
        while 2 * span <= w:
            lim = G - 2 * span + 1
            m = np.concatenate([np.minimum(m[:lim], m[span:span + lim]),
                                m[lim:]])
            span *= 2
        ga = np.minimum(m[:R], m[w - span:w - span + R])
        P = np.cumsum(np.where(f[:R] >= 0, ga, 0.0).astype(np.float64))
        i = np.arange(tile)
        S = P[i + w - 1] - np.where(i > 0, P[np.maximum(i - 1, 0)], 0.0)
        count = np.minimum(s + i + 1, w).astype(np.float64)
        d = np.float32(1.0) - (S / count).astype(np.float32)
        u = np.empty(tile, np.float32)
        cin = np.float32(0.0)
        for c0 in range(0, tile, chunk):
            e = np.float32(0.0)
            for k in range(chunk):
                e = max(d[c0 + k], np.float32(r32 * e))
                u[c0 + k] = max(e, np.float32(pw[k + 1] * cin))
            cin = max(e, np.float32(pw[chunk] * cin))
        agg = u[-1]
        u = np.maximum(u, (pw[1:tile + 1] * carry).astype(np.float32))
        nv = min(tile, n - s)
        gain[s:s + nv] = np.float32(1.0) - u[:nv]
        carry = max(agg, np.float32(pw_tile * carry))
    return x * gain[:, None], gain


def _plain(x: np.ndarray, w: int, rho: float, ceiling: float = 0.98):
    y, g = limiter.lookahead_limiter_plain(torch.from_numpy(x), w, rho,
                                           ceiling, return_gain=True)
    return y.numpy(), g.numpy()


@pytest.mark.parametrize("n, c, w, tile", [
    (1, 2, 220, 64), (219, 2, 220, 64), (441, 1, 220, 64),
    (3000, 2, 220, 64), (3001, 3, 240, 128), (2500, 2, 480, 256),
    (1000, 2, 1, 64), (1000, 2, 5, 64), (700, 2, 64, 64),
    (3 * 4096 + 5, 2, 220, 4096),
])
def test_tiled_limiter_matches_plain(n, c, w, tile):
    """The kernel's decomposition equals the plain limiter within 1e-5 on
    y and gain, at tile sizes below, at and above the attack window, on
    one, two and three channels, from one frame to several tiles."""
    rho = math.exp(-1.0 / (50.0 * SR / 1000.0))
    x = _signal(n, c, seed=n + w)
    y, g = _limiter_tiled(x, w, rho, 0.98, tile=tile)
    y_p, g_p = _plain(x, w, rho)
    assert np.abs(g - g_p).max() <= 1e-5
    assert np.abs(y - y_p).max() <= 1e-5
    if n > 1000:
        assert g.min() < 0.5             # the clicks drove the gain down


@pytest.mark.parametrize("release_ms, sr", [(50.0, 44100), (50.0, 48000),
                                            (50.0, 96000), (1000.0, 44100)])
def test_limiter_power_table_is_the_rounded_float64_power(release_ms, sr):
    """Row j <= TILE is rho^j and row TILE + 1 + d is rho^(TILE·d), each the
    float64 power of the f32 rho rounded to f32 once, in [0, 1]."""
    rho = math.exp(-1.0 / (release_ms * sr / 1000.0))
    T, L = limiter._LIM_TILE, limiter._LIM_LOOKBACK
    table = limiter._limiter_power_table(float(np.float32(rho)))
    assert table.shape == (T + 1 + L,) and table.dtype == np.float32
    assert np.all(table >= 0.0) and np.all(table <= 1.0)
    r = np.float64(np.float32(rho))
    np.testing.assert_array_equal(
        table[:T + 1], (r ** np.arange(T + 1, dtype=np.float64))
        .astype(np.float32))
    np.testing.assert_array_equal(
        table[T + 1:], (r ** (T * np.arange(L, dtype=np.float64)))
        .astype(np.float32))
    assert table[0] == 1.0 and table[T + 1] == 1.0
    assert table[T] == table[T + 2]          # rho^TILE both ways


def test_limiter_geometry():
    """Tiles of 4096 frames up to the ragged end, a status word each and the
    counter; 8 frames a thread; the look-back table reaches past every
    block an H100 (132 SMs of 2048 threads) can hold, and a card of 1024
    such SMs is refused."""
    T = limiter._LIM_TILE
    for n in (1, T - 1, T, T + 1, (1 << 23) + 1234, 15_567_300):
        tiles, words = limiter._limiter_geometry(n)
        assert (tiles - 1) * T < n <= tiles * T and words == tiles + 1
    assert T // limiter._LIM_THREADS == 8
    assert limiter._lookback_fits(132, 2048)
    assert not limiter._lookback_fits(1024, 2048)


def test_cpu_tensor_runs_the_plain_path(monkeypatch):
    """On a CPU tensor ``lookahead_limiter`` is the plain version bit for
    bit and never reaches the kernel's wrapper; the wrapper raises on a
    CPU tensor and counts nothing."""
    def no_kernel(*a, **k):
        raise AssertionError("the kernel's wrapper ran on a CPU tensor")
    x = torch.from_numpy(_signal(5000, 2, seed=3))
    before = limiter.lookahead_limiter_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        limiter.lookahead_limiter_cuda(x, 220, 0.9995)
    monkeypatch.setattr(limiter, "lookahead_limiter_cuda", no_kernel)
    y, g = limiter.lookahead_limiter(x, SR, return_gain=True)
    w = int(5.0 * SR / 1000.0)
    rho = math.exp(-1.0 / (50.0 * SR / 1000.0))
    y_p, g_p = limiter.lookahead_limiter_plain(x, w, rho, 0.98, True)
    assert torch.equal(y, y_p) and torch.equal(g, g_p)
    assert torch.equal(limiter.lookahead_limiter(x, SR), y_p)
    monkeypatch.undo()
    assert limiter.lookahead_limiter_cuda.launches == before
