"""The quality limiter's kernel on the card (the ``cuda`` marker):
``lookahead_limiter_cuda`` against the plain limiter run on the card and
against a float64 limiter, from one frame to the benchmark cells' longest
track, on one to three channels, at the 44.1, 48 and 96 kHz attack
windows and the largest; a CUDA-graph replay equals the eager call; the
launch counter; what the wrapper refuses. Without a card each test skips.

The plain limiter is not exact: its release scan squares its float32
decay powers, which puts up to ~8.3e-6 into its gain on hot input (the
kernel builds every power in float64), and y = x·gain carries that times
|x|. So the kernel is held to the plain gain within 1e-5, to the plain y
within 1e-5 per unit of |x|, and to the float64 limiter within 1e-6.

Imports no JAX: on the card run ``python -m pytest -m cuda --noconftest
-p no:cacheprovider tests/test_torch_limiter_card.py``."""

import math

import numpy as np
import pytest
import torch

from ame_tpu_torch.ops import limiter
from ame_tpu_torch.ops import window as W

SR = 44100
RHO = math.exp(-1.0 / (50.0 * SR / 1000.0))   # the 50 ms release
T = limiter._LIM_TILE
LONGEST = 15_567_300                          # 353 s, the cells' longest


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel runs only there")
    return torch.device("cuda")


def _signal(n: int, c: int, seed: int, device) -> torch.Tensor:
    """Gated noise and a 100 Hz tone (the cells' content) with clicks six
    times as loud, which drive the gain down to ~0.1."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (0.25 * rng.standard_normal((n, c))
         + 0.3 * np.sin(2 * np.pi * 100 * t)[:, None])
    x[(np.floor(t / 1.7) % 2) == 1] = 0.0
    for at in rng.integers(0, n, max(n // 100_000, 1)):
        x[at:at + 30] *= 6.0
    return torch.from_numpy(x.astype(np.float32)).to(device)


def _float64_limiter(x: torch.Tensor, w: int, rho: float):
    """The limiter in float64 from the same float32 g_t: exact min, a
    float64 running sum for the mean, the release in the log domain
    (log u[i] = i·log rho + max_k (log d[k] - k·log rho))."""
    peak = x.abs().amax(dim=1)
    g_t = torch.clamp(torch.full((), 0.98, dtype=torch.float32,
                                 device=x.device)
                      / torch.clamp(peak, min=1e-9), max=1.0).double()
    g_a = W.sliding_min_ahead(g_t, w)
    n = x.shape[0]
    cs = torch.cat([g_a.new_zeros(1), torch.cumsum(g_a, 0)])
    i = torch.arange(n, device=x.device)
    g_r = ((cs[i + 1] - cs[torch.clamp(i - w + 1, min=0)])
           / torch.clamp(i + 1, max=w).double())
    k = i.double() * math.log(float(np.float32(rho)))
    depth = torch.clamp(1.0 - g_r, min=0.0)     # a sum's rounding past 1
    u = torch.exp(k + torch.cummax(torch.log(depth) - k, 0).values)
    gain = 1.0 - u
    return x.double() * gain[:, None], gain


@pytest.mark.cuda
@pytest.mark.parametrize("n, c, w", [
    (1, 2, 220), (219, 2, 220), (220, 2, 220), (440, 2, 220),
    (T - 1, 2, 220), (T, 2, 220), (T + 1, 2, 220),
    (12_345, 1, 220), (12_345, 3, 240), (100_000, 2, 480),
    (100_000, 2, limiter._LIM_MAX_W),
    ((1 << 23) + 1234, 2, 220), ((1 << 23) + 1234, 1, 240),
    ((1 << 23) + 1234, 3, 480), (LONGEST, 2, 220),
])
def test_kernel_matches_plain_and_float64(card, n, c, w):
    x = _signal(n, c, seed=n + c + w, device=card)
    y, g = limiter.lookahead_limiter_cuda(x, w, RHO, 0.98, return_gain=True)
    y_p, g_p = limiter.lookahead_limiter_plain(x, w, RHO, 0.98, True)
    y_r, g_r = _float64_limiter(x, w, RHO)
    scale = max(1.0, x.abs().max().item())
    assert (g - g_p).abs().max().item() <= 1e-5
    assert (y - y_p).abs().max().item() <= 1e-5 * scale
    assert (g.double() - g_r).abs().max().item() <= 1e-6
    assert (y.double() - y_r).abs().max().item() <= 1e-6
    assert torch.equal(y, x * g[:, None])
    if n > 1000:
        assert g.min().item() < 0.8 and y.abs().max().item() <= 0.98 + 1e-5


@pytest.mark.cuda
def test_graph_replay_equals_eager(card):
    """Captured once and replayed on new input: each replay equals the
    eager call on that input; the capture counts one launch, a replay
    none."""
    x = _signal(1 << 20, 2, seed=1, device=card)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        limiter.lookahead_limiter(x, SR)           # warm: table, library
        torch.cuda.synchronize()
        before = limiter.lookahead_limiter_cuda.launches
        with torch.cuda.graph(graph):
            out = limiter.lookahead_limiter(x, SR)
    assert limiter.lookahead_limiter_cuda.launches == before + 1
    for seed in (2, 3, 4):
        x.copy_(_signal(1 << 20, 2, seed=seed, device=card))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, limiter.lookahead_limiter(x, SR))
    assert limiter.lookahead_limiter_cuda.launches == before + 4


@pytest.mark.cuda
def test_launches_count_one_a_call(card):
    """``lookahead_limiter`` on a CUDA tensor launches the kernel once a
    call, a non-contiguous input included; the quality chain once a
    master."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph.chain import master_graph
    x = _signal(50_000, 2, seed=5, device=card)
    before = limiter.lookahead_limiter_cuda.launches
    y = limiter.lookahead_limiter(x, SR)
    y_t = limiter.lookahead_limiter(x.t().contiguous().t(), SR)
    assert torch.equal(y, y_t)
    assert limiter.lookahead_limiter_cuda.launches == before + 2
    master_graph(x, SR, MasterSettings(width=1.2))
    assert limiter.lookahead_limiter_cuda.launches == before + 3


@pytest.mark.cuda
def test_wrapper_refuses(card):
    """An attack window above the largest, a float64 or CPU tensor and a
    1-D tensor raise and count nothing."""
    x = _signal(10_000, 2, seed=6, device=card)
    before = limiter.lookahead_limiter_cuda.launches
    bad = [lambda: limiter.lookahead_limiter_cuda(
               x, limiter._LIM_MAX_W + 1, RHO),
           lambda: limiter.lookahead_limiter_cuda(x.double(), 220, RHO),
           lambda: limiter.lookahead_limiter_cuda(x.cpu(), 220, RHO),
           lambda: limiter.lookahead_limiter_cuda(x[:, 0], 220, RHO),
           lambda: limiter.lookahead_limiter(x.double(), SR)]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert limiter.lookahead_limiter_cuda.launches == before
