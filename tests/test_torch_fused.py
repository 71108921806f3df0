"""The port's one-program chain (ame_tpu_torch.graph.chain
.master_graph_fused) against ame_tpu's master_graph_fused (jit on the CPU),
and the on-device verdicts it rests on, on the CPU.

On the CPU master_graph_fused runs the chain eagerly, the formulation a
card captures into one CUDA graph: every data-dependent decision (the gain
engine's sweeps, fallback and silent early-out, loudnorm's linear/dynamic
choice and silent passthrough) goes through ops/_branch.device_if, which
reads its predicate once here (tests/test_torch_branch.py holds the
verdicts and the reads).

Tolerances (PERF.md section 2): quality output within 2e-4 abs and gain
within 0.01 dB; compat relative L2 < 3e-3 or max abs <= 2/32768
(tests/test_chain.py:73-75); linear_mode equal."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph.chain import master_graph, master_graph_fused
from ame_tpu_torch.ops import pydub_gain as pg

SR = 44100
FLAGSHIP = dict(analog_character=20.0, bass_boost=2.0, presence_boost=1.5,
                width=1.2, lufs=-14.0)
COMPAT = dict(FLAGSHIP, mode="compat")


def _grid(x):
    """On the int16 grid, as api.master_array stages a compat input."""
    return (np.trunc(np.clip(x, -1.0, 1.0) * 32767.0) / 32768.0).astype(
        np.float32)


def _noise(n, seed=0, amp=0.1):
    return (amp * np.random.default_rng(seed).standard_normal((n, 2))
            ).astype(np.float32)


def _gated(n, seed=0):
    """0.3 noise + a 100 Hz tone at 0.3, on and off at 2 Hz: every band
    crosses its threshold, the relaxation converges."""
    t = np.arange(n) / SR
    on = ((t % 0.5) < 0.25)[:, None]
    return _grid((0.3 * np.random.default_rng(seed).standard_normal((n, 2))
                  + 0.3 * np.sin(2 * np.pi * 100.0 * t)[:, None]) * on)


def _steady(n):
    """Steady 0.5 noise: the low band's relaxation stalls (the fallback)."""
    return _grid(0.5 * np.random.default_rng(1).standard_normal((n, 2)))


def _clicks(n):
    """Quiet noise with full-scale clicks: the linear gain would break the
    true-peak target, so loudnorm goes dynamic."""
    x = 0.01 * np.random.default_rng(4).standard_normal((n, 2))
    x[::SR // 2] = 0.9
    return _grid(x)


def _tone(n):
    """A slowly swelling 440 Hz tone over faint noise: low crest, a small
    loudness range, so every linear gate holds."""
    t = np.arange(n) / SR
    x = (0.2 * np.sin(2 * np.pi * 440.0 * t)
         * (1.0 + 0.1 * np.sin(2 * np.pi * 0.3 * t)))[:, None] \
        + 0.005 * np.random.default_rng(4).standard_normal((n, 2))
    return _grid(x)


CASES = {
    "quality": (FLAGSHIP, lambda: _noise(1 << 15)),
    "quality_multiband": (dict(FLAGSHIP, multiband=True),
                          lambda: _noise(1 << 15)),
    "quality_mb_edges": (dict(FLAGSHIP, mb_edges=(120.0, 1000.0, 6000.0)),
                         lambda: _noise(1 << 15)),
    "compat": (COMPAT, lambda: _gated(1 << 16)),
    "compat_multiband": (dict(COMPAT, multiband=True),
                         lambda: _gated(1 << 16)),
    "compat_chunked": (dict(COMPAT, multiband=True, compat_chunked=True),
                       lambda: _gated(1 << 16)),
    "compat_fallback": (dict(COMPAT, multiband=True),
                        lambda: _steady(1 << 17)),
    "compat_dynamic": (COMPAT, lambda: _clicks(1 << 18)),
    "compat_linear": (COMPAT, lambda: _tone(1 << 18)),
    "silent": (dict(COMPAT, multiband=True),
               lambda: np.zeros((1 << 15, 2), np.float32)),
}
LINEAR = {"compat_dynamic": 0.0, "compat_linear": 1.0, "silent": 0.0}


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


@pytest.fixture
def chunk_seconds(monkeypatch):
    """0.5 s chunks in both packages, so 2^16 samples hold three."""
    from ame_tpu import config as ref_config
    from ame_tpu_torch import config as port_config
    monkeypatch.setattr(ref_config, "COMPAT_CHUNK_SECONDS", 0.5)
    monkeypatch.setattr(port_config, "COMPAT_CHUNK_SECONDS", 0.5)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_matches_reference(case, chunk_seconds, monkeypatch):
    from ame_tpu.config import MasterSettings as RefSettings
    from ame_tpu.graph.chain import master_graph_fused as ref_fused
    settings, make = CASES[case]
    x = make()
    two_pass = []
    real = pg._two_pass
    monkeypatch.setattr(pg, "_two_pass",
                        lambda *a: two_pass.append(1) or real(*a))
    y_ref, info_ref = ref_fused(jnp.asarray(x), float(SR),
                                RefSettings(**settings))
    y, info = master_graph_fused(torch.from_numpy(x), SR,
                                 MasterSettings(**settings))
    y, y_ref = y.numpy(), np.asarray(y_ref)
    assert y.shape == x.shape and np.isfinite(y).all()
    assert set(info) == set(info_ref)
    if settings.get("mode") == "compat":
        max_abs = np.abs(y - y_ref).max()
        assert _rel_err(y, y_ref) < 3e-3 or max_abs <= 2.0 / 32768.0, \
            (_rel_err(y, y_ref), max_abs)
    else:
        assert np.abs(y - y_ref).max() <= 2e-4
    a, b = float(info["gain_db"]), float(info_ref["gain_db"])
    assert a == b or abs(a - b) <= 0.01
    assert float(info["linear_mode"]) == float(info_ref["linear_mode"])
    if case in LINEAR:
        assert float(info["linear_mode"]) == LINEAR[case]
    # the steady input takes the per-band fallback, the others do not
    assert bool(two_pass) == (case == "compat_fallback")
    if case == "silent":
        assert not y.any()


def test_fused_equals_staged_chain():
    """On the CPU the fused entry is the staged chain's formulation: the
    same bits."""
    x = torch.from_numpy(_gated(1 << 15))
    s = MasterSettings(**dict(COMPAT, multiband=True))
    y0, i0 = master_graph(x, SR, s)
    y1, i1 = master_graph_fused(x, SR, s)
    assert torch.equal(y0, y1)
    assert all(torch.equal(i0[k], i1[k]) for k in i0)


# ---------------------------------------------------------------------------
# Arguments and devices
# ---------------------------------------------------------------------------

def test_fused_compat_rejects_band_edges():
    x = torch.zeros((4096, 2))
    with pytest.raises(ValueError, match="quality-mode only"):
        master_graph_fused(x, SR, {"mode": "compat",
                                   "mb_edges": (200.0, 2000.0)})


def test_fused_takes_a_settings_dict():
    x = torch.from_numpy(_noise(1 << 14))
    y0, _ = master_graph_fused(x, SR, MasterSettings(**FLAGSHIP))
    y1, _ = master_graph_fused(x, SR, dict(FLAGSHIP, unknown_key=1))
    assert torch.equal(y0, y1)


def test_fused_cuda_request_without_a_card_raises():
    """No card: the fused profile on "cuda" raises (it never falls back to
    the CPU), and a tensor on neither the CPU nor a card is refused."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from ame_tpu_torch.utils.profiler import profile_master
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_master(np.zeros((1024, 2), np.float32), SR, {})
    with pytest.raises(ValueError, match="unsupported device"):
        master_graph_fused(torch.zeros((1024, 2), device="meta"), SR, {})
