"""Signature parity of the port with ame_tpu where the two once differed:
normalize_two_pass's true-peak cap, alimiter_compat's levels, the axis of
biquad_scan / lfilter_scan, gated_stats_from_hops's dtype and the
package's top-level names. Each against ame_tpu on the same numpy inputs,
on the CPU (the plain PyTorch versions)."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ame_tpu_torch.ops import limiter, loudness, scan_iir
from tests.conftest import make_test_signal

SR = 44100
LSB = 1.0 / 32768.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _clicky(n: int) -> np.ndarray:
    """Quiet 0.01-scale noise with a full-scale click every second: its
    loudness asks for ~+26 dB, its true peak allows less than 0."""
    x = 0.01 * make_test_signal("noise", n, SR, seed=5)
    x[::SR] = 0.95
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# normalize_two_pass: the true-peak cap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("protect_tp", [False, True])
def test_normalize_two_pass_protect_tp_matches_reference(protect_tp):
    """Gain within 0.01 dB and output within 2e-5 abs of ame_tpu's (as
    tests/test_torch_ops.py holds the uncapped form), on a track whose true
    peak binds the capped gain."""
    from ame_tpu.ops.loudness import normalize_two_pass as ref
    x = _clicky(3 * SR)
    y_r, i_r = ref(jnp.asarray(x), SR, -14.0, -1.5, 11.0, protect_tp)
    y, info = loudness.normalize_two_pass(_t(x), SR, -14.0, -1.5, 11.0,
                                          protect_tp)
    assert abs(float(info["gain_db"]) - float(i_r["gain_db"])) <= 0.01
    assert np.abs(y.numpy() - np.asarray(y_r)).max() <= 2e-5
    uncapped = float(loudness.normalize_two_pass(_t(x), SR, -14.0)[1][
        "gain_db"])
    if protect_tp:
        assert float(info["gain_db"]) < uncapped - 20.0
        headroom = -1.5 - float(info["input_tp"])
        assert float(info["gain_db"]) == pytest.approx(headroom, abs=1e-5)
    else:
        assert float(info["gain_db"]) == uncapped


def test_normalize_two_pass_keywords_and_silence():
    """The reference's keywords, as ame_tpu/graph/chain.py passes them, give
    the default master; silence passes through with the cap on too."""
    x = _clicky(2 * SR)
    y0, i0 = loudness.normalize_two_pass(_t(x), SR, -14.0)
    y1, i1 = loudness.normalize_two_pass(_t(x), SR, -14.0, target_tp_db=-1.5,
                                         target_lra=11.0, n_valid=None)
    assert torch.equal(y0, y1) and torch.equal(i0["gain_db"], i1["gain_db"])
    silent = np.zeros((SR, 2), np.float32)
    y, info = loudness.normalize_two_pass(_t(silent), SR, protect_tp=True)
    assert np.array_equal(y.numpy(), silent)
    assert float(info["gain_db"]) == 0.0


# ---------------------------------------------------------------------------
# alimiter_compat: level_in, level_out, auto_level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels", [None, (0.5, 1.2, True), (2.0, 0.8, False)])
def test_alimiter_compat_levels_match_reference(levels):
    """Output within 1/32768 of ame_tpu's (relative to the output scale) and
    the gain within 1e-5, as tests/test_torch_compat_ops.py holds the
    default levels."""
    from ame_tpu.ops.limiter import alimiter_compat as ref
    from tests.test_golden_ffmpeg import limiter_signal
    x = limiter_signal("hot_music")[: 1 << 16]
    kw = ({} if levels is None else
          dict(zip(("level_in", "level_out", "auto_level"), levels)))
    y_r, g_r = ref(jnp.asarray(x), float(SR), return_gain=True, **kw)
    y, g = limiter.alimiter_compat(_t(x), SR, return_gain=True, **kw)
    out_scale = max(1.0, kw.get("level_out", 1.0) / 0.98)
    assert np.abs(y.numpy() - np.asarray(y_r)).max() <= LSB * out_scale
    assert np.abs(g.numpy() - np.asarray(g_r)).max() <= 1e-5
    assert g.numpy().min() < 0.95                         # it limits


def test_alimiter_compat_default_levels_bit_equal():
    """The defaults, given or not, give the same bits; so does the
    reference's positional order."""
    from tests.test_golden_ffmpeg import limiter_signal
    x = _t(limiter_signal("hot_music")[: 1 << 15])
    y0, g0 = limiter.alimiter_compat(x, SR, return_gain=True)
    y1, g1 = limiter.alimiter_compat(x, SR, 0.98, 5.0, 50.0, 1.0, 1.0, True,
                                     True)
    assert torch.equal(y0, y1) and torch.equal(g0, g1)


# ---------------------------------------------------------------------------
# biquad_scan / lfilter_scan along an axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
def test_lfilter_scan_axis_matches_reference(axis):
    from ame_tpu.ops.scan_iir import lfilter_scan as ref
    from ame_tpu_torch.dsp import design
    b, a = design.butter_ba(2, 0.1, "low")
    x = make_test_signal("noise", 5000, SR, seed=8)
    if axis == 1:
        x = np.ascontiguousarray(x.T)
    got = scan_iir.lfilter_scan(b, a, _t(x), axis=axis).numpy()
    want = np.asarray(ref(b, a, jnp.asarray(x), axis=axis))
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("axis", [0, 1])
def test_biquad_scan_axis_zi_matches_reference(axis):
    """From a non-zero zi: y within 2e-6, zf within 2e-6."""
    from ame_tpu.ops.scan_iir import biquad_scan as ref
    coeffs = np.array([0.2, 0.3, 0.1, 1.0, -0.6, 0.2])
    x = make_test_signal("noise", 3000, SR, seed=9)
    zi = np.random.default_rng(9).standard_normal((2, 2)).astype(np.float32)
    if axis == 1:
        x = np.ascontiguousarray(x.T)
    y, zf = scan_iir.biquad_scan(_t(x), coeffs, _t(zi), axis=axis)
    y_r, zf_r = ref(jnp.asarray(x), jnp.asarray(coeffs, jnp.float32),
                    jnp.asarray(zi), axis=axis)
    assert y.shape == x.shape and zf.shape == zi.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=2e-6)
    np.testing.assert_allclose(zf.numpy(), np.asarray(zf_r), atol=2e-6)


# ---------------------------------------------------------------------------
# gated_stats_from_hops(dtype=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hops_n", [60, 25])
def test_gated_stats_from_hops_dtype_matches_reference(hops_n):
    """With ``dtype`` the LRA of a track under 3 s is 0 of that dtype, as
    in ame_tpu; the stats within 1e-3 as tests/test_torch_loudnorm.py
    holds them."""
    from ame_tpu.ops.loudness import gated_stats_from_hops as ref
    rng = np.random.default_rng(4)
    hops = (np.abs(rng.standard_normal(hops_n)) * 1e2).astype(np.float32)
    want = ref(jnp.asarray(hops), 4410, None, jnp.bfloat16)
    got = loudness.gated_stats_from_hops(_t(hops), 4410, None,
                                         torch.bfloat16)
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-3
    assert (got[1].dtype == torch.bfloat16) == (want[1].dtype ==
                                                jnp.bfloat16)
    assert got[1].dtype == (torch.bfloat16 if hops_n < 30 else torch.float32)


# ---------------------------------------------------------------------------
# The package's top-level names
# ---------------------------------------------------------------------------

def test_top_level_names_match_reference():
    """process_audio, master_file and EQ_PRESETS resolve lazily on the
    port's package, in ame_tpu's __all__ order, and touching them imports
    neither jax nor ame_tpu (in a subprocess)."""
    import ame_tpu
    code = (
        "import json, sys\n"
        "import ame_tpu_torch\n"
        "assert 'ame_tpu_torch.api' not in sys.modules\n"
        "from ame_tpu_torch import api\n"
        "assert ame_tpu_torch.process_audio is api.process_audio\n"
        "assert ame_tpu_torch.master_file is api.master_file\n"
        "from ame_tpu_torch.presets import EQ_PRESETS\n"
        "assert ame_tpu_torch.EQ_PRESETS is EQ_PRESETS\n"
        "for name in ('jax', 'ame_tpu'):\n"
        "    assert name not in sys.modules, name\n"
        "print(json.dumps({'all': ame_tpu_torch.__all__,\n"
        "                  'presets': ame_tpu_torch.EQ_PRESETS}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["presets"] == json.loads(json.dumps(ame_tpu.EQ_PRESETS))
    assert [n for n in got["all"] if n in ame_tpu.__all__] == ame_tpu.__all__
