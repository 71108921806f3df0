"""The port's ffmpeg loudnorm flow (ame_tpu_torch.ops.loudnorm) and the
loudness additions it reads (hop-domain gating, dynamic-domain measure,
integrated_lufs) against ame_tpu's, and against the numbers recorded from
the real ffmpeg filters in tests/fixtures/golden_ffmpeg.json. On the CPU."""

import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ame_tpu_torch.ops import loudness, loudnorm
from tests.conftest import make_test_signal

SR = 44100
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "golden_ffmpeg.json")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def _signal(kind):
    from tests.test_golden_ffmpeg import make_signal
    return make_signal(kind)


def _program(seconds, seed=0):
    """Noise with a 2 Hz level alternation: a wide loudness range, so the
    dynamic controller has work to do."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = np.where((t % 1.0) < 0.5, 0.05, 0.4)
    return (make_test_signal("noise", n, SR, seed=seed)
            * env[:, None]).astype(np.float32)


@pytest.mark.parametrize("n_valid", [None, 40 * 4410 + 77])
def test_gated_stats_from_hops_matches_reference(n_valid):
    from ame_tpu.ops.loudness import gated_stats_from_hops as ref
    rng = np.random.default_rng(4)
    hops = (np.abs(rng.standard_normal(60)) * 1e2
            * np.repeat([1.0, 0.01, 3.0], 20)).astype(np.float32)
    want = ref(jnp.asarray(hops), 4410, n_valid)
    got = loudness.gated_stats_from_hops(_t(hops), 4410, n_valid)
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-3


@pytest.mark.parametrize("dynamic_domain", [False, True])
def test_measure_domains_match_reference(dynamic_domain):
    from ame_tpu.ops.loudness import integrated_lufs, measure
    x = _program(4.0)
    want = measure(jnp.asarray(x), SR, dynamic_domain=dynamic_domain)
    got = loudness.measure(_t(x), SR, dynamic_domain=dynamic_domain)
    for k in ("input_i", "input_lra", "input_thresh", "input_tp"):
        assert abs(float(got[k]) - float(want[k])) <= 0.01, k
    assert abs(float(loudness.integrated_lufs(_t(x[:, 0]), SR))
               - float(integrated_lufs(jnp.asarray(x[:, 0]), SR))) <= 0.01


@pytest.mark.parametrize("seconds", [2.5, 6.0], ids=["short", "fused"])
def test_loudnorm_pass1_matches_reference(seconds):
    """The print_format=json stats block, both the short-input path and
    the fused hop-domain path: every stat within 0.01 LU."""
    from ame_tpu.ops.loudnorm import loudnorm_pass1 as ref
    x = _program(seconds, seed=1)
    want = ref(jnp.asarray(x), SR)
    got = loudnorm.loudnorm_pass1(_t(x), SR)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 0.01, k


@pytest.mark.parametrize("kind", ("alt", "ramp", "multi"))
def test_dynamic_trajectory_matches_ffmpeg_fixture(kind):
    """The dynamic controller vs the recorded real-filter gain envelope,
    from the recorded pass-1 stats, within 0.5 dB per 100 ms block (as
    tests/test_golden_ffmpeg.py holds ame_tpu)."""
    fx = _fixture()["dynamic"][kind]
    x = _signal(kind)
    y, _ = loudnorm.dynamic_loudnorm(_t(x), SR, -14.0, -1.5, 7.0,
                                     measured_i=fx["p1"]["input_i"],
                                     measured_thresh=fx["p1"]["input_thresh"],
                                     offset=fx["p1"]["target_offset"])
    yo = y.numpy()
    L = SR // 10
    want = np.asarray(fx["gain_env_db"])
    nb = min(len(yo) // L, len(want))
    eo = np.sqrt((yo[:nb * L, 0].reshape(nb, L) ** 2).mean(1))
    ex = np.sqrt((x[:nb * L, 0].reshape(nb, L) ** 2).mean(1))
    g = 20 * np.log10((eo + 1e-7) / (ex + 1e-7))
    assert np.abs(g - want[:nb]).max() < 0.5, np.abs(g - want[:nb]).max()


@pytest.mark.parametrize("kind", ("alt", "hot", "quiet", "ramp", "multi"))
def test_measure_matches_ffmpeg_fixture(kind):
    want = _fixture()["measure"][kind]["linear_stats"]
    m = {k: float(v) for k, v in loudness.measure(_t(_signal(kind)),
                                                   SR).items()}
    for k in ("input_i", "input_lra", "input_thresh"):
        assert abs(m[k] - want[k]) < 0.05, k


@pytest.mark.parametrize("case", ["dynamic", "linear", "silent"])
def test_loudnorm_two_pass_matches_reference(case):
    """The whole ffmpeg flow: pass 1, then the linear gain when every gate
    holds, else the dynamic engine with the pass-1 offset; silence passes
    through (Q9). Output within 1e-4, gain and output_i within 0.01 dB,
    the same linear-mode verdict."""
    from ame_tpu.ops.loudnorm import loudnorm_two_pass as ref
    if case == "silent":
        x = np.zeros((SR * 4, 2), np.float32)
    elif case == "linear":     # steady, quiet: the linear gain is legal
        x = (make_test_signal("noise", SR * 4, SR, seed=2) * 0.05)
    else:                      # quiet with hot clicks: the gain would
        x = _program(4.0, seed=2) * 0.1    # break the true-peak target
        x[::SR // 2] = 0.9
    y_r, i_r = ref(jnp.asarray(x), SR, -14.0, -1.5, 11.0)
    y, info = loudnorm.loudnorm_two_pass(_t(x), SR, -14.0, -1.5, 11.0)
    assert float(info["linear_mode"]) == float(i_r["linear_mode"])
    assert float(info["linear_mode"]) == (1.0 if case == "linear" else 0.0)
    assert np.abs(y.numpy() - np.asarray(y_r)).max() <= 1e-4
    for k in ("gain_db", "output_i"):
        a, b = float(info[k]), float(i_r[k])
        assert (a == b) or abs(a - b) <= 0.01, k
    if case == "silent":
        assert not y.numpy().any()
