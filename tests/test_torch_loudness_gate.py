"""The loudness gate's block energies (ame_tpu_torch.ops.loudness) and the
default deployment that rests on them, on the CPU.

A gating block's energy is the direct sum of its hops' energies
(``_block_sums``), never a difference of running sums: in float32 a
difference of a prefix sum over the whole track leaves a rounding residue
of the running total in a block of digital silence, which can pass the
-70 LUFS gate. The CPU's ``torch.cumsum`` accumulates in float64 and hides
that; a card's float32 parallel scan shows it. So the tests below run with
``torch.cumsum`` replaced by a float32 Kogge-Stone scan, the parallel form
a card's scan takes: the block powers must not depend on it.

Then the deployment: ``master_graph`` at ``lufs=-14`` on the album mix's
gated content against the benchmark's float64 reference
(``cudabench/reference/quality.master``), and the sequence-parallel chain
against ``master_graph`` on the same content."""

import math

import numpy as np
import pytest
import torch

from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph.chain import master_graph
from ame_tpu_torch.ops import loudness
from ame_tpu_torch.parallel.mesh import make_mesh
from cudabench import traffic
from cudabench.reference import quality
from cudabench.spec import Spec

SR = 44100
HOP = 4410
GATE_POWER = 10.0 ** ((-70.0 + 0.691) / 10.0)   # -70 LUFS as a power
FLAGSHIP = dict(mode="quality", analog_character=20.0, bass_boost=2.0,
                presence_boost=1.5, width=1.2, lufs=-14.0)


def _parallel_cumsum(x, dim=0):
    """Inclusive prefix sum along ``dim`` in the Kogge-Stone form, in the
    input's precision: log2(n) rounds of x[i] += x[i - d], each partial
    sum rounded."""
    y = x.movedim(dim, 0)
    d = 1
    while d < y.shape[0]:
        y = torch.cat([y[:d], y[d:] + y[:-d]])
        d *= 2
    return y.movedim(0, dim)


@pytest.fixture
def card_scan(monkeypatch):
    monkeypatch.setattr(torch, "cumsum", _parallel_cumsum)


def _loud_then_silent(loud_s=60.0, silent_s=20.0, amp=0.5, seed=0):
    rng = np.random.default_rng(seed)
    n1, n2 = int(loud_s * SR), int(silent_s * SR)
    y = np.concatenate([amp * rng.standard_normal((n1, 2)),
                        np.zeros((n2, 2))]).astype(np.float32)
    return y, -(-n1 // HOP)         # the first hop wholly in the silence


def _hop_energies(y):
    n_hops = y.shape[0] // HOP
    return (y[:n_hops * HOP].astype(np.float64) ** 2).sum(axis=1).reshape(
        n_hops, HOP).sum(axis=1)


def _residue_powers(hops, steps=4):
    """The parent form: block sums as differences of a float32 prefix sum
    taken by the parallel scan."""
    cs = torch.cat([torch.zeros(1), _parallel_cumsum(
        torch.from_numpy(hops.astype(np.float32)))])
    nb = len(hops) - steps + 1
    return ((cs[steps:steps + nb] - cs[:nb]) / (HOP * steps)).numpy()


def test_silent_blocks_read_exactly_zero_power(card_scan):
    """A minute of loud noise, then exact zeros: every 400 ms and 3 s block
    wholly in the zeros reads exactly 0 and fails the -70 LUFS gate. At
    this length the float32 prefix-sum difference reads some of them
    above -70 LUFS (checked first, so the signal shows the fault)."""
    y, first = _loud_then_silent()
    residue = _residue_powers(_hop_energies(y))[first:]
    assert (residue > GATE_POWER).sum() > 0
    p, v = loudness._gating_block_powers(torch.from_numpy(y), SR, 0.4, 0.1)
    assert p.shape[0] == y.shape[0] // HOP - 3 and bool(v.all())
    assert torch.equal(p[first:], torch.zeros_like(p[first:]))
    assert bool((loudness._power_to_lufs(p[first:]) <= -70.0).all())
    assert bool((p[:first - 3] > GATE_POWER).all())
    p_s, _ = loudness._gating_block_powers(torch.from_numpy(y), SR, 3.0, 1.0)
    assert torch.equal(p_s[60:], torch.zeros_like(p_s[60:]))


def test_block_sums_are_direct_sums():
    """out[j] = sums[j] + ... + sums[j + steps - 1], in that order, for
    every trailing shape; too few sums give no block."""
    rng = np.random.default_rng(1)
    s = torch.from_numpy(rng.uniform(0, 1e3, (50, 3)).astype(np.float32))
    for steps in (1, 3, 4):
        got = loudness._block_sums(s, steps)
        want = s[:51 - steps].clone()
        for k in range(1, steps):
            want = want + s[k:k + 51 - steps]
        assert torch.equal(got, want)
    assert loudness._block_sums(s[:2], 4).shape == (0, 3)


def _float64_stats(hops, n_valid=None):
    """(integrated, lra, rel_thresh) of hop energies, in float64 numpy:
    BS.1770's gate over 400 ms blocks, EBU Tech 3342's LRA over 3 s blocks
    at a 1 s hop with round-nearest order statistics."""
    h = np.asarray(hops, np.float64)
    nv = len(h) * HOP if n_valid is None else n_valid

    def lufs(p):
        return -0.691 + 10.0 * np.log10(np.maximum(p, 1e-30))

    p_m = np.convolve(h, np.ones(4), "valid") / (4 * HOP)
    v_m = (np.arange(len(p_m)) + 4) * HOP <= nv
    a = (lufs(p_m) > -70.0) & v_m
    rel = lufs(p_m[a].mean()) - 10.0 if a.any() else -70.0
    g = a & (lufs(p_m) > rel)
    integ = lufs(p_m[g].mean()) if g.any() else -math.inf
    sec = h[:len(h) // 10 * 10].reshape(-1, 10).sum(axis=1)
    p_s = np.convolve(sec, np.ones(3), "valid") / (30 * HOP)
    v_s = (np.arange(len(p_s)) + 3) * 10 * HOP <= nv
    a_s = (lufs(p_s) > -70.0) & v_s
    g_s = a_s & (lufs(p_s) > lufs(p_s[a_s].mean()) - 20.0)
    ls = np.sort(lufs(p_s[g_s]))
    n = len(ls)

    def pct(q):
        return ls[min(max(int(np.round(q * (n - 1))), 0), n - 1)]

    lra = pct(0.95) - pct(0.10) if n else 0.0
    return integ, lra, rel


def _gated_hops(seed):
    """Hop energies of gated content: 2-8 s sections of levels spread over
    30 dB, half of them digital silence (exact zero hops), on top of a
    loud minute that makes the running total large."""
    rng = np.random.default_rng(seed)
    hops, on = [np.full(600, 2000.0)], True
    while sum(map(len, hops)) < 1800:
        k = int(rng.integers(20, 80))
        level = 10.0 ** rng.uniform(0.0, 3.0) if on else 0.0
        hops.append(level * rng.uniform(0.5, 1.5, k))
        on = not on
    return np.concatenate(hops)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_valid", [None, 1700 * HOP + 77])
def test_gated_stats_float32_matches_float64(card_scan, seed, n_valid):
    """The same hops in float32 and float64 give the same gate: integrated
    loudness, LRA and relative threshold within 1e-4 LU of each other and
    of a float64 numpy gate. The float32 sums of 4 and of 30 hops carry a
    few ulp (~1e-6 relative, ~5e-6 LU); 1e-4 LU leaves room for the means
    over the gated blocks, and is far below the 1.25 LU that the silent
    blocks passing the -70 gate would move the relative threshold here."""
    hops = _gated_hops(seed)
    want = _float64_stats(hops, n_valid)
    got64 = loudness.gated_stats_from_hops(
        torch.from_numpy(hops), HOP, n_valid)
    got32 = loudness.gated_stats_from_hops(
        torch.from_numpy(hops.astype(np.float32)), HOP, n_valid)
    for a, b, w in zip(got32, got64, want):
        assert abs(float(a) - float(b)) <= 1e-4
        assert abs(float(b) - w) <= 1e-4


def _album_content(seconds, seed):
    mix = Spec().mix("album_dynamic")
    n = int(seconds * SR)
    ss = np.random.SeedSequence(seed)
    return traffic.make_track(mix, n, ss, "cpu").pcm


@pytest.mark.parametrize("seed", [2**32 + 5, 7])
def test_default_deployment_matches_the_float64_reference(card_scan, seed):
    """``master_graph`` at ``lufs=-14`` on 25 s of the album mix's gated
    content (half digital silence): the master within the benchmark's
    ``max_lsb`` of 6 of the float64 reference, and the measured integrated
    loudness within 1e-3 dB of the reference's float64 measurement. The
    chain's float32 rounding moves the measured power by ~1e-6 relative
    (~5e-6 dB); 1e-3 dB is the gain error at which a full-scale sample
    moves 0.004 LSB, and under the 0.0173 dB the silent blocks moved it
    through the float32 prefix sum."""
    pcm = _album_content(25.0, seed)
    x = torch.from_numpy(pcm.astype(np.float32) / 32768.0)
    y, info = master_graph(x, SR, MasterSettings(**FLAGSHIP))
    got = np.trunc(np.clip(y.numpy(), -1.0, 1.0) * 32767.0).astype(np.int32)
    ref_info = {}
    want = quality.master(pcm, float(SR), FLAGSHIP, info=ref_info)
    assert np.abs(got - want.astype(np.int32)).max() <= 6
    assert abs(float(info["input_i"]) - ref_info["input_i"]) <= 1e-3
    assert abs(float(info["gain_db"]) - ref_info["gain_db"]) <= 1e-3


def test_sp_master_equals_master_graph_on_gated_content(card_scan):
    """The sequence-parallel chain (4 shards) and the one-device chain read
    the same gate on gated content, through the one block-sum helper:
    loudness within 1e-4 LU of each other and 1e-3 dB of the float64
    reference's measurement, and the masters within the 3e-4 of
    tests/test_torch_parallel.py."""
    from ame_tpu_torch.parallel.sp_master import master_sequence_parallel
    pcm = _album_content(20.0, 11)
    x = pcm.astype(np.float32) / 32768.0
    s = MasterSettings(**FLAGSHIP)
    y, info = master_sequence_parallel(
        torch.from_numpy(x), SR, s, make_mesh({"sp": 4}, devices=["cpu"] * 4))
    y_one, info_one = master_graph(torch.from_numpy(x), SR, s)
    for k in ("input_i", "input_lra", "input_thresh", "gain_db"):
        assert abs(float(info[k]) - float(info_one[k])) <= 1e-4, k
    ref_info = {}
    quality.master(pcm, float(SR), FLAGSHIP, info=ref_info)
    assert abs(float(info["input_i"]) - ref_info["input_i"]) <= 1e-3
    np.testing.assert_allclose(y.numpy(), y_one.numpy(), atol=3e-4,
                               rtol=2e-3)
