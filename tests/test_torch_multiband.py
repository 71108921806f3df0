"""Quality multiband in the port against ame_tpu's on the same numpy inputs,
on the CPU: the LR4 designs, the 3-band and G-band crossover splits, the
quality compressor, the multiband stages, ``sosfilt`` on cascades longer
than the kernel's 8 sections, and the chain with ``multiband=True`` and
``mb_edges``. Outputs are held within 2e-4 abs (the quality chain's
tolerance in tests/test_torch_chain.py)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from scipy.signal import sosfilt as scipy_sosfilt

from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.dsp import design
from ame_tpu_torch.graph import multiband
from ame_tpu_torch.graph.chain import master_graph
from ame_tpu_torch.ops import cascade_scan, compressor
from ame_tpu_torch.ops.scan_iir import sosfilt
from tests.conftest import make_test_signal

SR = 44100
TOL = 2e-4
EDGES_16 = tuple(float(e) for e in np.geomspace(60.0, 16000.0, 15).round(1))
EDGES = {"g3": (250.0, 4000.0), "g16": EDGES_16}


def _x(n=1 << 14, seed=0, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal((n, 2))
            ).astype(np.float32)


@pytest.mark.parametrize("kind", ["lp", "hp", "allpass"])
@pytest.mark.parametrize("hz", [60.0, 250.0, 4000.0, 16000.0])
def test_lr4_designs_match_reference(kind, hz):
    from ame_tpu.dsp import design as ref
    if kind == "allpass":
        got, want = (d.lr4_allpass_sos(hz, SR) for d in (design, ref))
    else:
        btype = "lowpass" if kind == "lp" else "highpass"
        got, want = (d.linkwitz_riley_sos(4, hz, btype, SR)
                     for d in (design, ref))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("G", [3, 5, 16])
def test_band_cascades_match_reference(G):
    """The same cascades as ame_tpu's tree, band g of g + G sections
    (g < G - 1) and the top band of 2(G - 1): up to 30 at G = 16, more
    than the kernel's 8 from G = 6 on."""
    from ame_tpu.graph.multiband import _band_cascades_n as ref
    edges = tuple(float(e) for e in np.geomspace(80.0, 12000.0, G - 1))
    got, want = (f(float(SR), edges)
                 for f in (multiband._band_cascades_n, ref))
    assert [c.shape[0] for c in got] == [g + G for g in range(G - 1)] + [
        2 * (G - 1)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("with_zi", [False, True], ids=["zero_zi", "zi"])
@pytest.mark.parametrize("k", [9, 17, 30])
def test_sosfilt_splits_long_cascades(k, with_zi):
    """A cascade of more than 8 sections runs as pieces of at most 8 in
    turn: float64 scipy's y and zf within 2e-5 (the top band of a 16-band
    tree has 30 sections); zi is split and zf joined in section order."""
    sos = multiband._band_cascades_n(float(SR), EDGES_16)[-1][:k]
    x = _x(4000, seed=k)
    # the port's zi / zf layout is [k, C, 2]; scipy's along axis 0 [k, 2, C]
    zi = (0.01 * np.random.default_rng(k).standard_normal((k, 2, 2))
          if with_zi else np.zeros((k, 2, 2))).astype(np.float32)
    want, want_zf = scipy_sosfilt(sos, x.astype(np.float64), axis=0,
                                  zi=zi.transpose(0, 2, 1))
    y, zf = sosfilt(sos, torch.from_numpy(x),
                    torch.from_numpy(zi) if with_zi else None)
    assert k > cascade_scan._MAX_SECTIONS
    assert np.abs(y.numpy() - want).max() <= 2e-5
    assert zf.shape == (k, 2, 2)
    assert np.abs(zf.numpy() - want_zf.transpose(0, 2, 1)).max() <= 2e-5


def test_quality_band_split_matches_reference():
    """3-band LR4 split (each band one cascade off x) within 2e-4 of
    ame_tpu's; its mid and high bands are the G-band split's at the same
    two edges (whose low band adds the 4 kHz allpass); the bands sum to an
    allpass of x (their sum keeps x's energy)."""
    from ame_tpu.graph.multiband import quality_band_split as ref
    x = _x()
    want = ref(jnp.asarray(x), float(SR))
    got = multiband.quality_band_split(torch.from_numpy(x), SR)
    for a, b in zip(got, want):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL
    split_n = multiband.quality_band_split_n(torch.from_numpy(x), SR,
                                             EDGES["g3"])
    for a, b in zip(got[1:], split_n[1:]):
        assert np.abs(a.numpy() - b.numpy()).max() <= 1e-6
    total = sum(b.numpy().astype(np.float64) for b in got)
    assert abs(np.sum(total ** 2) / np.sum(x.astype(np.float64) ** 2)
               - 1.0) < 0.02


@pytest.mark.parametrize("g", ["g3", "g16"])
def test_quality_band_split_n_matches_reference(g):
    from ame_tpu.graph.multiband import quality_band_split_n as ref
    x = _x()
    want = ref(jnp.asarray(x), float(SR), EDGES[g])
    got = multiband.quality_band_split_n(torch.from_numpy(x), SR, EDGES[g])
    assert len(got) == len(EDGES[g]) + 1
    for a, b in zip(got, want):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL


def _program(n=1 << 14, seed=0):
    x = make_test_signal("noise", n, SR, seed=seed) * 0.05
    x[n // 3: 2 * n // 3] *= 12.0
    return np.clip(x, -1, 1).astype(np.float32)


def test_compress_quality_matches_reference():
    """The single-band quality compressor with makeup gain: within 2e-4 of
    ame_tpu's, and it compresses (the loud part is turned down)."""
    from ame_tpu.ops.compressor import compress_quality as ref
    x = _program()
    want = np.asarray(ref(jnp.asarray(x), float(SR), -20.0, 4.0,
                          makeup_db=2.0))
    got = compressor.compress_quality(torch.from_numpy(x), SR, -20.0, 4.0,
                                      makeup_db=2.0).numpy()
    assert np.abs(got - want).max() <= TOL
    n = len(x)
    mid = slice(n // 3 + 2000, 2 * n // 3)
    assert np.abs(got[mid]).max() < np.abs(x[mid]).max() * 10 ** (2 / 20)


def test_compress_quality_multi_matches_reference():
    """Three bands with their own thresholds and ratios through one stacked
    detector, release scan and attack smoother (a k=1 cascade at C = 3)."""
    from ame_tpu.ops.compressor import compress_quality_multi as ref
    x = _program()
    bands = [x * s for s in (1.0, 0.6, 0.3)]
    th, ra = [-25.0, -20.0, -15.0], [6.0, 3.0, 4.0]
    want = ref([jnp.asarray(b) for b in bands], float(SR), th, ra)
    got = compressor.compress_quality_multi(
        [torch.from_numpy(b) for b in bands], SR, th, ra)
    for a, b in zip(got, want):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL


@pytest.mark.parametrize("g", ["g3", "g16"])
def test_multiband_quality_matches_reference(g):
    """The 3-band stage (multiband_quality) and the G-band one
    (multiband_quality_n) on a program that crosses the thresholds."""
    from ame_tpu.graph import multiband as ref
    x = _program(seed=3)
    G = len(EDGES[g]) + 1
    th = np.linspace(-30.0, -20.0, G).astype(np.float32)
    ra = np.linspace(2.0, 6.0, G).astype(np.float32)
    if g == "g3":
        want = ref.multiband_quality(jnp.asarray(x), float(SR),
                                     jnp.asarray(th), jnp.asarray(ra))
        got = multiband.multiband_quality(torch.from_numpy(x), SR,
                                          torch.from_numpy(th),
                                          torch.from_numpy(ra))
    else:
        want = ref.multiband_quality_n(jnp.asarray(x), float(SR), EDGES[g],
                                       jnp.asarray(th), jnp.asarray(ra))
        got = multiband.multiband_quality_n(torch.from_numpy(x), SR,
                                            EDGES[g], torch.from_numpy(th),
                                            torch.from_numpy(ra))
    got, want = got.numpy(), np.asarray(want)
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - x).max() > 0.01          # it compresses


@pytest.mark.parametrize("settings", [
    dict(multiband=True, analog_character=20.0, bass_boost=2.0,
         presence_boost=1.5, width=1.2, lufs=-14.0),
    dict(mb_edges=EDGES_16, mb_thresholds=(-30.0,) * 16, lufs=-14.0),
], ids=["flagship_multiband", "g16_edges"])
def test_quality_multiband_chain_matches_reference(settings):
    """master_graph, quality mode with the multiband stage: within 2e-4 abs
    and the loudness gain within 0.01 dB of ame_tpu's, as
    tests/test_torch_chain.py holds the quality chain."""
    from ame_tpu.config import MasterSettings as RefSettings
    from ame_tpu.graph.chain import master_graph as ref_master_graph
    x = _program(1 << 15, seed=1) * 0.5
    y_ref, info_ref = ref_master_graph(jnp.asarray(x), float(SR),
                                       RefSettings(**settings))
    timer = {}
    y, info = master_graph(torch.from_numpy(x), SR,
                           MasterSettings(**settings), timer=timer)
    assert np.abs(y.numpy() - np.asarray(y_ref)).max() <= TOL
    assert abs(float(info["gain_db"]) - float(info_ref["gain_db"])) <= 0.01
    assert set(timer) == {"analog_eq_width", "multiband", "loudnorm",
                          "limiter"}
