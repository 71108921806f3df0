"""The port's multi-device paths (ame_tpu_torch.parallel: mesh, sequence,
sp_master, bands; scan_iir.zero_input_response / lfilter_scan,
pydub_gain.pydub_gain_ends; the shard_time entry points) on the CPU. A
mesh of D shards names the CPU D times; ame_tpu's counterparts run on its
8 virtual CPU devices (tests/conftest.py) at tests/test_parallel.py's own
shapes and settings, held to its tolerances, and the port's sharded chain
also to the port's one-device master_graph. Each reference is computed
once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.dsp import design
from ame_tpu_torch.graph.chain import master_graph
from ame_tpu_torch.ops.scan_iir import sosfilt
from ame_tpu_torch.parallel.mesh import make_mesh
from tests.conftest import make_test_signal

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _mesh(n=8, axis="sp"):
    return make_mesh({axis: n}, devices=["cpu"] * n)


def _ref_mesh(n=8, axis="sp"):
    from ame_tpu.parallel.mesh import make_mesh as ref_make_mesh
    return ref_make_mesh({axis: n}, devices=jax.devices()[:n])


def _ref_settings(s: MasterSettings):
    from ame_tpu.config import MasterSettings as RefSettings
    return RefSettings(**s.to_dict())


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

def test_make_mesh_axes_and_devices():
    mesh = make_mesh({"data": 2, "sp": 3}, devices=["cpu"] * 7)
    assert mesh.shape == {"data": 2, "sp": 3}
    assert mesh.axis_devices("sp") == [torch.device("cpu")] * 3
    assert len(mesh.axis_devices("data")) == 2
    assert make_mesh(devices=["cpu"] * 4).shape == {"data": 4}
    with pytest.raises(ValueError, match="wants 9"):
        make_mesh({"sp": 9}, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis_devices("band")


def test_make_mesh_defaults_to_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh({"sp": 1})


# ---------------------------------------------------------------------------
# Sequence-parallel filtering and its pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["pow2", "non_pow2"])
def test_sosfilt_sequence_parallel_matches_reference(case):
    """tests/test_parallel.py:33-61: D = 8, 1024-sample shards (LP 250 Hz
    on noise) and 1000-sample ones (HP 4 kHz on a sweep), atol 2e-5 against
    ame_tpu's sequence-parallel filter and the port's one-device sosfilt,
    no spike after a shard boundary."""
    from ame_tpu.parallel.sequence import (
        sosfilt_sequence_parallel as ref_sp)
    from ame_tpu_torch.parallel.sequence import sosfilt_sequence_parallel
    if case == "pow2":
        n, kind, sos = 1024 * 8, "noise", design.butter_sos(
            4, 250.0, "lowpass", fs=44100)
    else:
        n, kind, sos = 1000 * 8, "sweep", design.butter_sos(
            4, 4000.0, "highpass", fs=44100)
    x = make_test_signal(kind, n, 44100) * 0.3
    got = _np(sosfilt_sequence_parallel(sos, torch.from_numpy(x), _mesh()))
    want = np.asarray(ref_sp(sos, jnp.asarray(x), _ref_mesh(), axis="sp"))
    one = _np(sosfilt(sos, torch.from_numpy(x))[0])
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, one, atol=2e-5)
    err = np.abs(got - one).max(axis=-1)
    local = n // 8
    assert err[local:local + 32].max() <= max(err.max(), 1e-7)


def test_sosfilt_sequence_parallel_shards_guards_and_one_shard():
    from ame_tpu_torch.parallel.sequence import (sosfilt_sequence_parallel,
                                                 sosfilt_shards)
    sos = design.butter_sos(4, 1000.0, "lowpass", fs=44100)
    x = torch.from_numpy(make_test_signal("noise", 4096, 44100, seed=2))
    one = sosfilt(sos, x)[0]
    parts = sosfilt_shards(sos, list(x.chunk(4)))
    assert len(parts) == 4
    torch.testing.assert_close(torch.cat(parts), one, atol=2e-5, rtol=0)
    # one shard: the carry work is skipped, the result is sosfilt's
    torch.testing.assert_close(sosfilt_sequence_parallel(sos, x, _mesh(1)),
                               one, atol=0, rtol=0)
    with pytest.raises(ValueError, match="not divisible"):
        sosfilt_sequence_parallel(sos, x[:-1], _mesh(8))
    with pytest.raises(NotImplementedError, match="host-known"):
        sosfilt_sequence_parallel(torch.from_numpy(sos), x, _mesh(8))


def test_sosfilt_sequence_parallel_long_cascade():
    """A 16-band tree's top band (30 sections) runs as pieces of at most 8
    on every shard; the composed carry is the whole cascade's."""
    from ame_tpu_torch.graph.multiband import _band_cascades_n
    from ame_tpu_torch.parallel.sequence import sosfilt_sequence_parallel
    edges = tuple(float(e) for e in np.geomspace(60.0, 16000.0, 15).round(1))
    sos = _band_cascades_n(44100.0, edges)[-1]
    assert sos.shape[0] == 30
    x = torch.from_numpy(make_test_signal("noise", 8 * 1500, 44100, seed=4))
    torch.testing.assert_close(sosfilt_sequence_parallel(sos, x, _mesh()),
                               sosfilt(sos, x)[0], atol=2e-5, rtol=0)


def test_zero_input_response_matches_reference():
    """The cascade over zeros from a scipy-layout zi, against ame_tpu's
    superposition term; and sosfilt from zi == zero-state + the term."""
    from ame_tpu.ops.scan_iir import zero_input_response as ref_zir
    from ame_tpu_torch.ops.scan_iir import zero_input_response
    sos = np.concatenate([design.butter_sos(4, 250.0, "lowpass", fs=44100),
                          design.rbj_peaking(1000.0, 44100.0, 3.0, 1.41)])
    pre = make_test_signal("noise", 4096, 44100, seed=5)
    zi = sosfilt(sos, torch.from_numpy(pre))[1].numpy()  # a state audio
    n = 3000                                               # leaves
    got = _np(zero_input_response(sos, torch.from_numpy(zi), n))
    want = np.asarray(ref_zir(sos, jnp.asarray(zi), n))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-4)
    x = torch.from_numpy(make_test_signal("noise", n, 44100, seed=6))
    y_zi = sosfilt(sos, x, torch.from_numpy(zi))[0]
    torch.testing.assert_close(y_zi, sosfilt(sos, x)[0] + torch.from_numpy(
        got), atol=2e-6, rtol=0)
    with pytest.raises(NotImplementedError):
        zero_input_response(torch.from_numpy(sos), torch.from_numpy(zi), n)


def test_lfilter_scan_matches_reference():
    from ame_tpu.ops.scan_iir import lfilter_scan as ref_lfilter
    from ame_tpu_torch.ops.scan_iir import lfilter_scan
    b, a = design.butter_ba(2, 0.1, "low")
    x = make_test_signal("noise", 5000, 44100, seed=8)
    got = _np(lfilter_scan(b * 2.0, a * 2.0, torch.from_numpy(x)))
    np.testing.assert_allclose(got, np.asarray(ref_lfilter(
        b, a, jnp.asarray(x))), atol=2e-6)
    with pytest.raises(NotImplementedError):
        lfilter_scan(np.ones(4), np.ones(4), torch.from_numpy(x))


def test_pydub_gain_ends_bit_equal():
    """The end state only, from a non-zero init: bit-equal to ame_tpu's
    pydub_gain_ends and to the port's full walk's last row."""
    from ame_tpu.ops.pydub_gain import pydub_gain_ends as ref_ends
    from ame_tpu_torch.ops.pydub_gain import _gain_scan, _scal, pydub_gain_ends
    rng = np.random.default_rng(9)
    m = np.maximum(0.0, rng.standard_normal((3, 5000))).astype(np.float32)
    m[:, rng.random(5000) < 0.4] = 0.0
    init = np.array([0.0, 2.5, 7.0], np.float32)
    got = pydub_gain_ends(list(torch.from_numpy(m)), 80.0, 800.0,
                          torch.from_numpy(init))
    want = np.asarray(ref_ends([jnp.asarray(r) for r in m], 80.0, 800.0,
                               init=jnp.asarray(init)))
    np.testing.assert_array_equal(got.numpy(), want)
    walk = _gain_scan(torch.from_numpy(m).T, *_scal(80.0, 800.0),
                      torch.from_numpy(init))
    np.testing.assert_array_equal(got.numpy(), walk[-1].numpy())


@pytest.fixture(scope="module")
def gain_ramp():
    """tests/test_parallel.py:532-566's input: half-zero noise and the
    adversarial never-zero ramp (state live at every shard boundary), 8
    shards of 4096; ame_tpu's sharded relaxation once."""
    from functools import partial
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from ame_tpu.parallel.sp_compat import _pydub_gain_sp as ref_gain_sp
    n = 8 * 4096
    rng = np.random.default_rng(23)
    m_noise = np.maximum(0.0, rng.standard_normal(n)).astype(np.float32) * 5
    m_noise[rng.random(n) < 0.5] = 0.0
    m_ramp = (4.0 + np.sin(np.arange(n) / 3000.0)).astype(np.float32)
    m = np.stack([m_noise, m_ramp], axis=1)
    fn = shard_map(partial(ref_gain_sp, attack_frames=80.0,
                           release_frames=800.0, axis="sp"),
                   mesh=_ref_mesh(), in_specs=P("sp", None),
                   out_specs=P("sp", None), check_vma=False)
    return m, np.asarray(jax.jit(fn)(jnp.asarray(m)))


def _walk(m: np.ndarray, a_f: float, r_f: float) -> np.ndarray:
    """The sequential pydub walk in numpy float32, every product and sum
    rounded on its own. m [N, G]."""
    ia, ir = np.float32(1.0 / a_f), np.float32(1.0 / r_f)
    att = np.zeros(m.shape[1], np.float32)
    out = np.empty_like(m)
    for t in range(m.shape[0]):
        up = np.minimum(att + m[t] * ia, m[t])
        down = np.maximum(att - m[t] * ir, np.float32(0.0))
        att = np.where(att <= m[t], up, down).astype(np.float32)
        out[t] = att
    return out


def test_pydub_gain_sp_bit_equal(gain_ramp):
    """The shard-level carry relaxation on the adversarial ramp: bit-equal
    to the port's one-track engine and to the sequential walk; against
    ame_tpu's relaxation within atol 1e-5, median 0 (XLA on the CPU
    contracts att + m*ia into a fused multiply-add, so its walk rounds a
    last bit differently on some samples: tests/test_torch_pydub_gain.py's
    rule)."""
    from ame_tpu_torch.ops.pydub_gain import pydub_gain_multi
    from ame_tpu_torch.parallel.sp_compat import _pydub_gain_sp
    m, want = gain_ramp
    got = torch.cat(_pydub_gain_sp(list(torch.from_numpy(m).chunk(8)),
                                   80.0, 800.0)).numpy()
    one = torch.stack(pydub_gain_multi(list(torch.from_numpy(m).T), 80.0,
                                       800.0), dim=1).numpy()
    np.testing.assert_array_equal(got, one)
    np.testing.assert_array_equal(got, _walk(m, 80.0, 800.0))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.median(np.abs(got - want)) == 0.0


def test_pydub_gain_sp_sweeps(monkeypatch, gain_ramp):
    """The relaxation's sweeps: at most D engine sweeps (the ramp's state
    crosses every boundary, so more than one), one call a device a sweep
    (8 shards on one device share it), the accepted sweep's output
    returned as is; zeros are accepted after one."""
    from ame_tpu_torch.ops import pydub_gain as pg
    from ame_tpu_torch.parallel.sp_compat import _pydub_gain_sp
    calls = {"multi": 0}
    multi = pg.pydub_gain_multi

    def counted(*a, **k):
        calls["multi"] += 1
        return multi(*a, **k)

    monkeypatch.setattr(pg, "pydub_gain_multi", counted)
    m, want = gain_ramp
    got = _pydub_gain_sp(list(torch.from_numpy(m[:, 1:]).chunk(8)), 80.0,
                         800.0)
    np.testing.assert_array_equal(torch.cat(got).numpy()[:, 0],
                                  _walk(m[:, 1:], 80.0, 800.0)[:, 0])
    assert 1 < calls["multi"] <= 8
    calls.update(multi=0)
    zeros = torch.zeros((8 * 64, 2))
    _pydub_gain_sp(list(zeros.chunk(8)), 80.0, 800.0)
    assert calls == {"multi": 1}     # accepted at once


# ---------------------------------------------------------------------------
# The sequence-parallel quality chain
# ---------------------------------------------------------------------------

def _quality_input():
    """tests/test_parallel.py:149-155: 8 s, a 3x loud section."""
    sr = 44100
    n = 8 * sr
    x = make_test_signal("noise", n, sr, seed=3) * 0.15
    t = np.arange(n) / sr
    x[:, 0] += 0.1 * np.sin(2 * np.pi * 220.0 * t)
    x[n // 3: n // 3 + sr] *= 3.0
    return sr, np.clip(x, -0.9, 0.9).astype(np.float32)


def _mb_input():
    """tests/test_parallel.py:274-280."""
    sr = 44100
    n = 8 * sr
    x = make_test_signal("noise", n, sr, seed=5) * 0.15
    t = np.arange(n) / sr
    x[:, 0] += 0.2 * np.sin(2 * np.pi * 180.0 * t)
    x[n // 2: n // 2 + sr] *= 2.5
    return sr, np.clip(x, -0.9, 0.9).astype(np.float32)


def _gband_input():
    """tests/test_parallel.py:300-304."""
    sr = 22050
    x = make_test_signal("sweep", 8 * sr, sr, seed=6) * 0.3
    x[:, 1] *= 0.8
    return sr, x.astype(np.float32)


def _padded_input():
    """tests/test_parallel.py:195-199: 5 s + 12345 samples."""
    sr = 44100
    x = make_test_signal("noise", 5 * sr + 12345, sr, seed=11) * 0.12
    x[: sr] *= 2.5
    return sr, np.clip(x, -0.9, 0.9).astype(np.float32)


QUALITY_CASES = {
    "plain": (_quality_input, MasterSettings(
        bass_boost=2.0, presence_boost=1.0, width=1.2,
        analog_character=20.0, lufs=-14.0, mode="quality"),
        ("input_i", "input_lra", "input_tp", "gain_db"), 3e-4, False),
    "mb3": (_mb_input, MasterSettings(
        bass_boost=1.5, width=1.2, multiband=True, low_thresh=-30.0,
        mid_thresh=-28.0, high_thresh=-30.0, lufs=-14.0, mode="quality"),
        ("input_i", "gain_db"), 5e-4, False),
    "gband": (_gband_input, MasterSettings(
        multiband=True, mb_edges=(200.0, 1500.0, 5000.0),
        mb_thresholds=(-32.0, -30.0, -28.0, -30.0),
        mb_ratios=(3.0, 3.0, 4.0, 4.0), lufs=None, mode="quality"),
        (), 5e-4, False),
    "padded": (_padded_input, MasterSettings(bass_boost=1.5, lufs=-14.0,
                                             mode="quality"),
               ("input_i", "input_lra", "input_tp", "gain_db"), 3e-4, True),
}


@pytest.fixture(scope="module")
def quality_refs():
    """ame_tpu's sequence-parallel master of each case, once."""
    from ame_tpu.parallel.sp_master import (
        master_sequence_parallel as ref_sp,
        master_sequence_parallel_padded as ref_sp_padded)
    out = {}
    for name, (make, s, _, _, padded) in QUALITY_CASES.items():
        sr, x = make()
        fn = ref_sp_padded if padded else ref_sp
        y, info = fn(jnp.asarray(x), sr, _ref_settings(s), _ref_mesh())
        out[name] = (np.asarray(y), {k: float(v) for k, v in info.items()})
    return out


@pytest.mark.parametrize("case", list(QUALITY_CASES))
def test_sp_quality_matches_reference(case, quality_refs):
    """D = 8 against ame_tpu's sharded chain (tests/test_parallel.py's
    tolerances: info 2e-2, output atol 3e-4 / 5e-4, rtol 2e-3) and against
    the port's one-device master_graph (the same)."""
    from ame_tpu_torch.parallel.sp_master import (
        master_sequence_parallel, master_sequence_parallel_padded)
    make, s, keys, atol, padded = QUALITY_CASES[case]
    sr, x = make()
    fn = master_sequence_parallel_padded if padded else \
        master_sequence_parallel
    y, info = fn(torch.from_numpy(x), sr, s, _mesh())
    assert y.shape == x.shape
    y_ref, info_ref = quality_refs[case]
    y_one, info_one = master_graph(torch.from_numpy(x), sr, s)
    for k in keys:
        assert abs(float(info[k]) - info_ref[k]) < 2e-2, (k, info[k])
        assert abs(float(info[k]) - float(info_one[k])) < 2e-2, k
    np.testing.assert_allclose(_np(y), y_ref, atol=atol, rtol=2e-3)
    np.testing.assert_allclose(_np(y), _np(y_one), atol=atol, rtol=2e-3)


def test_limiter_sharded_across_a_boundary():
    """The halo'd limiter where limiting crosses a shard boundary: within
    1e-5 of the one-device lookahead_limiter (the warm-up term is ~e^-20;
    the rest is the release scan's f32 rounding over other block counts),
    its gain below 1 on both sides of the boundary."""
    from ame_tpu_torch.ops.limiter import lookahead_limiter
    from ame_tpu_torch.parallel.sp_master import _limiter_sharded
    sr = 44100
    rng = np.random.default_rng(14)
    x = (0.3 * rng.standard_normal((8 * sr, 2))).astype(np.float32)
    x[3 * sr - 2000: 3 * sr + 2000] *= 4.0        # loud across shard 3 | 4
    xt = torch.from_numpy(x)
    got = torch.cat(_limiter_sharded(list(xt.chunk(8)), sr, 1.0))
    want, gain = lookahead_limiter(xt, sr, return_gain=True)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert float(gain[3 * sr - 10]) < 0.9 and float(gain[3 * sr + 10]) < 0.9


def test_sp_quality_guards():
    """tests/test_parallel.py:170-184, plus a traced-like n_valid."""
    from ame_tpu_torch.parallel.sp_master import master_sequence_parallel
    x = torch.zeros((8 * 4410, 2))
    with pytest.raises(ValueError):      # compat loudnorm needs >= 3.1 s
        master_sequence_parallel(x, 44100, MasterSettings(mode="compat"),
                                 _mesh())
    with pytest.raises(ValueError):      # 8 shards of 4409.875 samples
        master_sequence_parallel(x[:-1], 44100, MasterSettings(lufs=-14.0),
                                 _mesh())
    with pytest.raises(ValueError):      # shard not a hop multiple
        master_sequence_parallel(x[: 8 * 441], 44100,
                                 MasterSettings(lufs=-14.0), _mesh())
    with pytest.raises(ValueError, match="concrete"):
        master_sequence_parallel(x, 44100, MasterSettings(lufs=-14.0),
                                 _mesh(), n_valid=torch.tensor(100))
    with pytest.raises(ValueError, match="mode"):
        master_sequence_parallel(x, 44100, MasterSettings(mode="other"),
                                 _mesh())


def test_sp_single_shard_mesh():
    """tests/test_parallel.py:632-651: a 1-shard mesh, quality and compat
    multiband, against the one-device chain (atol 2e-3, rtol 5e-3)."""
    from ame_tpu_torch.parallel.sp_master import master_sequence_parallel
    sr = 16000
    x = make_test_signal("noise", 4 * sr, sr, seed=41) * 0.2
    x = (np.trunc(np.clip(x, -1, 1) * 32767.0) / 32768.0).astype(np.float32)
    for mode in ("quality", "compat"):
        s = MasterSettings(bass_boost=2.0, multiband=True, lufs=-14.0,
                           mode=mode)
        y, _ = master_sequence_parallel(torch.from_numpy(x), sr, s, _mesh(1))
        y_one, _ = master_graph(torch.from_numpy(x), sr, s)
        np.testing.assert_allclose(_np(y), _np(y_one), atol=2e-3, rtol=5e-3)


# ---------------------------------------------------------------------------
# Band-parallel multiband
# ---------------------------------------------------------------------------

def test_multiband_band_parallel_matches_reference():
    """tests/test_parallel.py:236-253: 4 bands on a 4-device band axis
    against ame_tpu's band-parallel stage and the one-device
    multiband_quality_n (atol 3e-5, rtol 1e-4)."""
    from ame_tpu.parallel.bands import (
        multiband_band_parallel as ref_bands)
    from ame_tpu_torch.graph.multiband import multiband_quality_n
    from ame_tpu_torch.parallel.bands import multiband_band_parallel
    edges = (150.0, 1000.0, 6000.0)
    th = [-26.0, -22.0, -19.0, -16.0]
    ra = [2.0, 2.5, 3.0, 4.0]
    x = make_test_signal("sweep", 1 << 14, 44100, seed=7) * 0.4
    x[:, 1] *= 0.7
    x = x.astype(np.float32)
    got = _np(multiband_band_parallel(torch.from_numpy(x), 44100.0, edges,
                                      th, ra, _mesh(4, "band")))
    want = np.asarray(ref_bands(jnp.asarray(x), 44100.0, edges, th, ra,
                                _ref_mesh(4, "band")))
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
    one = _np(multiband_quality_n(torch.from_numpy(x), 44100.0, edges, th,
                                  ra))
    np.testing.assert_allclose(got, one, atol=3e-5, rtol=1e-4)


def test_multiband_band_parallel_wrong_mesh_size():
    from ame_tpu_torch.parallel.bands import multiband_band_parallel
    x = torch.zeros((4096, 2))
    with pytest.raises(ValueError, match="exactly G"):
        multiband_band_parallel(x, 44100.0, (250.0,), [-20.0, -16.0],
                                [2.0, 3.0], _mesh(4, "band"))


# ---------------------------------------------------------------------------
# The clamp-approximation compressor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 5000])
def test_multiband_compat_fast_matches_reference(monkeypatch, chunk):
    """multiband_compat(exact=False) (pydub_compress_fast a band, each
    chunk a fresh call when chunked) against ame_tpu's, within 1 LSB."""
    from ame_tpu.graph.multiband import multiband_compat as ref_mb
    from ame_tpu_torch.graph.multiband import multiband_compat
    rng = np.random.default_rng(12)
    n = 1 << 14
    x = 0.3 * rng.standard_normal((n, 2))
    x[n // 2:] *= 3.0
    x = (np.trunc(np.clip(x, -1, 1) * 32767.0) / 32768.0).astype(np.float32)
    th, ra = [-30.0, -28.0, -30.0], [4.0, 3.0, 4.0]
    got = _np(multiband_compat(torch.from_numpy(x), 44100.0, th, ra,
                               exact=False, chunk_len=chunk))
    want = np.asarray(ref_mb(jnp.asarray(x), 44100.0, jnp.asarray(th),
                             jnp.asarray(ra), exact=False, chunk_len=chunk))
    assert np.abs(got - want).max() <= 1.0 / 32768.0
    exact = _np(multiband_compat(torch.from_numpy(x), 44100.0, th, ra,
                                 chunk_len=chunk))
    assert np.abs(got - exact).max() > 0      # a different walk


def test_pydub_gain_fast_clip_algebra():
    """_pydub_gain_fast against the sequential clamp walk it scans (three
    blocks of 2^16), and against ame_tpu's."""
    from ame_tpu.ops.compressor import _pydub_gain_fast as ref_fast
    from ame_tpu_torch.ops.compressor import _pydub_gain_fast
    rng = np.random.default_rng(13)
    n = 3 * (1 << 16) + 77
    m = np.maximum(0.0, 3.0 * rng.standard_normal(n)).astype(np.float32)
    above = rng.random(n) < 0.6
    got = _pydub_gain_fast(torch.from_numpy(above), torch.from_numpy(m),
                           220.5, 2205.0).numpy()
    want = np.asarray(ref_fast(jnp.asarray(above), jnp.asarray(m),
                               jnp.float32(220.5), jnp.float32(2205.0)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    inc = m / np.float32(220.5)
    dec = m / np.float32(2205.0)
    g, walk = np.float32(0.0), np.empty(n, np.float32)
    for i in range(n):
        g = (min(max(g + inc[i], 0.0), m[i]) if above[i]
             else max(g - dec[i], 0.0))
        walk[i] = g
    np.testing.assert_allclose(got, walk, atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# The entry points: shard_time and the sp pool
# ---------------------------------------------------------------------------

def test_master_array_shard_time(tmp_path):
    """tests/test_parallel.py:439-457 on the port: master_array(
    shard_time=True) runs the padded sp chain (on device="cpu" the pool is
    the CPU once) with no degrade warning, and matches the unsharded
    master (gain 5e-2, atol 2e-3)."""
    from ame_tpu_torch.api import master_array
    from ame_tpu_torch.io.wav import read_wav
    sr = 16000
    x = make_test_signal("noise", int(5.3 * sr), sr, seed=21) * 0.2
    s = {"bass_boost": 2.0, "width": 1.2, "lufs": -14.0, "mode": "quality"}
    p1, p2 = str(tmp_path / "one.wav"), str(tmp_path / "sp.wav")
    msgs = []
    info_1 = master_array(x, sr, p1, dict(s), device="cpu")
    info_sp = master_array(x, sr, p2, dict(s), msgs.append, device="cpu",
                           shard_time=True)
    assert "Running time-sharded mastering graph over 1 devices..." in msgs
    assert not any("unavailable" in m for m in msgs), msgs
    assert "Running mastering graph on device..." not in msgs
    assert abs(info_sp["gain_db"] - info_1["gain_db"]) < 5e-2
    y1, _ = read_wav(p1)
    y2, _ = read_wav(p2)
    np.testing.assert_allclose(np.asarray(y2, np.float32),
                               np.asarray(y1, np.float32), atol=2e-3)


def test_shard_time_pool_and_config_error(tmp_path, monkeypatch):
    """The pool is every card capped by AME_TPU_SP_DEVICES, the CPU once
    on request; a malformed cap raises SpConfigError through master_array
    and process_audio's error status, never the degrade."""
    from ame_tpu_torch import api
    assert api._sp_devices(torch.device("cpu")) == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("AME_TPU_SP_DEVICES", "2")
    assert api._sp_devices(torch.device("cuda:1")) == [
        torch.device("cuda:0"), torch.device("cuda:1")]
    monkeypatch.delenv("AME_TPU_SP_DEVICES")
    assert len(api._sp_devices(torch.device("cuda"))) == 4
    monkeypatch.setenv("AME_TPU_SP_DEVICES", "x")
    with pytest.raises(api.SpConfigError, match="'x'"):
        api._sp_devices(torch.device("cuda"))
    monkeypatch.undo()
    monkeypatch.setattr(api, "_sp_devices", lambda d: (_ for _ in ()).throw(
        api.SpConfigError("AME_TPU_SP_DEVICES must be an integer")))
    sr = 16000
    x = make_test_signal("tone", 2 * sr, sr) * 0.3
    msgs = []
    with pytest.raises(api.SpConfigError):
        api.master_array(x, sr, str(tmp_path / "b.wav"), {"lufs": None},
                         msgs.append, device="cpu", shard_time=True)
    assert not any("unavailable" in m for m in msgs)


def test_shard_time_degrades_on_an_ineligible_track(tmp_path):
    """Compat loudnorm under 3.1 s is not for the sharded chain: the
    reference's warning, then the one-device master, equal to it."""
    from ame_tpu_torch.api import master_array
    from ame_tpu_torch.io.wav import read_wav
    sr = 16000
    x = make_test_signal("noise", 2 * sr, sr, seed=3) * 0.2
    s = {"mode": "compat", "lufs": -14.0}
    msgs = []
    master_array(x, sr, str(tmp_path / "sp.wav"), dict(s), msgs.append,
                 device="cpu", shard_time=True)
    master_array(x, sr, str(tmp_path / "one.wav"), dict(s), device="cpu")
    warn = [m for m in msgs if m.startswith("Warning: time-sharding")]
    assert warn == ["Warning: time-sharding unavailable (compat loudnorm "
                    "needs >= 3.1 s of audio (the controller's priming "
                    "window); use the single-chip graph for short "
                    "tracks); falling back to one device."], msgs
    assert msgs.index(warn[0]) < msgs.index(
        "Running mastering graph on device...")
    np.testing.assert_array_equal(read_wav(str(tmp_path / "sp.wav"))[0],
                                  read_wav(str(tmp_path / "one.wav"))[0])


def test_cli_master_shard_time(tmp_path, capsys):
    """tests/test_parallel.py:460-473 on the port's CLI, --device cpu."""
    import json
    from ame_tpu_torch.cli import main
    from ame_tpu_torch.io.wav import read_wav, write_wav
    sr = 16000
    x = make_test_signal("tone", 4 * sr, sr) * 0.4
    pin, pout = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    write_wav(pin, x, sr)
    rc = main(["master", pin, pout, "--bass", "1.5", "--no-lufs",
               "--shard-time", "--device", "cpu"])
    assert rc == 0
    cap = capsys.readouterr()
    assert "time-sharded mastering graph over 1 devices" in cap.err
    assert "unavailable" not in cap.err
    assert json.loads(cap.out.strip().splitlines()[-1])["n_samples"] == 4 * sr
    y, _ = read_wav(pout)
    assert y.shape[0] == 4 * sr and np.isfinite(y).all()
