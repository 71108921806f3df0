"""Chunked compat (compat_chunked=True, quirk Q6) in the port against
ame_tpu's on the same numpy inputs, on the CPU: the per-chunk filter resets
(``sosfilt_chunked`` and the stages that take ``chunk_len``), the chunked
detector and gain (``pydub_gain_chunked``, K2's reset route through its
plain version ``gain_jacobi_plain``) and the chunked chain.

Rounding of the gain walk, as in tests/test_torch_pydub_gain.py: port vs
port (and vs the separately rounded numpy walk) bit for bit; port vs
ame_tpu atol 1e-5 with median 0 (XLA contracts ``att + m*ia`` into an
FMA)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from scipy.signal import sosfilt as scipy_sosfilt

import ame_tpu.config as ref_config
import ame_tpu_torch.config as port_config
from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.dsp import design
from ame_tpu_torch.graph import multiband
from ame_tpu_torch.graph.chain import master_graph
from ame_tpu_torch.ops import compressor, eq, quantize, saturate
from ame_tpu_torch.ops import pydub_gain as pg
from ame_tpu_torch.ops.scan_iir import sosfilt_chunked
from tests import oracles
from tests.conftest import make_test_signal

SR = 44100
ATTACK, RELEASE = 220.5, 2205.0
LSB = 1.0 / 32768.0
CHUNK = 1500          # not a multiple of 32: resets fall inside groups


def _walk_resets(m, chunk, ia, ir):
    """The numpy walk (product and sum rounded apart) from zero state, the
    state zeroed at every chunk start. m: [G, n]."""
    f32 = np.float32
    att = np.zeros(m.shape[0], f32)
    out = np.empty_like(m)
    ia, ir = f32(ia), f32(ir)
    for t in range(m.shape[1]):
        if t % chunk == 0:
            att = np.zeros_like(att)
        mt = m[:, t]
        att = np.where(att <= mt, np.minimum(att + mt * ia, mt),
                       np.maximum(att - mt * ir, f32(0.0)))
        out[:, t] = att
    return out


def _silent_boundary_m(n=12000, G=3, seed=5):
    """[G, n] max-attenuations with a silent run (m == 0) from sample 2000
    to 4200 right after an active stretch: the run holds the chunk
    boundary at 3000 and covers the engine's whole second Jacobi segment
    (padded samples 2048..4096 of 16384 at S = 8), so the state entering
    the third segment is 0 only because of the reset inside the second."""
    rng = np.random.default_rng(seed)
    m = np.zeros((G, n), np.float32)
    for g in range(G):
        m[g, 100:2000] = (g + 1.0) * np.abs(rng.standard_normal(1900))
        m[g, 4200:9000] = (g + 1.5) * np.abs(rng.standard_normal(4800))
        m[g, 9500:9800] = 2.0 + g
    return m


def test_pydub_gain_chunked_bit_equal_walk():
    """The chunked engine (Jacobi with K2's reset route, plain versions)
    reproduces the walk with resets bit for bit, and the state is non-zero
    where the silent run begins (the boundary at 3000 falls inside it)."""
    m = _silent_boundary_m()
    ia, ir = pg._scal(ATTACK, RELEASE)
    got = torch.stack(pg.pydub_gain_chunked(
        [torch.from_numpy(v) for v in m], ATTACK, RELEASE, CHUNK)).numpy()
    want = _walk_resets(m, CHUNK, ia, ir)
    np.testing.assert_array_equal(got, want)
    assert (want[:, 2000:3000] > 0.0).all()
    assert (want[:, 3000:4200] == 0.0).all()


@pytest.mark.parametrize("route", ["pallas_interpret", "scan"])
def test_pydub_gain_chunked_matches_reference(route):
    """Against ame_tpu.ops.pydub_gain.pydub_gain_chunked: its Pallas engines
    in the interpreter (the reset route of _jac_kernel, has_resets=True) or
    its scan route (_gain_scan_reset), as tests/test_compressor.py runs
    them; atol 1e-5, median 0."""
    from ame_tpu.ops import pydub_gain as ref
    m = _silent_boundary_m()
    kw = ({"interpret": True} if route == "pallas_interpret"
          else {"force_scan": True})
    want = np.stack([np.asarray(a) for a in ref.pydub_gain_chunked(
        [jnp.asarray(v) for v in m], ATTACK, RELEASE, CHUNK, **kw)])
    got = torch.stack(pg.pydub_gain_chunked(
        [torch.from_numpy(v) for v in m], ATTACK, RELEASE, CHUNK)).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 1e-5, diff.max()
    assert np.median(diff) == 0.0


def _chunked_layout(m, chunk):
    """pydub_gain_chunked's padded chain [G, npad] (chunks in whole groups,
    padded to the engine's block), its group flags [npad/32] and the
    Jacobi geometry (S, seg_len) of that length."""
    G, n = m.shape
    nc, cpad = -(-n // chunk), -(-chunk // pg._K) * pg._K
    rows = np.zeros((G, nc, cpad), np.float32)
    rows[:, :, :chunk] = np.pad(m, ((0, 0), (0, nc * chunk - n))).reshape(
        G, nc, chunk)
    npad = pg._pad_block(nc * cpad)
    m1 = np.zeros((G, npad), np.float32)
    m1[:, :nc * cpad] = rows.reshape(G, -1)
    flags = np.zeros(npad // pg._K, np.float32)
    flags[np.arange(nc) * (cpad // pg._K)] = 1.0
    S = pg._select_S(npad)
    return m1, flags, S, npad // S


def _time_major(m1, S, seg_len):
    G = m1.shape[0]
    return np.ascontiguousarray(m1.reshape(G, S, seg_len).transpose(
        2, 0, 1).reshape(seg_len, G * S))


def test_gain_jacobi_plain_resets_matches_reference_scan():
    """K2's plain version with the group flags, one full sweep from the true
    carries (the walk's state before each segment), is the walk with
    resets: bit for bit against the port's _gain_scan_reset, atol 1e-5 /
    median 0 against ame_tpu's _gain_scan_reset."""
    from ame_tpu.ops import pydub_gain as ref
    m1, flags, S, seg_len = _chunked_layout(_silent_boundary_m(), CHUNK)
    G, npad = m1.shape
    ia, ir = pg._scal(ATTACK, RELEASE)
    r = np.zeros((npad, 1), np.float32)
    r[::pg._K, 0] = flags
    walk = pg._gain_scan_reset(torch.from_numpy(m1.T.copy()),
                               torch.from_numpy(r), ia, ir).numpy().T
    carry = np.zeros((G, S), np.float32)
    carry[:, 1:] = walk[:, seg_len - 1:-1:seg_len]
    co, att_t = pg.gain_jacobi_plain(
        torch.from_numpy(_time_major(m1, S, seg_len)),
        torch.from_numpy(carry.reshape(-1)), ia, ir, True,
        torch.from_numpy(flags))
    att = att_t.numpy().reshape(seg_len, G, S).transpose(1, 2, 0).reshape(
        G, npad)
    np.testing.assert_array_equal(att, walk)
    np.testing.assert_array_equal(co.numpy().reshape(G, S),
                                  walk[:, seg_len - 1::seg_len])
    scal = jnp.asarray([[1.0 / ATTACK, 1.0 / RELEASE]], jnp.float32)
    want = np.asarray(ref._gain_scan_reset(jnp.asarray(m1.T), jnp.asarray(r),
                                           scal)).T
    diff = np.abs(att - want)
    assert diff.max() <= 1e-5 and np.median(diff) == 0.0


def _jac_reset_sweep(m_t, carry, flags, S, ia, ir, rows):
    """float32 numpy emulation of gain_jacobi's reset route
    (csrc/pydub_gain.cu, RESETS): lane l walks segment s = l % S in stages
    of `rows` rows (32 a full sweep, 64 a carry sweep); its group starts
    are rows phi + 32 j, phi = -s*seg_len mod 32, and its flags for a
    stage are flags[q0 + t0/32 + j] (q0 = (s*seg_len + phi)/32), 0 past
    seg_len; a stage with a set flag takes the checked walk, which zeroes
    the state before the update at a flagged start. Rows past seg_len walk
    m == 0. Returns (carry-outs, att_t)."""
    f32 = np.float32
    seg_len, lanes = m_t.shape
    nst = -(-seg_len // rows)
    mz = np.zeros((nst * rows, lanes), f32)
    mz[:seg_len] = m_t
    s = np.arange(lanes) % S
    a = s.astype(np.int64) * seg_len
    phi = (32 - a % 32) % 32
    q0 = (a + phi) // 32
    att = carry.astype(f32).copy()
    att_t = np.empty_like(mz)
    ia, ir = f32(ia), f32(ir)
    for k in range(nst):
        t0 = k * rows
        fl = np.zeros((rows // 32, lanes), f32)
        for j in range(rows // 32):
            ok = t0 + phi + 32 * j < seg_len
            fl[j, ok] = flags[(q0 + t0 // 32 + j)[ok]]
        hit = (fl != 0).any(axis=0)
        for r in range(rows):
            att = np.where(hit & (r % 32 == phi) & (fl[r // 32] != 0),
                           f32(0.0), att)
            mt = mz[t0 + r]
            att = np.where(att <= mt, np.minimum(att + mt * ia, mt),
                           np.maximum(att - mt * ir, f32(0.0)))
            att_t[t0 + r] = att
    return att, att_t[:seg_len]


@pytest.mark.parametrize("rows", [32, 64], ids=["full_sweep", "carry_sweep"])
@pytest.mark.parametrize("seg_len,S", [(136, 8), (200, 8), (584, 16),
                                       (2048, 8)])
def test_jacobi_reset_route_design_bit_equal_plain(seg_len, S, rows):
    """K2's reset-route design, emulated, gives gain_jacobi_plain's carry-
    outs and attenuations bit for bit: segment lengths that are not whole
    groups (group starts at a different row of each segment) and one that
    is, flags on the first group, on groups that straddle segment edges and
    at random, from random carries, in both stage geometries."""
    G = 3
    rng = np.random.default_rng(seg_len + rows)
    lanes = G * S
    m_t = np.maximum(0.0, 3.0 * rng.standard_normal((seg_len, lanes))
                     ).astype(np.float32)
    m_t[seg_len // 3:seg_len // 2] = 0.0
    ngroups = S * seg_len // 32
    flags = (rng.random(ngroups) < 0.08).astype(np.float32)
    flags[0] = 1.0
    flags[(np.arange(1, S) * seg_len) // 32] = 1.0
    carry = (6.0 * rng.random(lanes)).astype(np.float32)
    ia, ir = pg._scal(ATTACK, RELEASE)
    co, att_t = _jac_reset_sweep(m_t, carry, flags, S, ia, ir, rows)
    co_p, att_p = pg.gain_jacobi_plain(
        torch.from_numpy(m_t), torch.from_numpy(carry), ia, ir, True,
        torch.from_numpy(flags))
    np.testing.assert_array_equal(co, co_p.numpy())
    np.testing.assert_array_equal(att_t, att_p.numpy())
    assert (att_t == 0.0).any() and att_t.max() > 1.0


def test_reset_segment_is_not_an_identity(monkeypatch):
    """A segment of all-zero m that holds a reset is no identity: bridged
    as one, the stale non-zero state before the silent run would be carried
    past the reset to a wrong fixed point that the acceptance test still
    accepts. The engine excludes it and is exact; with the exclusion
    removed it is not."""
    m = _silent_boundary_m()
    m1, flags, S, seg_len = _chunked_layout(m, CHUNK)
    G = m1.shape[0]
    m_t = torch.from_numpy(_time_major(m1, S, seg_len))
    ident = pg._identity_segments(m_t, G, S, torch.from_numpy(flags))
    plain = pg._identity_segments(m_t, G, S)
    assert plain[:, 1].all() and not ident[:, 1].any()
    ia, ir = pg._scal(ATTACK, RELEASE)
    want = _walk_resets(m, CHUNK, ia, ir)

    def run():
        return torch.stack(pg.pydub_gain_chunked(
            [torch.from_numpy(v) for v in m], ATTACK, RELEASE,
            CHUNK)).numpy()
    np.testing.assert_array_equal(run(), want)
    monkeypatch.setattr(pg, "_identity_segments",
                        lambda m_t, G, S, resets=None:
                        (torch.amax(m_t, dim=0) == 0.0).reshape(G, S))
    stale = run()
    assert not np.array_equal(stale, want)
    assert np.abs(stale - want)[:, 4200:4400].max() > 0.1


@pytest.mark.parametrize("C,n,chunk", [(2, 1000, 300), (2, 1000, 350),
                                       (3, 1000, 300), (1, 1000, 140)],
                         ids=["c2_8cols", "c2_6cols", "c3_12cols",
                              "c1_8cols"])
def test_sosfilt_chunked_matches_reference(C, n, chunk):
    """Chunks as columns through the one sosfilt: scipy per chunk (float64)
    within 2e-5 abs, and ame_tpu's sosfilt_chunked within the same;
    channel counts n_chunks*C that are and are not multiples of K5's
    4-channel tile, and a ragged last chunk."""
    from ame_tpu.ops.scan_iir import sosfilt_chunked as ref
    sos = design.butter_sos(2, 100.0, "lowpass", fs=1000)
    x = (0.3 * np.random.default_rng(C + chunk).standard_normal((n, C))
         ).astype(np.float32)
    want = np.concatenate([scipy_sosfilt(sos, x[i:i + chunk].astype(
        np.float64), axis=0) for i in range(0, n, chunk)], axis=0)
    got = sosfilt_chunked(sos, torch.from_numpy(x), chunk).numpy()
    assert got.shape == (n, C)
    assert np.abs(got - want).max() <= 2e-5
    r = np.asarray(ref(sos, jnp.asarray(x), chunk))
    assert np.abs(got - r).max() <= 2e-5


def _int16_grid(x):
    return (np.trunc(np.clip(x, -1, 1) * 32767.0) / 32768.0).astype(
        np.float32)


@pytest.mark.parametrize("stage", ["eq", "analog", "crossover"])
def test_compat_stages_chunked_match_reference(stage):
    """apply_eq_compat, analog_character_compat and _crossover_compat with
    chunk_len against ame_tpu's: within one int16 LSB after the round trip
    (as tests/test_torch_compat_ops.py holds the unchunked stages), and
    different from the continuous-state stage right after a boundary."""
    from ame_tpu.graph import multiband as ref_mb
    from ame_tpu.ops import eq as ref_eq, saturate as ref_sat
    chunk = 3000
    x = _int16_grid(make_test_signal("noise", 10000, SR))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if stage == "eq":
        gains = (2.0, 1.0, 1.5, -2.0)
        want = ref_eq.apply_eq_compat(xj, float(SR), *(
            jnp.float32(g) for g in gains), chunk)
        got = eq.apply_eq_compat(xt, SR, *gains, chunk_len=chunk)
        cont = eq.apply_eq_compat(xt, SR, *gains)
    elif stage == "analog":
        want = ref_sat.analog_character_compat(xj, float(SR),
                                               jnp.float32(60.0), chunk)
        got = saturate.analog_character_compat(xt, SR, 60.0, chunk)
        cont = saturate.analog_character_compat(xt, SR, 60.0)
    else:
        want = jnp.concatenate(ref_mb._crossover_compat(xj, float(SR),
                                                        chunk), axis=1)
        got = torch.cat(multiband._crossover_compat(xt, SR, chunk), dim=1)
        cont = torch.cat(multiband._crossover_compat(xt, SR), dim=1)
    diff = np.abs(quantize.int16_roundtrip(got).numpy()
                  - _int16_grid(np.asarray(want)))
    assert diff.max() <= LSB, diff.max()
    seg = slice(chunk, chunk + 64)
    assert np.abs(got.numpy()[seg] - cont.numpy()[seg]).max() > 4 * LSB


def _program(n, seed=0):
    x = make_test_signal("noise", n, SR, seed=seed) * 0.05
    x[n // 3: 2 * n // 3] *= 12.0
    return np.clip(x, -1, 1)


def test_pydub_compress_exact_multi_chunked_matches_reference():
    """Detector and gain restart every chunk: against ame_tpu's
    pydub_compress_exact_multi_chunked and against per-chunk calls of the
    port's unchunked compressor, in the int16 domain, with
    tests/test_compressor.py's bounds (atol 2 against its per-chunk
    reference) and median 0."""
    from ame_tpu.ops.compressor import pydub_compress_exact_multi_chunked \
        as ref
    chunk = 2000
    x = _program(3 * chunk + 700)
    bands = [np.trunc(x * s * 32767.0).astype(np.float32)
             for s in (1.0, 0.7, 0.4)]
    th, ra = [-20.0, -22.0, -25.0], [4.0, 3.0, 6.0]
    got = compressor.pydub_compress_exact_multi_chunked(
        [torch.from_numpy(b) for b in bands], SR, th, ra, chunk)
    want = ref([jnp.asarray(b) for b in bands], float(SR), th, ra, chunk)
    for g in range(3):
        per_chunk = np.concatenate([compressor.pydub_compress_exact(
            torch.from_numpy(bands[g][c0:c0 + chunk]), SR, th[g],
            ra[g]).numpy() for c0 in range(0, len(x), chunk)])
        for other in (np.asarray(want[g]), per_chunk):
            diff = np.abs(got[g].numpy() - other)
            assert diff.max() <= 2.0, diff.max()
            assert np.median(diff) == 0.0


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


@pytest.mark.parametrize("sr,seconds,settings", [
    (8000, 1.0, dict(bass_boost=3.0, mid_cut=2.0, analog_character=20.0)),
    (16000, 0.5, dict(bass_boost=2.0, multiband=True, lufs=-14.0)),
], ids=["eq_8k", "multiband_16k"])
def test_chunked_chain_matches_reference(monkeypatch, sr, seconds, settings):
    """master_graph with compat_chunked=True and COMPAT_CHUNK_SECONDS
    shrunk in both packages so that the input crosses boundaries, against
    ame_tpu's: relative L2 < 3e-3 or max abs <= 2 int16 LSB (at the
    limiter's input: its auto-level scales by 1/0.98), as
    tests/test_chain.py holds the chunked chain; loudnorm gain within
    0.01 dB. The chunk resets are load-bearing: the unchunked port differs
    more from the reference right after a boundary."""
    from ame_tpu.config import MasterSettings as RefSettings
    from ame_tpu.graph.chain import master_graph as ref_master_graph
    monkeypatch.setattr(ref_config, "COMPAT_CHUNK_SECONDS", seconds)
    monkeypatch.setattr(port_config, "COMPAT_CHUNK_SECONDS", seconds)
    x = make_test_signal("noise", int(sr * 2.3), sr, seed=9) * 0.05
    x[sr // 3: 2 * sr // 3] *= 10.0
    x = oracles.int16_roundtrip(np.clip(x, -1, 1)).astype(np.float32)
    sd = dict(settings, mode="compat", compat_chunked=True)
    sd.setdefault("lufs", None)
    y_ref, info_ref = ref_master_graph(jnp.asarray(x), float(sr),
                                       RefSettings(**sd))
    y, info = master_graph(torch.from_numpy(x), sr, MasterSettings(**sd))
    y, y_ref = y.numpy(), np.asarray(y_ref)
    max_abs = np.abs(y - y_ref).max()
    assert (_rel_err(y, y_ref) < 3e-3
            or max_abs <= 2.0 * LSB / 0.98), max_abs
    assert set(info) == set(info_ref)
    if sd["lufs"] is not None:
        assert abs(float(info["gain_db"]) - float(info_ref["gain_db"])) \
            <= 0.01
    y_cont, _ = master_graph(torch.from_numpy(x), sr, MasterSettings(
        **dict(sd, compat_chunked=False)))
    chunk = int(seconds * sr)
    seg = slice(chunk, chunk + 256)
    assert (_rel_err(y[seg], y_ref[seg])
            < _rel_err(y_cont.numpy()[seg], y_ref[seg]))
