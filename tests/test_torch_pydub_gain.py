"""The port's exact pydub gain engine (ame_tpu_torch.ops.pydub_gain), the
exact compressor and the compat multiband stage against ame_tpu's. On the
CPU the engine runs the plain versions of its three kernels (gain_jacobi,
gain_p1, gain_p2); the reference runs its Pallas kernels in the
interpreter, as tests/test_compressor.py does.

Rounding: the port pins the update to separately rounded products and
sums, in the plain versions and in the CUDA kernels alike, so they agree
bit for bit. XLA on the CPU contracts ``att + m*ia`` into a fused
multiply-add, so the reference's scan rounds a last bit differently on
some samples: port vs reference is held to tests/test_compressor.py's
atol 1e-5 with median 0; port vs port is held bit for bit."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ame_tpu_torch.graph import multiband
from ame_tpu_torch.ops import compressor
from ame_tpu_torch.ops import pydub_gain as pg
from tests import oracles

SR = 44100
ATTACK, RELEASE = 220.5, 2205.0


def _bursts(n, G=3, seed=3):
    """[G, n] max-attenuations: a long active episode, a freeze run at a
    constant level and silence around them — the converging kind."""
    rng = np.random.default_rng(seed)
    m = np.zeros((G, n), np.float32)
    for g in range(G):
        a, b = n // 8, n // 2
        m[g, a:b] = (g + 1) * np.abs(rng.standard_normal(b - a))
        m[g, b + 1000:b + 3000] = 2.0
    return m


def _walk(m, ia, ir, init=None):
    """The recurrence in numpy f32, product and sum rounded separately.
    m: [G, n]."""
    att = np.zeros(m.shape[0], np.float32) if init is None else init.copy()
    out = np.empty_like(m)
    ia, ir = np.float32(ia), np.float32(ir)
    for t in range(m.shape[1]):
        mt = m[:, t]
        att = np.where(att <= mt, np.minimum(att + mt * ia, mt),
                       np.maximum(att - mt * ir, np.float32(0.0)))
        out[:, t] = att
    return out


def _ref_scan(m):
    from ame_tpu.ops.pydub_gain import _gain_scan
    scal = jnp.asarray([[1.0 / ATTACK, 1.0 / RELEASE]], jnp.float32)
    return np.asarray(_gain_scan(jnp.asarray(m.T), scal,
                                 jnp.zeros(m.shape[0]))).T


def _close_to_reference(got, want):
    diff = np.abs(got - want)
    assert diff.max() <= 1e-5, diff.max()
    assert np.median(diff) == 0.0


def test_constants_match_reference():
    from ame_tpu.ops import pydub_gain as ref
    assert (pg._K, pg._TB, pg._BR, pg._RMAX, pg._SMAX_LOG) == (
        ref._K, ref._TB, ref._BR, ref._RMAX, ref._SMAX_LOG)
    for n in (1, 5000, 1 << 17, (1 << 23) + 3):
        assert pg._pad_block(n) == ref._pad_block(n)
        assert pg._select_S(pg._pad_block(n)) == ref._select_S(
            ref._pad_block(n))
    ia, ir = pg._scal(ATTACK, RELEASE)
    assert (np.float32(ia), np.float32(ir)) == (np.float32(1 / ATTACK),
                                                np.float32(1 / RELEASE))


def test_gain_scan_matches_reference():
    """Bit for bit against the separately rounded numpy walk; against the
    reference's (FMA-contracted) scan within atol 1e-5, median 0."""
    m = _bursts(1 << 13)
    ia, ir = pg._scal(ATTACK, RELEASE)
    got = pg._gain_scan(torch.from_numpy(m.T.copy()), ia, ir).numpy().T
    np.testing.assert_array_equal(got, _walk(m, ia, ir))
    _close_to_reference(got, _ref_scan(m))
    assert got.max() > 1.0


def test_two_pass_plain_kernels_bit_equal_scan():
    """K3 + K4's plain versions (and the resets K3 takes) reproduce the
    sequential walk bit for bit, over a ragged last group."""
    m = _bursts(3 * 4096 + 517, seed=7)
    ia, ir = pg._scal(ATTACK, RELEASE)
    init = np.asarray([0.0, 1.5, 7.0], np.float32)
    got = pg._two_pass(torch.from_numpy(m), torch.from_numpy(init), ia, ir)
    np.testing.assert_array_equal(got.numpy(), _walk(m, ia, ir, init))
    # resets zero the state before flagged 32-sample groups
    ng = -(-m.shape[1] // pg._K)
    resets = np.zeros(ng, np.float32)
    resets[[40, 200]] = 1.0
    got = pg._two_pass(torch.from_numpy(m), torch.from_numpy(init), ia, ir,
                       torch.from_numpy(resets)).numpy()
    want = np.concatenate([
        _walk(m[:, :40 * 32], ia, ir, init),
        _walk(m[:, 40 * 32:200 * 32], ia, ir),
        _walk(m[:, 200 * 32:], ia, ir)], axis=1)
    np.testing.assert_array_equal(got, want)


def _walk_starts(m, resets, init, ia, ir):
    """The states before every 32-sample group of the numpy walk, zeroed
    at flagged groups: what pass 1 must return."""
    ng = -(-m.shape[1] // pg._K)
    att, out = init.copy(), np.empty((m.shape[0], ng), np.float32)
    for q in range(ng):
        if resets is not None and resets[q] != 0:
            att = np.zeros_like(att)
        out[:, q] = att
        att = _walk(m[:, q * pg._K:(q + 1) * pg._K], ia, ir, att)[:, -1]
    return out


def _p1_ring_walk(m, resets, init, ia, ir):
    """float32 numpy emulation of gain_p1's ring (csrc/pydub_gain.cu) at the
    wrapper's geometry (``_p1_ring``), in one order the producer and the
    walker may take: the producer stores the starts of the stage a slot
    held, then fills slot k % stages with stage k's m (zero past n) and
    reset flags; the walker walks each full group of the stage out of the
    slot, zeroing the state on a flag and writing the group's start into
    the slot; the ragged last group only records its start; the starts of
    the stages left in the ring are stored last."""
    stage, stages = pg._p1_ring()
    K, f32 = pg._K, np.float32
    gps = stage // K
    G, n = m.shape
    ng, nfull = -(-n // K), n // K
    nst = -(-ng // gps)
    ia, ir = f32(ia), f32(ir)
    ring = np.zeros((stages, G, stage), f32)
    flags = np.zeros((stages, gps), f32)
    ring_starts = np.zeros((stages, G, gps), f32)
    starts = np.full((G, ng), np.nan, f32)
    att = init.astype(f32).copy()

    def store(k):
        q = k * gps + np.arange(gps)
        starts[:, q[q < ng]] = ring_starts[k % stages][:, q < ng]

    for k in range(nst):
        s = k % stages
        if k >= stages:
            store(k - stages)
        t = k * stage + np.arange(stage)
        v = np.zeros((G, stage), f32)
        v[:, t < n] = m[:, t[t < n]]
        ring[s] = v
        q = k * gps + np.arange(gps)
        flags[s] = 0.0 if resets is None else np.where(
            q < ng, resets[np.minimum(q, ng - 1)], 0.0)
        for o in range(min(gps, ng - k * gps)):
            if flags[s, o] != 0:
                att = np.zeros_like(att)
            ring_starts[s][:, o] = att
            if k * gps + o < nfull:
                for i in range(o * K, (o + 1) * K):
                    mm = ring[s, :, i]
                    att = np.where(att <= mm, np.minimum(att + mm * ia, mm),
                                   np.maximum(att - mm * ir, f32(0.0)))
    for k in range(max(nst - stages, 0), nst):
        store(k)
    assert not np.isnan(starts).any()
    return starts


@pytest.mark.parametrize("flagged", [False, True], ids=["no_resets", "resets"])
@pytest.mark.parametrize("n", [5, 32, 1024, 1024 + 17, 3 * 1024 + 517,
                               17 * 1024 + 45],
                         ids=["part_group", "one_group", "one_stage",
                              "stage_ragged", "stages_ragged", "ring_wraps"])
def test_p1_ring_walk_bit_equal_plain(n, flagged):
    """K3's ring design, emulated, returns the plain pass 1's starts bit for
    bit (and the numpy walk's): shorter than a group, one group, exactly
    one stage, a stage and a ragged group, several stages, and more stages
    than the ring holds (its slots reused); with and without reset flags
    (group 0 zeroes the given init)."""
    m = _bursts(max(n, 8), seed=n)[:, :n].copy()
    ia, ir = pg._scal(ATTACK, RELEASE)
    init = np.asarray([0.0, 1.5, 7.0], np.float32)
    ng = -(-n // pg._K)
    resets = None
    if flagged:
        resets = np.zeros(ng, np.float32)
        resets[[q for q in (0, 1, 31, 32, 40, 200, 530) if q < ng]] = 1.0
    got = _p1_ring_walk(m, resets, init, ia, ir)
    want = pg.gain_p1_plain(torch.from_numpy(m),
                            None if resets is None else torch.from_numpy(
                                resets), torch.from_numpy(init), ia, ir)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got, _walk_starts(m, resets, init, ia, ir))


def test_p1_ring_geometry():
    """gain_p1's ring: one 32-sample group per producer lane in a stage,
    8-16 stages of 1-4 K samples, and the ring (m, a reset flag and a start
    per group, two mbarriers a stage: P1Ring in pydub_gain.cu) within the
    232448 bytes of shared memory one H100 block can have."""
    stage, stages = pg._p1_ring()
    assert stage // pg._K == 32 and stage % pg._K == 0
    assert 8 <= stages <= 16 and 1024 <= stage <= 4096
    assert stages * ((stage + 2 * stage // pg._K) * 4 + 2 * 8) <= 232448


def _p2_swz(r, j):
    """gain_p2's tile layout (p2_swz): the float offset of sample j of group
    r, its 16-byte chunk j // 4 stored at chunk (j // 4) ^ (r & 7)."""
    return r * pg._K + ((((j >> 2) ^ r) & 7) << 2) + (j & 3)


def _p2_tiles(m, starts, ia, ir, vec):
    """float32 numpy emulation of gain_p2 (csrc/pydub_gain.cu) at the
    wrapper's tile (``_p2_tile``): per chain and tile of TG groups, thread i
    copies 16-byte chunks c = i + TG*k (``vec``) or floats e = i + TG*k of
    m into the swizzled tile, zero past n; thread r walks group r from its
    start (0 past the last group) and writes att over m; the block stores
    the same chunks or floats back, masked at n. The tile starts as NaN, so
    a slot the copies miss shows."""
    TG, K, f32 = pg._p2_tile(), pg._K, np.float32
    G, n = m.shape
    tile = TG * K
    ng = -(-n // K)
    ia, ir = f32(ia), f32(ir)
    thr = np.arange(TG)[:, None]
    if vec:
        assert n % 4 == 0            # the launcher's rule for 16-byte copies
        c = (thr + TG * np.arange(tile // 4 // TG)).ravel()
        src = (4 * c[:, None] + np.arange(4)).ravel()
        dst = (_p2_swz(c >> 3, 4 * (c & 7))[:, None] + np.arange(4)).ravel()
        first = np.repeat(4 * c, 4)          # a chunk is copied whole or not
    else:
        e = (thr + TG * np.arange(tile // TG)).ravel()
        src, dst, first = e, _p2_swz(e >> 5, e & 31), e
    assert np.array_equal(np.sort(dst), np.arange(tile))
    rows = _p2_swz(np.arange(TG)[:, None], np.arange(K)[None, :])
    out = np.full((G, n), np.nan, f32)
    for g in range(G):
        for x in range(-(-ng // TG)):
            t0 = x * tile
            st = np.full(tile, np.nan, f32)
            ok = t0 + first < n
            st[dst] = np.where(ok, m[g, np.minimum(t0 + src, n - 1)], 0.0)
            q = x * TG + np.arange(TG)
            att = np.where(q < ng, starts[g, np.minimum(q, ng - 1)], 0.0)
            att = att.astype(f32)
            for j in range(K):
                mm = st[rows[:, j]]
                att = np.where(att <= mm, np.minimum(att + mm * ia, mm),
                               np.maximum(att - mm * ir, f32(0.0)))
                st[rows[:, j]] = att
            out[g, t0 + src[ok]] = st[dst[ok]]
    assert not np.isnan(out).any()
    return out


_TILE_N = 128 * 32        # one tile of gain_p2 (test_p2_tile_geometry)


@pytest.mark.parametrize("n,vec", [
    (5, False), (32, False), (32, True), (_TILE_N, False), (_TILE_N, True),
    (_TILE_N + 17, False), (3 * _TILE_N + 518, False),
    (3 * _TILE_N + 520, True), ((1 << 15) + 3, False)],
    ids=["part_group", "one_group", "one_group_vec", "one_tile",
         "one_tile_vec", "tile_ragged", "tiles_n_mod4_2", "tiles_ragged_vec",
         "many_tiles"])
def test_p2_tiles_bit_equal_plain(n, vec):
    """K4's tile design, emulated, on both copy routes: from random
    non-negative starts it returns gain_p2_plain bit for bit, and from the
    walk's own starts the numpy walk: shorter than a group, one group, one
    tile, a tile and a ragged group, several tiles (n % 4 == 2, the rows of
    chains 1 and 2 not 16-byte aligned: the 4-byte route) and more."""
    assert _TILE_N == pg._p2_tile() * pg._K
    rng = np.random.default_rng(n)
    m = np.maximum(0.0, 4.0 * rng.standard_normal((3, n))).astype(np.float32)
    m[:, n // 3:n // 3 + n // 10] = 0.0          # a below-threshold run
    ia, ir = pg._scal(ATTACK, RELEASE)
    ng = -(-n // pg._K)
    starts = (8.0 * rng.random((3, ng))).astype(np.float32)
    got = _p2_tiles(m, starts, ia, ir, vec)
    want = pg.gain_p2_plain(torch.from_numpy(m), torch.from_numpy(starts),
                            ia, ir)
    np.testing.assert_array_equal(got, want.numpy())
    init = np.asarray([0.0, 1.5, 7.0], np.float32)
    walk_starts = _walk_starts(m, None, init, ia, ir)
    np.testing.assert_array_equal(_p2_tiles(m, walk_starts, ia, ir, vec),
                                  _walk(m, ia, ir, init))


def test_p2_tile_geometry():
    """gain_p2's tile: a thread a group (TG threads, whole warps, a multiple
    of the swizzle's 8 chunks); the copies split evenly over the threads on
    both routes; the tile within the 48 KB of static shared memory a block
    gets without opting in, and small enough that 8 blocks (whose loads
    and walks overlap) stay resident in an H100 SM's 233472 bytes, 1 KB a
    block reserved; and the swizzle is a permutation of each group's own
    32 floats."""
    TG, K = pg._p2_tile(), pg._K
    assert TG % 32 == 0 and TG % 8 == 0 and TG <= 1024
    assert (TG * K) % TG == 0 and (TG * K // 4) % TG == 0
    assert TG * K * 4 <= 48 * 1024
    assert 233472 // (TG * K * 4 + 1024) >= 8
    r = np.arange(TG)[:, None]
    rows = _p2_swz(r, np.arange(K)[None, :])
    np.testing.assert_array_equal(np.sort(rows, axis=1), r * K + np.arange(K))
    # a quarter-warp's 128-bit accesses of one chunk index hit 8 chunks
    for q in range(K // 4):
        for r0 in range(0, TG, 8):
            banks = _p2_swz(np.arange(r0, r0 + 8), 4 * q) % 32 // 4
            assert len(set(banks.tolist())) == 8


def test_gain_p2_plain_matches_reference_kernel():
    """K4's plain version against ame_tpu's Pallas pass 2 (_p2, interpreted)
    on one chain of 2 x 512 groups from random starts, within the file's
    reference tolerance (XLA contracts the update into an FMA)."""
    from ame_tpu.ops import pydub_gain as ref
    ng = 2 * ref._BR
    n = ng * pg._K
    rng = np.random.default_rng(11)
    m = np.maximum(0.0, 4.0 * rng.standard_normal((1, n))).astype(np.float32)
    m[:, 5000:9000] = 0.0
    starts = (8.0 * rng.random((1, ng))).astype(np.float32)
    ia, ir = pg._scal(ATTACK, RELEASE)
    got = pg.gain_p2_plain(torch.from_numpy(m), torch.from_numpy(starts), ia,
                           ir).numpy()
    scal = jnp.asarray([[ia, ir]], jnp.float32)
    want = np.asarray(ref._p2(jnp.asarray(m.reshape(ng, pg._K)),
                              jnp.asarray(starts), scal, True)).reshape(1, n)
    _close_to_reference(got, want)
    assert got.max() > 1.0


def test_jacobi_plain_sweep_reproduces_true_carries():
    """K2's plain version: a sweep started from the walk's own states at
    the segment starts returns the next segment starts, and the full
    sweep returns the walk, bit for bit (the fixed point is exact)."""
    m = _bursts(8 * 512, G=2, seed=5)
    ia, ir = pg._scal(ATTACK, RELEASE)
    walk = _walk(m, ia, ir)
    G, S, seg = 2, 8, 512
    m_t = torch.from_numpy(m).reshape(G, S, seg).permute(2, 0, 1).reshape(
        seg, G * S).contiguous()
    starts = np.concatenate([np.zeros((G, 1), np.float32),
                             walk[:, seg - 1::seg][:, :-1]], axis=1)
    co, att_t = pg.gain_jacobi_plain(m_t, torch.from_numpy(starts).reshape(
        -1), ia, ir, True)
    np.testing.assert_array_equal(co.numpy().reshape(G, S),
                                  walk[:, seg - 1::seg])
    att = att_t.reshape(seg, G, S).permute(1, 2, 0).reshape(G, S * seg)
    np.testing.assert_array_equal(att.numpy(), walk)


def test_gain_engine_converges_and_matches_reference():
    """Program-like content: the Jacobi carries converge, the engine's
    result is the walk bit for bit, and it matches the reference's Pallas
    engine (interpreted) within atol 1e-5, median 0."""
    from ame_tpu.ops import pydub_gain as ref
    n = 1 << 15
    m = _bursts(n)
    ia, ir = pg._scal(ATTACK, RELEASE)
    npad = pg._pad_block(n)
    S = pg._select_S(npad)
    m_t = torch.nn.functional.pad(torch.from_numpy(m), (0, npad - n)).reshape(
        3, S, npad // S).permute(2, 0, 1).reshape(npad // S, 3 * S)
    _, ok, sweeps = pg._jacobi_carries(m_t.contiguous(), 3, S,
                                       torch.zeros(3), ia, ir)
    assert ok.all() and sweeps <= pg._RMAX
    got = pg._gain_engine(torch.from_numpy(m), torch.zeros(3), ia, ir)
    np.testing.assert_array_equal(got.numpy(), _walk(m, ia, ir))
    want = np.stack([np.asarray(v) for v in ref.pydub_gain_multi(
        [jnp.asarray(v) for v in m], ATTACK, RELEASE, interpret=True)])
    _close_to_reference(got.numpy(), want)


def test_gain_engine_falls_back_on_translation_content():
    """Translation-only content (m = 10, attack 1e9: never saturates)
    stalls the relaxation, which reports no convergence; the engine takes
    the two-pass path, equal to the walk and to the reference."""
    from ame_tpu.ops import pydub_gain as ref
    n = 1 << 17
    m = np.full((1, n), 10.0, np.float32)
    ia, ir = pg._scal(1e9, RELEASE)
    npad = pg._pad_block(n)
    S = pg._select_S(npad)
    m_t = torch.from_numpy(m).reshape(1, S, npad // S).permute(
        2, 0, 1).reshape(npad // S, S).contiguous()
    _, ok, sweeps = pg._jacobi_carries(m_t, 1, S, torch.zeros(1), ia, ir)
    assert not ok.any() and sweeps < pg._RMAX         # the stall rule bailed
    got = pg._gain_engine(torch.from_numpy(m), torch.zeros(1), ia, ir)
    np.testing.assert_array_equal(got.numpy(), _walk(m, ia, ir))
    want = np.asarray(ref.pydub_gain_multi([jnp.asarray(m[0])], 1e9, RELEASE,
                                           interpret=True)[0])
    np.testing.assert_array_equal(got.numpy()[0], want)


def test_gain_engine_all_silent_early_out(monkeypatch):
    """All-zero m from a zero state: zeros, and no kernel (plain or not)
    runs; the reference returns zeros too."""
    from ame_tpu.ops import pydub_gain as ref

    def boom(*a, **k):
        raise AssertionError("a kernel ran on all-silent input")

    monkeypatch.setattr(pg, "_gain_engine_hot", boom)
    m = np.zeros((3, 5000), np.float32)
    got = pg._gain_engine(torch.from_numpy(m), torch.zeros(3), 0.1, 0.01)
    assert not got.any()
    want = ref.pydub_gain_multi([jnp.asarray(v) for v in m], ATTACK, RELEASE,
                                interpret=True)
    assert not any(np.asarray(w).any() for w in want)


@pytest.mark.parametrize("ia,ir", [(None, None), (0.5, 0.25)],
                         ids=["compressor", "fast"])
def test_zero_padding_leaves_the_state_unchanged(ia, ir):
    """gain_jacobi zero-fills the rows past seg_len and the lanes past the
    last (its stages are whole): a step with m == 0 must leave every state
    the recurrence can hold unchanged, bit for bit, so the sweep's
    carry-outs equal a walk that stops at seg_len. Checked on the states
    of a real walk, zero and the extremes included."""
    if ia is None:
        ia, ir = pg._scal(ATTACK, RELEASE)
    m = torch.from_numpy(_bursts(20000, G=3).T.copy())
    states = torch.cat([pg._gain_scan(m, ia, ir).reshape(-1),
                        torch.tensor([0.0, 1e-30, 1.0, 120.0])])
    zero = torch.zeros_like(states)
    stepped = pg._update(states, zero, zero * ia, zero * ir)
    assert torch.equal(stepped, states)
    # and the plain sweep over zero-padded rows: the same carry-outs
    m_t = m[:4096].contiguous()
    carry = torch.linspace(0.0, 9.0, m_t.shape[1])
    padded = torch.cat([m_t, torch.zeros(60, m_t.shape[1])])
    co, _ = pg.gain_jacobi_plain(m_t, carry, ia, ir, False)
    co_pad, _ = pg.gain_jacobi_plain(padded, carry, ia, ir, False)
    assert torch.equal(co, co_pad)


def test_gain_jacobi_cuda_raises_on_cpu_tensor():
    """K2's wrapper never runs the plain version: a CPU tensor is an error,
    and no launch is counted."""
    before = pg.gain_jacobi_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        pg.gain_jacobi_cuda(torch.zeros(64, 8), torch.zeros(8), 0.1, 0.01,
                            True)
    assert pg.gain_jacobi_cuda.launches == before


def test_gain_p2_cuda_raises_on_cpu_tensor():
    """K4's wrapper never runs the plain version: a CPU tensor is an error,
    and no launch is counted."""
    before = pg.gain_p2_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        pg.gain_p2_cuda(torch.zeros(3, 100), torch.zeros(3, 4), 0.1, 0.01)
    assert pg.gain_p2_cuda.launches == before


def test_pydub_gain_cpu_runs_the_walk():
    m = _bursts(4096, G=2)
    ia, ir = pg._scal(ATTACK, RELEASE)
    got = pg.pydub_gain(torch.from_numpy(m.T.copy()), ATTACK, RELEASE)
    np.testing.assert_array_equal(got.numpy().T, _walk(m, ia, ir))
    one = pg.pydub_gain(torch.from_numpy(m[0].copy()), ATTACK, RELEASE)
    np.testing.assert_array_equal(one.numpy(), got.numpy()[:, 0])


def _program(n, seed=0):
    from tests.conftest import make_test_signal
    x = make_test_signal("noise", n, SR, seed=seed) * 0.05
    x[n // 3: 2 * n // 3] *= 12.0
    return np.clip(x, -1, 1)


def test_pydub_compress_exact_multi_matches_reference():
    """Three bands through one engine pass; int16 outputs, held as
    tests/test_compressor.py holds the reference to its oracle."""
    from ame_tpu.ops.compressor import pydub_compress_exact_multi as ref
    x = _program(1 << 14)
    bands = [np.trunc(x * s * 32767.0).astype(np.float32)
             for s in (1.0, 0.7, 0.4)]
    th, ra = [-20.0, -22.0, -25.0], [4.0, 3.0, 6.0]
    want = ref([jnp.asarray(b) for b in bands], float(SR), th, ra)
    got = compressor.pydub_compress_exact_multi(
        [torch.from_numpy(b) for b in bands], SR, th, ra)
    for g, w in zip(got, want):
        diff = np.abs(g.numpy() - np.asarray(w))
        assert np.median(diff) == 0.0
        assert diff.max() <= 64, diff.max()
        assert (diff > 2).mean() < 0.02
    single = compressor.pydub_compress_exact(torch.from_numpy(bands[0]), SR,
                                             th[0], ra[0])
    np.testing.assert_array_equal(single.numpy(), got[0].numpy())


def test_multiband_compat_matches_reference_and_oracle():
    """The compat 3-band stage (Q4 subtractive mid, Q5, Q7) vs ame_tpu's
    and vs the float64 reference oracle, in the int16 domain, with the
    bounds of tests/test_compressor.py plus median 0."""
    from ame_tpu.graph.multiband import multiband_compat as ref
    x = _program(1 << 15)
    xq = oracles.int16_roundtrip(x).astype(np.float32)
    th, ra = [-25.0, -20.0, -15.0], [6.0, 3.0, 4.0]
    got = multiband.multiband_compat(torch.from_numpy(xq), SR, th, ra).numpy()
    want = np.asarray(ref(jnp.asarray(xq), SR, jnp.asarray(th),
                          jnp.asarray(ra), exact=True))
    settings = {"low_thresh": -25.0, "low_ratio": 6.0,
                "mid_thresh": -20.0, "mid_ratio": 3.0,
                "high_thresh": -15.0, "high_ratio": 4.0}
    oracle = oracles.multiband_compress(xq.astype(np.float64), SR, settings)
    for other in (want * 32768.0, oracle):
        diff = np.abs(got * 32768.0 - other)
        assert np.median(diff) == 0.0
        assert diff.max() <= 96, diff.max()
        assert (diff > 4).mean() < 0.05
