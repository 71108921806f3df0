"""The port's cascade filter (ame_tpu_torch.ops: scan_iir.sosfilt, the plain
tile-conv version, and the host side of the CUDA kernel) against float64
scipy and against the JAX reference's engines, K5 included (Pallas interpret
mode, as tests/test_pallas_scan.py runs it)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from scipy.signal import sosfilt as scipy_sosfilt

from ame_tpu_torch.dsp import design
from ame_tpu_torch.ops import cascade_scan, scan_iir, tile_conv
from ame_tpu_torch.ops.eq import eq_quality_sos
from ame_tpu_torch.ops.saturate import analog_sos
from tests.conftest import make_test_signal

SR = 44100.0
N_RAGGED = 3 * 1024 + 345   # not a multiple of any block length used here

# The slice's three cascades (flagship gains, plus a mid cut and treble so
# all four EQ sections are active).
CASCADES = {
    "analog_shelves_k2": lambda: analog_sos(SR, 20.0),
    "eq_k4": lambda: eq_quality_sos(SR, 2.0, 1.0, 1.5, 2.0),
    "k_weighting_k2": lambda: design.k_weighting_sos(SR),
}


# The compat chain's cascades that the quality chain does not run: k=1
# Butterworth shelf cores, the order-4 crossovers, the reference peak band
# (at 8 kHz its edge clamps next to Nyquist, quirk Q14), and the dynamic-mode
# K-weighting, whose real pole pair sits within 1e-5 of z = 1.
COMPAT_CASCADES = {
    "shelf_core_k1": lambda: design.ba_to_sos_biquad(
        *design.butter_ba(2, 120.0 / (0.5 * SR), "low")),
    "crossover_low_k2": lambda: design.butter_sos(4, 250.0, "lowpass",
                                                  fs=SR),
    "crossover_high_k2": lambda: design.butter_sos(4, 4000.0, "highpass",
                                                   fs=SR),
    "peak_band_q14_k4": lambda: design.reference_peak_band_sos(8000.0,
                                                               4000.0),
    "k_dynamic_44k_k3": lambda: design.k_weighting_dynamic_sos(44100.0),
    "k_dynamic_48k_k3": lambda: design.k_weighting_dynamic_sos(48000.0),
}
ALL_CASCADES = {**CASCADES, **COMPAT_CASCADES}


def _noise(n, seed=0):
    return make_test_signal("noise", n, int(SR), seed=seed)


def _natural_zi(sos, seed=9):
    """A reachable, non-zero start state [k, C, 2]: scipy's end state after
    filtering a noise pre-roll."""
    k = sos.shape[0]
    pre = _noise(2048, seed).astype(np.float64)
    _, zf = scipy_sosfilt(sos, pre, axis=0, zi=np.zeros((k, 2, 2)))
    return np.ascontiguousarray(np.moveaxis(zf, 1, 2)).astype(np.float32)


def _scipy(sos, x, zi):
    """float64 scipy with zi/zf in the port's [k, C, 2] layout."""
    y, zf = scipy_sosfilt(sos, x.astype(np.float64), axis=0,
                          zi=np.moveaxis(zi.astype(np.float64), 1, 2))
    return y, np.moveaxis(zf, 1, 2)


@pytest.mark.parametrize("name", sorted(CASCADES))
def test_state_space_matches_reference(name):
    """The port's float64 builder equals ame_tpu's _state_space_np."""
    from ame_tpu.ops.scan_iir import _state_space_np as ref_state_space
    sos = CASCADES[name]()
    for got, want in zip(scan_iir._state_space_np(sos), ref_state_space(sos)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("name", sorted(CASCADES))
def test_plain_sosfilt_matches_scipy(name):
    """CPU sosfilt (plain tile-conv) vs float64 scipy: relative L2 error
    < 1e-5 (the bound tests/test_pallas_scan.py holds K5 to), zf within
    1e-5 absolute."""
    sos = CASCADES[name]()
    x = _noise(N_RAGGED)
    zi = _natural_zi(sos)
    y, zf = scan_iir.sosfilt(sos, torch.from_numpy(x), torch.from_numpy(zi))
    want, want_zf = _scipy(sos, x, zi)
    rel = np.linalg.norm(y.numpy() - want) / np.linalg.norm(want)
    assert rel < 1e-5, rel
    assert np.abs(zf.numpy() - want_zf).max() < 1e-5


@pytest.fixture
def pallas_k5(monkeypatch):
    """ame_tpu's K5 module in Pallas interpret mode with 1024-sample
    blocks (fast on the CPU)."""
    from jax.experimental.pallas import tpu as pltpu
    import ame_tpu.ops.pallas_scan as PS
    monkeypatch.setattr(PS, "_TB", 1024)
    with pltpu.force_tpu_interpret_mode():
        yield PS


@pytest.mark.parametrize("name", ["k_weighting_k2", "eq_k4"])
def test_plain_sosfilt_matches_pallas_k5(name, pallas_k5):
    """Port vs the reference's K5 (sosfilt_pallas) on a host k=2 and a k=4
    RBJ cascade, ragged length, non-zero zi: y and zf within 1e-4 abs
    (K5's own tolerance against the XLA scan)."""
    sos = CASCADES[name]()
    x = _noise(N_RAGGED, seed=1)
    zi = _natural_zi(sos)
    y_ref, zf_ref = pallas_k5.sosfilt_pallas(sos, jnp.asarray(x),
                                             jnp.asarray(zi))
    y, zf = scan_iir.sosfilt(sos, torch.from_numpy(x), torch.from_numpy(zi))
    assert np.abs(y.numpy() - np.asarray(y_ref)).max() <= 1e-4
    assert np.abs(zf.numpy() - np.asarray(zf_ref)).max() <= 1e-4


@pytest.mark.parametrize("name", sorted(CASCADES))
def test_plain_tileconv_matches_reference_tileconv(name):
    """Port vs ame_tpu.ops.tile_conv.sosfilt_tileconv, the same tables on
    both sides: within 1e-5 abs."""
    from ame_tpu.ops.tile_conv import sosfilt_tileconv as ref_tileconv
    sos = CASCADES[name]()
    x = _noise(N_RAGGED, seed=2)
    zi = _natural_zi(sos)
    y_ref, zf_ref = ref_tileconv(sos, jnp.asarray(x), jnp.asarray(zi))
    y, zf = tile_conv.sosfilt_tileconv(sos, torch.from_numpy(x),
                                       torch.from_numpy(zi))
    assert np.abs(y.numpy() - np.asarray(y_ref)).max() <= 1e-5
    assert np.abs(zf.numpy() - np.asarray(zf_ref)).max() <= 1e-5


def _port_filter(sos, x, zi):
    y, zf = scan_iir.sosfilt(sos, torch.from_numpy(x),
                             None if zi is None else torch.from_numpy(zi))
    return y.numpy(), zf.numpy()


def _ref_filter(sos, x, zi):
    from ame_tpu.ops.tile_conv import sosfilt_tileconv as ref_tileconv
    y, zf = ref_tileconv(sos, jnp.asarray(x),
                         None if zi is None else jnp.asarray(zi))
    return np.asarray(y), np.asarray(zf)


@pytest.mark.parametrize("first,second", [
    (_port_filter, _port_filter),
    (_ref_filter, _port_filter),
    (_port_filter, _ref_filter),
], ids=["port-port", "ame_tpu-port", "port-ame_tpu"])
def test_zi_handoff_across_split(first, second):
    """Splitting a stream with a zf -> zi handoff equals the continuous run
    (within 1e-5), also when the state crosses between the two packages
    (both keep scipy's [k, C, 2] layout)."""
    sos = CASCADES["eq_k4"]()
    x = _noise(4000, seed=3)
    y_full, zf_full = _port_filter(sos, x, None)
    cut = 2600
    y1, zf1 = first(sos, x[:cut], None)
    y2, zf2 = second(sos, x[cut:], np.array(zf1))
    glued = np.concatenate([y1, y2], axis=0)
    assert np.abs(glued - y_full).max() <= 1e-5
    assert np.abs(zf2 - zf_full).max() <= 1e-5


@pytest.mark.parametrize("name", sorted(ALL_CASCADES))
def test_kernel_sections_keep_poles_inside_unit_circle(name):
    """Every pole of the f32 section rows the kernel walks lies inside the
    unit circle, so the per-sample recurrence and its powers stay bounded at any
    length. (The companion form of the dynamic K-weighting's real pair
    rounds one pole to 1.00005 in f32: the reason for the triangular
    form.)"""
    sos = ALL_CASCADES[name]()
    k = sos.shape[0]
    sec = cascade_scan._kernel_params(np.ascontiguousarray(sos).tobytes(),
                                      k)[:7 * k].reshape(k, 7)
    for b0, bb1, bb2, a11, a12, a21, a22 in sec.astype(np.float64):
        block = np.array([[a11, a12], [a21, a22]])
        assert np.abs(np.linalg.eigvals(block)).max() < 1.0
    want = np.abs(np.concatenate([np.roots(s[3:]) for s in sos]))
    got = np.abs(np.linalg.eigvals(scan_iir._compose_sections(
        sec.astype(np.float64))[0]))
    np.testing.assert_allclose(np.sort(got), np.sort(want), atol=1e-6)


def _emulate_kernel(sos, x, zi, logP, R, lanes):
    """float32 numpy emulation of cascade_scan.cu's decomposition, reading
    the exact float32 parameter block and power table the kernel receives:
    sub-blocks of _SUB samples walked from zero state, a Hillis-Steele scan
    over the 2^logP sub-blocks of a tile with A^(SUB*2^l), the carry across
    tiles in chunks of `lanes` x R tiles (each lane folds its R tiles with
    A^T, a scan over the lanes with A^(T*R*2^m) seeded with the chunk's
    carry-in, the lanes' tiles walked again), and every sub-block re-run
    from S_{j-1} + A^(SUB*j) c_b (the bits of j). Returns (y, zf)."""
    f32 = np.float32
    k, D, L = sos.shape[0], 2 * sos.shape[0], cascade_scan._SUB
    P = 1 << logP
    T = P * L
    key = np.ascontiguousarray(sos).tobytes()
    prm = cascade_scan._kernel_params(key, k)
    sec = prm[:7 * k].reshape(k, 7)
    Vi = prm[7 * k:11 * k].reshape(k, 2, 2)
    Vf = prm[11 * k:].reshape(k, 2, 2)
    pw = cascade_scan._power_table(key, k, logP)
    PL, PT = pw[:logP], pw[logP:]
    N, C = x.shape
    nb = -(-N // T)
    xs = np.zeros((nb * T, C), f32)
    xs[:N] = x
    xs = xs.reshape(nb, P, L, C)

    def walk(s, steps):                 # s [nb, P, C, D], in place
        ys = np.empty((nb, P, steps, C), f32)
        for i in range(steps):
            u = xs[:, :, i, :]
            for q, (b0, bb1, bb2, a11, a12, a21, a22) in enumerate(sec):
                s1, s2 = s[..., 2 * q].copy(), s[..., 2 * q + 1].copy()
                yq = b0 * u + s1
                s[..., 2 * q] = a11 * s1 + a12 * s2 + bb1 * u
                s[..., 2 * q + 1] = a21 * s1 + a22 * s2 + bb2 * u
                u = yq
            ys[:, :, i, :] = u
        return ys

    def apply(M, v):                    # M [D, D] on v [..., D]
        return np.einsum("ed,...d->...e", M, v).astype(f32)

    S = np.zeros((nb, P, C, D), f32)    # 1. ends, then the in-tile scan
    walk(S, L)
    for l in range(logP):
        off = 1 << l
        S[:, off:] = S[:, off:] + apply(PL[l], S[:, :-off])
    # 2. carries across tiles, c_{b+1} = A^T c_b + E_b, as cascade_carries
    # walks them: `lanes` lanes of R tiles a chunk
    z = np.zeros((k, C, 2), f32) if zi is None else zi
    cb = np.einsum("kab,kcb->cka", Vi, z).reshape(C, D).astype(f32)
    AT, logR = PT[0], R.bit_length() - 1
    cst = np.empty((nb, C, D), f32)
    for base in range(0, nb, lanes * R):
        Eb = np.zeros((lanes * R, C, D), f32)
        Eb[:min(lanes * R, nb - base)] = S[base:base + lanes * R, P - 1]
        Eb = Eb.reshape(lanes, R, C, D)
        a = np.zeros((lanes, C, D), f32)
        for i in range(R):
            a = apply(AT, a) + Eb[:, i]
        a[0] = a[0] + apply(PT[logR], cb)
        for m in range(lanes.bit_length() - 1):
            off = 1 << m
            a[off:] = a[off:] + apply(PT[logR + m], a[:-off])
        o = np.concatenate([cb[None], a[:-1]])
        for i in range(R):
            b = base + np.arange(lanes) * R + i
            cst[b[b < nb]] = o[b < nb]
            o = apply(AT, o) + Eb[:, i]
        cb = a[-1]
    start = np.repeat(cst[:, None], P, axis=1)   # 3. start states, outputs
    for l in range(logP):
        take = ((np.arange(P) >> l) & 1).astype(bool)
        start[:, take] = apply(PL[l], start[:, take])
    start[:, 1:] = start[:, 1:] + S[:, :-1]
    s = start.copy()
    y = walk(s, L).reshape(nb * T, C)[:N]
    # the sub-block that holds sample N-1 stops its walk there
    b, j = divmod((N - 1) // L, P)
    s_last = start[b, j].copy()
    for t in range(b * T + j * L, N):
        u = x[t]
        for q, (b0, bb1, bb2, a11, a12, a21, a22) in enumerate(sec):
            s1, s2 = s_last[:, 2 * q].copy(), s_last[:, 2 * q + 1].copy()
            yq = b0 * u + s1
            s_last[:, 2 * q] = a11 * s1 + a12 * s2 + bb1 * u
            s_last[:, 2 * q + 1] = a21 * s1 + a22 * s2 + bb2 * u
            u = yq
    zf = np.einsum("kab,ckb->kca", Vf, s_last.reshape(C, k, 2))
    return y, zf


@pytest.mark.parametrize("with_zi", [True, False], ids=["zi", "zero_zi"])
@pytest.mark.parametrize("logP,R,lanes", [(2, 2, 4), (7, 32, 32)],
                         ids=["small_tiles", "stereo_tiles"])
@pytest.mark.parametrize("name", sorted(ALL_CASCADES))
def test_kernel_parameter_block_three_phase(name, logP, R, lanes, with_zi):
    """The CUDA kernel's decomposition, emulated in float32 numpy on the
    exact parameter block and power table it receives, matches float64
    scipy and the port's plain tile-conv within 2e-5 (y and zf) at a
    ragged length, with and without zi: 4-sub-block tiles, carried by 4
    lanes of 2 tiles (14 tiles in two chunks, so the in-tile scan, the
    lane scan and the chunk carry-in all run), and the geometry the card
    uses for stereo (``_geometry(2)``: 128 sub-blocks a tile; 32 lanes of
    32 tiles, k <= 4)."""
    sos = ALL_CASCADES[name]()
    x = _noise(N_RAGGED, seed=4)
    zi = _natural_zi(sos) if with_zi else None
    y, zf = _emulate_kernel(sos, x, zi, logP, R, lanes)
    want, want_zf = _scipy(sos, x, np.zeros((sos.shape[0], 2, 2))
                           if zi is None else zi)
    assert np.abs(y - want).max() <= 2e-5
    assert np.abs(zf - want_zf).max() <= 2e-5
    y_p, zf_p = tile_conv.sosfilt_tileconv(
        sos, torch.from_numpy(x), None if zi is None else torch.from_numpy(zi))
    assert np.abs(y - y_p.numpy()).max() <= 2e-5
    assert np.abs(zf - zf_p.numpy()).max() <= 2e-5


def test_kernel_geometry():
    """Tiles fit the kernel's limits: CB <= 4 channels, P = 2^logP >= SUB
    sub-blocks each, at most 256 threads; stereo takes 128 sub-blocks."""
    assert cascade_scan._geometry(2) == (2, 7)
    for C in range(1, 12):
        CB, logP = cascade_scan._geometry(C)
        assert 1 <= CB <= min(C, 4)
        assert cascade_scan._SUB <= (1 << logP)
        assert (1 << logP) * CB <= cascade_scan._MAX_THREADS


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("name", sorted(ALL_CASCADES))
def test_kernel_powers_spectral_radius(name, C):
    """Every f32 power in the kernel's table (A^(SUB*2^l), A^(T*2^l)) has
    spectral radius <= 1, so no scan level can grow a mode, and equals the
    float64 power of the f32 section rows within 1e-6 relative to its
    norm."""
    sos = ALL_CASCADES[name]()
    k = sos.shape[0]
    key = np.ascontiguousarray(sos).tobytes()
    logP = cascade_scan._geometry(C)[1]
    table = cascade_scan._power_table(key, k, logP).astype(np.float64)
    sec = cascade_scan._kernel_params(key, k)[:7 * k].reshape(k, 7)
    A = scan_iir._compose_sections(sec.astype(np.float64))[0]
    M = np.linalg.matrix_power(A, cascade_scan._SUB)
    for P in table:
        assert np.abs(np.linalg.eigvals(P)).max() <= 1.0
        assert np.abs(P - M).max() <= 1e-6 * max(np.abs(M).max(), 1e-30)
        M = M @ M


def test_sosfilt_cuda_raises_on_cpu_tensor():
    """The kernel wrapper never runs the plain version: a CPU tensor is an
    error, and no launch is counted."""
    before = cascade_scan.sosfilt_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cascade_scan.sosfilt_cuda(CASCADES["eq_k4"](), torch.zeros(64, 2))
    assert cascade_scan.sosfilt_cuda.launches == before
