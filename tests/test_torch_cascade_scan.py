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
    unit circle, so the per-sample recurrence and A^tb stay bounded at any
    length. (The companion form of the dynamic K-weighting's real pair
    rounds one pole to 1.00005 in f32: the reason for the triangular
    form.)"""
    sos = ALL_CASCADES[name]()
    k = sos.shape[0]
    sec = cascade_scan._kernel_params(np.ascontiguousarray(sos).tobytes(),
                                      k, 256)[:7 * k].reshape(k, 7)
    for b0, bb1, bb2, a11, a12, a21, a22 in sec.astype(np.float64):
        block = np.array([[a11, a12], [a21, a22]])
        assert np.abs(np.linalg.eigvals(block)).max() < 1.0
    want = np.abs(np.concatenate([np.roots(s[3:]) for s in sos]))
    got = np.abs(np.linalg.eigvals(scan_iir._compose_sections(
        sec.astype(np.float64))[0]))
    np.testing.assert_allclose(np.sort(got), np.sort(want), atol=1e-6)


@pytest.mark.parametrize("name", sorted(ALL_CASCADES))
def test_kernel_parameter_block_three_phase(name):
    """The host side of the CUDA kernel: a float64 numpy walk of the
    kernel's three phases (block end states, carry c_{b+1} = A^tb c_b + e_b,
    block re-run), reading the exact float32 parameter block the kernel
    receives, matches scipy within 1e-5 — so the block's layout, the
    section forms, A^tb and the zi/zf transforms are right before the card
    runs them."""
    sos = ALL_CASCADES[name]()
    k, D, tb = sos.shape[0], 2 * sos.shape[0], 256
    P = cascade_scan._kernel_params(np.ascontiguousarray(sos).tobytes(), k,
                                    tb).astype(np.float64)
    sec = P[:7 * k].reshape(k, 7)
    AT = P[7 * k:7 * k + D * D].reshape(D, D)
    Vi = P[7 * k + D * D:7 * k + D * D + 4 * k].reshape(k, 2, 2)
    Vf = P[7 * k + D * D + 4 * k:].reshape(k, 2, 2)
    x = _noise(N_RAGGED, seed=4).astype(np.float64)
    zi = _natural_zi(sos)

    def run_block(s, xb):
        ys = np.empty_like(xb)
        for t in range(xb.shape[0]):
            u = xb[t]
            for i, (b0, bb1, bb2, a11, a12, a21, a22) in enumerate(sec):
                s1, s2 = s[2 * i].copy(), s[2 * i + 1].copy()
                ys_i = b0 * u + s1
                s[2 * i] = a11 * s1 + a12 * s2 + bb1 * u
                s[2 * i + 1] = a21 * s1 + a22 * s2 + bb2 * u
                u = ys_i
            ys[t] = u
        return ys

    blocks = [x[b:b + tb] for b in range(0, x.shape[0], tb)]
    ends = []
    for xb in blocks[:-1]:                       # phase 1
        s = np.zeros((D, 2))
        run_block(s, xb)
        ends.append(s)
    c = np.einsum("kab,kcb->kac", Vi, zi).reshape(D, 2)
    carries = [c]
    for e in ends:                               # phase 2
        c = AT @ c + e
        carries.append(c)
    ys = []
    for c, xb in zip(carries, blocks):           # phase 3
        s = c.copy()
        ys.append(run_block(s, xb))
    zf = np.einsum("kab,kbc->kca", Vf, s.reshape(k, 2, 2))
    want, want_zf = _scipy(sos, x, zi)
    assert np.abs(np.concatenate(ys) - want).max() <= 1e-5
    assert np.abs(zf - want_zf).max() <= 1e-5


def test_sosfilt_cuda_raises_on_cpu_tensor():
    """The kernel wrapper never runs the plain version: a CPU tensor is an
    error, and no launch is counted."""
    before = cascade_scan.sosfilt_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cascade_scan.sosfilt_cuda(CASCADES["eq_k4"](), torch.zeros(64, 2))
    assert cascade_scan.sosfilt_cuda.launches == before
