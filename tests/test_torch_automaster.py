"""Fitting in the port against ame_tpu on the CPU: the tile-conv tables of a
coefficient tensor, the cascade's hand-written backward (``SosfiltFn`` with
its plain versions inside) against autograd through the float64 tables,
the tensor-gain designs, the reverse cascade and the ``sos_grad`` reduction
against numpy, and ``models/automaster`` (dL/dtheta and ``fit_settings``)
against the JAX package's.

Tolerances, and why:

  * the tables: 1e-4 of each table's largest entry. Both packages build
    them in float32 by the same 7 doublings of A, rounding in their own
    summation orders; for the k=4 EQ, whose shelf poles sit near 0.96-0.99,
    the packages differ by up to 2.5e-5 of R's largest entry.
  * the backward against autograd through the float64 tables: 1e-5 of the
    largest entry for dL/dx and dL/dsos (the float32 forward and the
    float32 all-pole passes; the sums are float64). Through the designs
    to the gains the coefficient gradients nearly cancel: the 250 Hz and
    120 Hz shelves' all-pole passes have ~60 dB of gain at DC, so dL/db
    and dL/da are large and of opposite sign, and dL/dgain is their small
    difference. The float64 gradient is the arbiter; 1e-3 relative there
    (4e-5 measured for the analog shelves at 30 %).
  * dL/dtheta against jax.grad: 1e-3 of each leaf's largest entry. Both
    run the chain in float32 with their sums in different orders, and both
    round the true-peak operands to bf16, whose backward rounds the
    cotangent to bf16 too (``ops/loudness.py::_bf16_round`` in both
    packages), so the true-peak term agrees to bf16's 3 digits at best.
  * fit_settings after 5 Adam steps: 1e-3 absolute on each setting (dB,
    percent and ratio units; the steps' lr is 0.05).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from scipy.signal import sosfilt as scipy_sosfilt

from ame_tpu.models import automaster as JA
from ame_tpu.ops import eq as JE
from ame_tpu.ops.tile_conv import _traced_tables as jax_traced_tables
from ame_tpu_torch import convert
from ame_tpu_torch.models import automaster as TA
from ame_tpu_torch.ops import cascade_scan, eq, saturate, sos_grad, tile_conv
from ame_tpu_torch.ops.scan_iir import SosfiltFn, sosfilt

SR = 44100.0
N_FIT = 44100
RES = (512, 2048)

# k = 1, 2, 4 cascades with real and complex poles
CASCADES = {
    "k1_real": np.array([[0.5, 0.2, 0.1, 1.0, -0.9, 0.0]]),
    "k1_complex": np.array([[0.3, -0.1, 0.2, 1.0, -1.6, 0.81]]),
    "k2_mixed": np.array([[1.0, 0.3, 0.2, 1.0, -1.5, 0.6],
                          [0.7, 0.1, -0.2, 1.0, -0.4, -0.3]]),
    "k4_eq": eq.eq_quality_sos(SR, 4.0, 2.0, -2.0, 1.0),
}


def _theta_np(multiband=True):
    th = {"analog_raw": np.float32(-1.0), "width_raw": np.float32(0.2),
          "eq_raw": np.array([0.3, -0.2, 0.1, 0.25], np.float32)}
    if multiband:
        th["mb_thresh_raw"] = np.array([0.1, -0.1, 0.0], np.float32)
        th["mb_ratio_raw"] = np.array([-2.0, -1.5, -1.0], np.float32)
    return th


def _tracks():
    rng = np.random.default_rng(0)
    x = (0.1 * rng.standard_normal((N_FIT, 2))).astype(np.float32)
    t = (0.1 * rng.standard_normal((N_FIT, 2))).astype(np.float32)
    return x, t


# --- the traced tables ----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASCADES))
def test_traced_tables_match_jax(name):
    sos = CASCADES[name].astype(np.float32)
    Lb, ki, levels = 128, 77, 6
    want = jax_traced_tables(jnp.asarray(sos), Lb, ki, levels, jnp.float32)
    got = tile_conv._traced_tables(torch.from_numpy(sos), Lb, ki, levels)
    for label, g, w in zip(("H", "W", "R", "carry", "Pc", "Px", "Vf", "Vi"),
                           got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, label
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=label)


@pytest.mark.parametrize("name", sorted(CASCADES))
def test_tensor_sos_tileconv_matches_scipy(name):
    """The tensor route of sosfilt_tileconv (float64 tables) is the float64
    filter; with a zi too."""
    sos = CASCADES[name]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3000, 2))
    zi = 0.1 * rng.standard_normal((sos.shape[0], 2, 2))
    y, zf = tile_conv.sosfilt_tileconv(torch.tensor(sos), torch.tensor(x),
                                       torch.tensor(zi))
    # the port's zi [k, C, 2] is scipy's layout for time on the last axis
    y_ref, zf_ref = scipy_sosfilt(sos, x.T, axis=-1, zi=zi)
    np.testing.assert_allclose(y.numpy(), y_ref.T, rtol=0, atol=1e-10)
    np.testing.assert_allclose(zf.numpy(), zf_ref, rtol=0, atol=1e-10)


# --- the hand-written backward --------------------------------------------------

def _hand_and_f64(sos, need_x=True, n=3000):
    """(hand dL/dx, hand dL/dsos, f64 dL/dx, f64 dL/dsos) for L = <y, gy>."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    gy = rng.standard_normal((n, 2)).astype(np.float32)
    sos32 = np.asarray(sos, np.float32)
    xt = torch.tensor(x, requires_grad=need_x)
    st = torch.tensor(sos32, requires_grad=True)
    y, _ = SosfiltFn.apply(xt, st, sos32.astype(np.float64), None)
    (y * torch.from_numpy(gy)).sum().backward()
    x64 = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    s64 = torch.tensor(sos32, dtype=torch.float64, requires_grad=True)
    y64, _ = tile_conv.sosfilt_tileconv(s64, x64)
    (y64 * torch.from_numpy(gy).double()).sum().backward()
    return xt.grad, st.grad, x64.grad, s64.grad


def _close(got, want, rel, label=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=label)


@pytest.mark.parametrize("name", sorted(CASCADES))
def test_sosfilt_fn_backward_matches_autograd(name):
    gx, gs, gx64, gs64 = _hand_and_f64(CASCADES[name])
    _close(gx, gx64, 1e-5, "dL/dx")
    _close(gs, gs64, 1e-5, "dL/dsos")
    assert (gs[:, 3] == 0).all()          # a0 is not a parameter


@pytest.mark.parametrize("name", ["k1_complex", "k4_eq"])
def test_sosfilt_fn_sos_only(name):
    """x needs no gradient: the backward skips the last reverse pass and
    the coefficient gradient is unchanged."""
    gx, gs, _, gs64 = _hand_and_f64(CASCADES[name], need_x=False)
    assert gx is None
    _close(gs, gs64, 1e-5)


def test_sosfilt_fn_x_only_is_one_reverse_pass():
    """Host coefficients: dL/dx is the whole cascade run backward in time
    (the adjoint), against autograd through the plain forward."""
    sos = CASCADES["k4_eq"]
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((2000, 3)).astype(np.float32),
                     requires_grad=True)
    gy = torch.from_numpy(rng.standard_normal((2000, 3)).astype(np.float32))
    y, _ = SosfiltFn.apply(x, None, sos, None)
    (y * gy).sum().backward()
    x2 = x.detach().clone().requires_grad_(True)
    (tile_conv.sosfilt_tileconv(sos, x2)[0] * gy).sum().backward()
    _close(x.grad, x2.grad, 1e-5)


@pytest.mark.parametrize("design", ["eq", "analog"])
def test_gain_gradient_through_designs(design):
    """dL/dgain through the tensor designs and the hand backward, against
    the float64 coefficient gradient taken through the same float32
    design Jacobian (the cancellation the module docstring describes)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((0.1 * rng.standard_normal((N_FIT, 2))).astype(
        np.float32))
    gy = torch.from_numpy(rng.standard_normal((N_FIT, 2)).astype(np.float32))
    if design == "eq":
        g = torch.tensor([4.0, 2.0, -2.0, 1.0], requires_grad=True)
        make = lambda: eq.eq_quality_sos_t(SR, *g)
    else:
        g = torch.tensor([30.0], requires_grad=True)
        make = lambda: saturate.analog_sos_t(SR, g[0])
    s = make()
    y, _ = SosfiltFn.apply(x, s, s.detach().double().numpy(), None)
    (y * gy).sum().backward()
    s64 = s.detach().double().requires_grad_(True)
    (tile_conv.sosfilt_tileconv(s64, x.double())[0] * gy.double()
     ).sum().backward()
    ref = torch.autograd.grad(make(), g, s64.grad.float())[0]
    np.testing.assert_allclose(g.grad.numpy(), ref.numpy(), rtol=1e-3)


def test_sosfilt_routes_tensor_sos():
    """On the CPU a tensor sos takes the differentiable tables (also in
    pieces of at most 8 sections); a differentiated sos refuses zi."""
    sos = np.concatenate([CASCADES["k4_eq"]] * 3)          # 12 sections
    st = torch.tensor(sos, dtype=torch.float32, requires_grad=True)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1500, 2)).astype(np.float32))
    y, zf = sosfilt(st, x)
    assert zf.shape == (12, 2, 2)
    y_host, _ = sosfilt(sos.astype(np.float32), x)
    _close(y.detach(), y_host, 1e-5)
    y.sum().backward()
    assert st.grad.shape == (12, 6) and torch.isfinite(st.grad).all()
    with pytest.raises(ValueError, match="zi is not differentiated"):
        sosfilt(st, x, zi=torch.zeros(12, 2, 2))


def test_kernels_refuse_cpu_tensors():
    x = torch.zeros(64, 2)
    before = (cascade_scan.sosfilt_cuda.launches,
              cascade_scan.sosfilt_cuda.reverse_launches,
              sos_grad.sos_grad_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cascade_scan.sosfilt_cuda(CASCADES["k4_eq"], x, reverse=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sos_grad.sos_grad_cuda(x, x, x)
    assert (cascade_scan.sosfilt_cuda.launches,
            cascade_scan.sosfilt_cuda.reverse_launches,
            sos_grad.sos_grad_cuda.launches) == before


# --- the plain versions against numpy ---------------------------------------------

@pytest.mark.parametrize("C", [1, 2])
def test_reverse_plain_matches_scipy(C):
    """The reverse cascade is the forward filter of the flipped signal,
    flipped back (scipy in float64)."""
    from ame_tpu_torch.ops.scan_iir import _filter
    sos = CASCADES["k2_mixed"]
    x = np.random.default_rng(6).standard_normal((2500, C))
    y, _ = _filter(sos, torch.from_numpy(x.astype(np.float32)), reverse=True)
    want = scipy_sosfilt(sos, x[::-1], axis=0)[::-1]
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=2e-5)


def test_sos_grad_plain_matches_numpy():
    rng = np.random.default_rng(7)
    g, v, w = (rng.standard_normal((999, 3)).astype(np.float32)
               for _ in range(3))
    got = sos_grad.sos_grad_plain(*(torch.from_numpy(a) for a in (g, v, w)))
    assert got.dtype == torch.float64
    gd, vd, wd = (a.astype(np.float64) for a in (g, v, w))
    want = [np.sum(gd * vd), np.sum(gd[1:] * vd[:-1]),
            np.sum(gd[2:] * vd[:-2]), -np.sum(gd[1:] * wd[:-1]),
            -np.sum(gd[2:] * wd[:-2])]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


# --- the tensor designs ---------------------------------------------------------------

@pytest.mark.parametrize("gains", [(4.0, 2.0, -2.0, 1.0),
                                   (-6.0, -3.0, 5.5, -0.5)])
def test_eq_designs_match_jax(gains):
    want = np.stack([
        JE._rbj_shelf_coeffs_jnp(250.0, SR, jnp.float32(gains[0]), 0.7071,
                                 "low"),
        JE._rbj_peaking_coeffs_jnp(1000.0, SR, -jnp.float32(gains[1]),
                                   1.41),
        JE._rbj_peaking_coeffs_jnp(4000.0, SR, jnp.float32(gains[2]), 1.41),
        JE._rbj_shelf_coeffs_jnp(8000.0, SR, jnp.float32(gains[3]), 0.7071,
                                 "high")])
    got = eq.eq_quality_sos_t(SR, *torch.tensor(gains), peak_q=1.41)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # and the host float64 design of the same gains
    np.testing.assert_allclose(got.numpy(), eq.eq_quality_sos(SR, *gains,
                                                              peak_q=1.41),
                               rtol=0, atol=2e-6)


def test_tensor_stages_match_float_stages():
    """analog_character_quality / apply_eq_quality / stereo_width_quality
    with tensor parameters against their float-parameter selves, within
    1e-4 of the largest sample: the tensor designs round the closed-form
    coefficients to float32 (as ame_tpu's traced designs do), and the 120
    Hz shelf's poles near z = 1 amplify that rounding (2e-5 measured)."""
    from ame_tpu_torch.ops import stereo
    x = torch.from_numpy((0.1 * np.random.default_rng(8).standard_normal(
        (4000, 2))).astype(np.float32))
    a = saturate.analog_character_quality(x, SR, torch.tensor(20.0))
    b = saturate.analog_character_quality(x, SR, 20.0)
    _close(a, b, 1e-4)
    a = eq.apply_eq_quality(x, SR, torch.tensor(2.0), 1.0, 1.5, 0.0)
    b = eq.apply_eq_quality(x, SR, 2.0, 1.0, 1.5, 0.0)
    _close(a, b, 1e-4)
    _close(stereo.stereo_width_quality(x, torch.tensor(1.3)),
           stereo.stereo_width_quality(x, 1.3), 1e-7)


# --- automaster against the JAX package ------------------------------------------------

@pytest.fixture(scope="module")
def jax_grads():
    """jax.value_and_grad of _perceptual_loss (every term on, multiband
    parameters included) and of _loss_fn, computed once."""
    x, t = _tracks()
    th = {k: jnp.asarray(v) for k, v in _theta_np().items()}
    profs, dyn, field = JA._perceptual_targets(t, SR, RES, 1.0, 1.0)
    args = (jnp.asarray(x), profs, dyn, field, SR, RES, 1.0, 1.0, 1.0,
            -20.0)
    perc = jax.jit(jax.value_and_grad(JA._perceptual_loss),
                   static_argnums=(5, 6, 7, 8, 9, 10))(th, *args)
    th3 = {k: jnp.asarray(v) for k, v in _theta_np(False).items()}
    prof = JA._logmel_profile(jnp.asarray(t), SR)
    plain = jax.jit(jax.value_and_grad(JA._loss_fn), static_argnums=(3,))(
        th3, jnp.asarray(x), prof, SR)
    return {"perceptual": perc, "plain": plain}


def _assert_grads(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k].grad, np.asarray(w), rel, k)


def test_perceptual_grad_matches_jax(jax_grads):
    x, t = _tracks()
    th = convert.automaster_theta(_theta_np())
    profs, dyn, field = TA._perceptual_targets(torch.from_numpy(t), SR, RES,
                                               1.0, 1.0)
    loss = TA._perceptual_loss(th, torch.from_numpy(x), profs, dyn, field,
                               SR, RES, 1.0, 1.0, 1.0, -20.0)
    loss.backward()
    want_loss, want = jax_grads["perceptual"]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    _assert_grads(th, want, 1e-3)


def test_loss_fn_grad_matches_jax(jax_grads):
    x, t = _tracks()
    th = convert.automaster_theta(_theta_np(False))
    with torch.no_grad():
        prof = TA._logmel_profile(torch.from_numpy(t), SR)
    loss = TA._loss_fn(th, torch.from_numpy(x), prof, SR)
    loss.backward()
    want_loss, want = jax_grads["plain"]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    _assert_grads(th, want, 1e-3)


def test_fit_settings_matches_jax():
    x, t = _tracks()
    kw = dict(steps=5, stereo_weight=1.0)
    want = JA.fit_settings(x, SR, t, **kw)
    got = TA.fit_settings(x, SR, t, device="cpu", **kw)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3,
                                   err_msg=k)
    assert got["width"] != 1.0            # the stereo term moved it


def test_fit_settings_refuses_bad_requests(monkeypatch):
    x, t = _tracks()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.fit_settings(x, SR, t, steps=1)
    with pytest.raises(ValueError, match="target track"):
        TA.fit_settings(x, SR, np.zeros(64, np.float32), steps=1,
                        target_is_profile=True, stereo_weight=1.0,
                        device="cpu")


def test_automaster_theta_and_init():
    th = TA.init_theta(True, "cpu")
    assert list(th) == ["analog_raw", "width_raw", "eq_raw", "mb_thresh_raw",
                        "mb_ratio_raw"]
    assert all(v.requires_grad and v.dtype == torch.float32
               for v in th.values())
    conv = convert.automaster_theta({k: np.asarray(v.detach())
                                     for k, v in th.items()})
    for k in th:
        assert torch.equal(conv[k], th[k]) and conv[k].requires_grad
    with pytest.raises(ValueError, match="not an automaster theta"):
        convert.automaster_theta({"bogus": np.zeros(2)})
    s = TA._theta_to_settings(th)
    assert s["width"] == 1.0 and s["multiband"] is True
    np.testing.assert_allclose(s["low_thresh"], -20.0)
