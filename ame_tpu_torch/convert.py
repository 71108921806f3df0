"""Carry the reference's parameters and weights over to the port.

The mastering chains have no trained weights: what must match between
``ame_tpu`` and ``ame_tpu_torch`` there is the parameters and the filter
state (``zi``/``zf`` keep scipy's [k, C, 2] layout on both sides, so either
side's state can be handed to the other as a numpy array);
``streaming_state`` moves a streamer's carried state across. The mood CNN's
trained weights are a flax tree; ``mood_cnn_state_dict`` turns it into the
port's ``MoodCNN`` state dict and ``mood_cnn_params`` turns it back. For
training and fitting, ``automaster_theta`` and ``adam_state`` carry an
``ame_tpu`` fit's parameters and optax Adam state over to the port's
tensors and ``torch.optim.Adam``.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(d: dict, device) -> dict:
    """``ame_tpu.graph.chain.params_from_settings(s)`` converted to numpy
    (``{k: np.asarray(v)}``) -> the port's params, as
    ``ame_tpu_torch.graph.chain.params_from_settings`` builds them: 0-d
    arrays become host floats (the same float32 values), vectors become
    float32 tensors on ``device``."""
    out = {}
    for name, v in d.items():
        a = np.asarray(v)
        if a.ndim == 0:
            out[name] = float(a)
        else:
            out[name] = torch.as_tensor(a.astype(np.float32), device=device)
    return out


_QUALITY_STATE = ("zi_a", "zi_e", "past", "pend", "u_prev")
_MULTIBAND_STATE = ("mb_sq_hist", "mb_n_seen", "mb_u_prev", "mb_zi_att")
_LIMITER_STATE = ("pend", "carry")
# the compat limiter's host constants, which the port's own
# ``ops/limiter.alimiter_stream_init`` derives from the sample rate
_LIMITER_CONSTANTS = ("pieces_r", "pieces_a", "hold", "limit", "level_in",
                      "scale")


def streaming_state(jax_state, device="cpu") -> dict:
    """An ``ame_tpu`` streamer's carried state (its ``_state``: jax or numpy
    arrays) -> the same keys as float32 tensors on ``device``. Both packages
    keep the same keys and layouts, so this is a key check plus a move:

      * ``StreamingMaster``: ``zi_a`` [2, 2, 2], ``zi_e`` [4, 2, 2] (scipy
        layout), ``past`` / ``pend`` [A-1, 2], ``u_prev``; with multiband
        ``zi_mb{i}`` [k_i, 2, 2] per band, ``mb_sq_hist``, ``mb_n_seen``,
        ``mb_u_prev`` [G] and ``mb_zi_att`` [G, 2]. Hand the result to
        ``ame_tpu_torch.streaming.StreamingMaster.resume``.
      * the compat limiter (``ops/limiter.alimiter_stream_step``'s state,
        the one ``StreamingCompatMaster`` carries): ``pend`` [m, 2] and
        ``carry`` [6]; its host constants are left out (the port's
        ``alimiter_stream_init`` has its own), merge the result into it.
    """
    keys = set(jax_state)
    if "carry" in keys:
        take = _LIMITER_STATE
        extra = keys - set(_LIMITER_STATE) - set(_LIMITER_CONSTANTS)
    else:
        take = _QUALITY_STATE
        if "mb_u_prev" in keys:
            G = int(np.shape(jax_state["mb_u_prev"])[0])
            take += tuple(f"zi_mb{i}" for i in range(G)) + _MULTIBAND_STATE
        extra = keys - set(take)
    missing = set(take) - keys
    if missing or extra:
        raise ValueError(f"not a streamer state: missing {sorted(missing)}, "
                         f"unexpected {sorted(extra)}")
    return {k: torch.from_numpy(np.array(jax_state[k], np.float32)).to(device)
            for k in take}


def mood_cnn_state_dict(params: dict) -> dict:
    """The mood CNN's flax tree as numpy (``{"Conv_i": {"kernel", "bias"},
    "Dense_j": {...}}``, what ``models/_msgpack.load`` returns) -> the
    state dict of ``ame_tpu_torch.models.mood_cnn.MoodCNN`` (CPU float32
    tensors). Conv kernels go from HWIO [3, 3, Ci, Co] to OIHW [Co, Ci, 3,
    3], dense kernels from [in, out] to Linear's [out, in]."""
    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32)

    out = {}
    for i in range(3):
        layer = params[f"Conv_{i}"]
        out[f"convs.{i}.weight"] = t(np.transpose(layer["kernel"],
                                                  (3, 2, 0, 1)))
        out[f"convs.{i}.bias"] = t(layer["bias"])
    for j in range(2):
        layer = params[f"Dense_{j}"]
        out[f"dense{j}.weight"] = t(np.transpose(layer["kernel"]))
        out[f"dense{j}.bias"] = t(layer["bias"])
    return out


def mood_cnn_params(state_dict: dict) -> dict:
    """The inverse of ``mood_cnn_state_dict``: a ``MoodCNN`` state dict ->
    the flax tree as float32 numpy (``{"Conv_i": {"kernel", "bias"},
    "Dense_j": {...}}``, in flax's order, so ``models/_msgpack.dump``
    writes flax's bytes)."""
    def a(name):
        return state_dict[name].detach().to("cpu", torch.float32).numpy()

    out = {}
    for i in range(3):
        out[f"Conv_{i}"] = {
            "kernel": np.ascontiguousarray(
                np.transpose(a(f"convs.{i}.weight"), (2, 3, 1, 0))),
            "bias": a(f"convs.{i}.bias")}
    for j in range(2):
        out[f"Dense_{j}"] = {
            "kernel": np.ascontiguousarray(np.transpose(a(f"dense{j}.weight"))),
            "bias": a(f"dense{j}.bias")}
    return out


def automaster_theta(theta, device="cpu") -> dict:
    """An ``ame_tpu.models.automaster`` theta (dict of jax or numpy arrays)
    -> the port's: float32 leaf tensors on ``device`` that require grad, in
    the port's key order (``models/automaster.init_theta``)."""
    order = ("analog_raw", "width_raw", "eq_raw", "mb_thresh_raw",
             "mb_ratio_raw")
    extra = set(theta) - set(order)
    if extra:
        raise ValueError(f"not an automaster theta: {sorted(extra)}")
    return {k: torch.tensor(np.asarray(theta[k], np.float32), device=device,
                            requires_grad=True)
            for k in order if k in theta}


def adam_state(opt_state, params: dict) -> dict:
    """optax ``adam``'s state (a tuple whose first element is the
    ``ScaleByAdamState`` (count, mu, nu), mu and nu trees keyed like
    ``params``) -> ``torch.optim.Adam`` per-parameter state, keyed by the
    port's parameter tensors: ``opt.state.update(adam_state(s, theta))``
    continues the optax run. The update rules agree: optax's
    lr * mu_hat / (sqrt(nu_hat) + eps) is Adam's with its defaults."""
    adam = opt_state[0] if isinstance(opt_state, (tuple, list)) else opt_state
    count = int(np.asarray(adam.count))
    out = {}
    for name, p in params.items():
        out[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.tensor(np.asarray(adam.mu[name], np.float32),
                                    device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(adam.nu[name], np.float32),
                                       device=p.device)}
    return out
