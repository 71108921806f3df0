"""Exact pydub attenuation recurrence at any track length (PyTorch port of
``ame_tpu/ops/pydub_gain.py``).

The pydub ``compress_dynamic_range`` gain state is a per-sample recurrence
with a state-dependent branch (``_update``):

    att' = min(att + m/attack, m)   if att <= m
           max(att - m/release, 0)  otherwise

where m is the detector's max-attenuation (m == 0 below threshold, so the
state freezes exactly). The branch makes the map non-associative, so the
exact engines are the reference's:

  * Jacobi carry relaxation (``_jacobi_carries``): S segments per chain
    walked in parallel from carry estimates; the carries are refreshed
    from the carry-outs (identity segments bridged through ``lasti``)
    until they reproduce themselves bit for bit, at most ``_RMAX`` sweeps,
    with the stall rule; then one full sweep writes the attenuation. The
    fixed point equals the sequential walk by induction from c[0] = init.
  * the two-pass walk (``_two_pass``): pass 1 walks each chain in order and
    emits the state before every 32-sample group; pass 2 re-runs every
    group from its start state. Each band whose carries did not converge
    takes this path.

On a CUDA tensor the engine (``_gain_engine``) launches the hand-written
kernels of ``ame_tpu_torch/csrc/pydub_gain.cu`` — ``gain_jacobi`` (K2,
``_jac_kernel``), ``gain_p1`` (K3, ``_p1_kernel``) and ``gain_p2`` (K4,
``_p2_kernel``) — at any length. Every verdict stays on the device, as
in ``ame_tpu``: the sweep slots, the per-band fallback and the all-silent
early-out are ``_branch.device_if`` nodes, so the engine can be captured
into a CUDA graph (``graph.chain.master_graph_fused``) with no host read;
run eagerly it reads each verdict once (once a sweep). The reference's
``_SCAN_MAX``
route and ``AME_TPU_GAIN_*`` knobs are TPU compile-cost rules and are not
ported. On a CPU tensor the engine runs the same control flow over the
kernels' plain versions (``*_plain``), each a form of the plain sequential
walk ``_gain_scan``.

All three kernels and the plain versions round every product and sum
separately (no FMA), so they agree bit for bit.

``pydub_gain_ends`` returns the end state only: the engine's last row.

``pydub_gain_chunked`` (chunked compat, quirk Q6) resets the state at every
chunk start: its chunks are padded to whole 32-sample groups and the engine
takes one flag a group, which K3 and K2's reset route (``gain_jacobi`` with
``resets``; ``_jac_kernel`` with ``has_resets=True``) apply at the group's
start; a segment that holds a reset is never bridged as an identity.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ame_tpu_torch.ops import _build
from ame_tpu_torch.ops._branch import device_if, device_if_else

_K = 32          # start-state stride (samples per group) of the two-pass
_TB = 4096       # pass-1 walk block of the reference (sets _pad_block)
_BR = 512        # pass-2 groups per block of the reference (sets _pad_block)
_RMAX = 16       # max Jacobi sweeps
_SMAX_LOG = 11   # S cap = 2^11 segments


# ---------------------------------------------------------------------------
# The recurrence and the plain sequential walk
# ---------------------------------------------------------------------------

def _scal(attack_frames: float, release_frames: float):
    """(1/attack, 1/release) rounded to float32, as the reference's scal."""
    return (float(np.float32(1.0 / float(attack_frames))),
            float(np.float32(1.0 / float(release_frames))))


def _update(att, m, ma, mr):
    """One pydub gain step, given the products ma = m·inv_a and
    mr = m·inv_r (formed for a whole array at once: the same f32 products
    the kernels round before each sum)."""
    return torch.where(att <= m, torch.minimum(att + ma, m),
                       torch.clamp(att - mr, min=0.0))


def _gain_scan(m: torch.Tensor, inv_a: float, inv_r: float,
               init: torch.Tensor | None = None,
               resets: torch.Tensor | None = None) -> torch.Tensor:
    """The plain sequential walk. m: [N, G]; init: [G] state entering the
    first sample (zeros = the pydub track start); resets: [N, G] or [N, 1]
    0/1 flags, the state set to 0 before every flagged sample's step.
    Returns att [N, G]."""
    att = (m.new_zeros(m.shape[1]) if init is None
           else init.to(m.dtype).clone())
    ma, mr = m * inv_a, m * inv_r
    out = torch.empty_like(m)
    for t in range(m.shape[0]):
        if resets is not None:
            att = torch.where(resets[t] != 0, torch.zeros_like(att), att)
        att = _update(att, m[t], ma[t], mr[t])
        out[t] = att
    return out


def _gain_scan_reset(m: torch.Tensor, resets: torch.Tensor, inv_a: float,
                     inv_r: float) -> torch.Tensor:
    """The plain walk from zero state with the state zeroed wherever
    resets[t] != 0 (the 30 s chunk-boundary emulation, quirk Q6). m [N, G];
    resets [N, 1] or [N, G]."""
    return _gain_scan(m, inv_a, inv_r, None, resets)


# ---------------------------------------------------------------------------
# Kernels (CUDA) and their plain versions
# ---------------------------------------------------------------------------

_P1_STAGE = 1024     # samples per ring stage of gain_p1 (P1_STAGE)
_P1_STAGES = 16      # stages in its ring (P1_STAGES)
_P2_TG = 128         # groups a tile of gain_p2 (P2_TG), one a thread


def _p1_ring():
    """(stage, stages): gain_p1's ring of ``stages`` stages of ``stage``
    samples of m, one 32-sample group per producer lane; the kernel checks
    them against its build."""
    return _P1_STAGE, _P1_STAGES


def _p2_tile() -> int:
    """gain_p2's tile: this many consecutive 32-sample groups of one chain
    in shared memory, one walked by each thread of the block; the kernel
    checks it against its build."""
    return _P2_TG


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("pydub_gain")["path"]))
    f, p, ll, i = ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong, \
        ctypes.c_int
    lib.gain_p1_f32.argtypes = [p, p, p, p, ll, i, i, i, f, f, p]
    lib.gain_p2_f32.argtypes = [p, p, p, ll, i, i, f, f, p]
    lib.gain_jacobi_f32.argtypes = [p, p, p, p, p, ll, i, i, f, f, p]
    lib.gain_floor_f32.argtypes = [p, p, ll, i, f, f, p]
    for fn in (lib.gain_p1_f32, lib.gain_p2_f32, lib.gain_jacobi_f32,
               lib.gain_floor_f32):
        fn.restype = ctypes.c_int
    lib.pydub_gain_error.argtypes = [ctypes.c_int]
    lib.pydub_gain_error.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors; CPU tensors go through "
                         f"the plain version")
    if t.dtype != torch.float32 or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name} needs contiguous {ndim}-d float32 tensors, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _launch(name: str, fn, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({_lib().pydub_gain_error(err).decode()})")


def gain_p1_cuda(m: torch.Tensor, resets: torch.Tensor | None,
                 init: torch.Tensor, inv_a: float, inv_r: float):
    """K3's counterpart. m [G, N]; resets [ceil(N/32)] 0/1 flags or None;
    init [G]. Returns starts [G, ceil(N/32)]: the state before each group
    (zeroed at flagged group starts)."""
    _check("gain_p1_cuda", m, 2)
    _check("gain_p1_cuda", init, 1)
    G, n = m.shape
    ng = -(-n // _K)
    if init.shape[0] != G or n == 0:
        raise ValueError(f"gain_p1_cuda: m {tuple(m.shape)}, init "
                         f"{tuple(init.shape)}")
    if resets is not None:
        _check("gain_p1_cuda", resets, 1)
        if resets.shape[0] != ng:
            raise ValueError(f"resets must be [{ng}]")
    starts = torch.empty((G, ng), dtype=m.dtype, device=m.device)
    stage, stages = _p1_ring()
    with torch.cuda.device(m.device):
        _launch("gain_p1_f32", _lib().gain_p1_f32, m.data_ptr(),
                None if resets is None else resets.data_ptr(),
                init.data_ptr(), starts.data_ptr(), n, G, stage, stages,
                inv_a, inv_r)
    gain_p1_cuda.launches += 1
    if resets is not None:
        gain_p1_cuda.reset_launches += 1
    return starts


def gain_p1_plain(m: torch.Tensor, resets, init: torch.Tensor, inv_a: float,
                  inv_r: float) -> torch.Tensor:
    """K3's plain version: the sequential walk, group by group, recording
    the state before every 32-sample group."""
    G, n = m.shape
    ng = -(-n // _K)
    starts = m.new_empty((G, ng))
    att = init.to(m.dtype)
    for k in range(ng):
        if resets is not None:
            att = torch.where(resets[k] != 0, torch.zeros_like(att), att)
        starts[:, k] = att
        att = _gain_scan(m[:, k * _K:(k + 1) * _K].T, inv_a, inv_r, att)[-1]
    return starts


def gain_p2_cuda(m: torch.Tensor, starts: torch.Tensor, inv_a: float,
                 inv_r: float) -> torch.Tensor:
    """K4's counterpart. m [G, N]; starts [G, ceil(N/32)]. Returns
    att [G, N]: every group re-run from its start state."""
    _check("gain_p2_cuda", m, 2)
    _check("gain_p2_cuda", starts, 2)
    G, n = m.shape
    if tuple(starts.shape) != (G, -(-n // _K)) or n == 0:
        raise ValueError(f"gain_p2_cuda: m {tuple(m.shape)}, starts "
                         f"{tuple(starts.shape)}")
    att = torch.empty_like(m)
    with torch.cuda.device(m.device):
        _launch("gain_p2_f32", _lib().gain_p2_f32, m.data_ptr(),
                starts.data_ptr(), att.data_ptr(), n, G, _p2_tile(), inv_a,
                inv_r)
    gain_p2_cuda.launches += 1
    return att


def gain_p2_plain(m: torch.Tensor, starts: torch.Tensor, inv_a: float,
                  inv_r: float) -> torch.Tensor:
    """K4's plain version: all groups step together, 32 steps."""
    G, n = m.shape
    ng = starts.shape[1]
    pad = ng * _K - n
    mg = torch.nn.functional.pad(m, (0, pad)).reshape(G, ng, _K)
    ma, mr = mg * inv_a, mg * inv_r
    att = starts.clone()
    out = torch.empty_like(mg)
    for j in range(_K):
        att = _update(att, mg[:, :, j], ma[:, :, j], mr[:, :, j])
        out[:, :, j] = att
    return out.reshape(G, ng * _K)[:, :n]


def _reset_segments(resets: torch.Tensor, seg_len: int, lanes: int) -> int:
    """S, the segments a chain of K2's reset route: its group flags cover
    the padded chain, S * seg_len = 32 * len(resets), and S divides the
    lanes."""
    S = _K * resets.shape[0] // seg_len
    if S < 1 or S * seg_len != _K * resets.shape[0] or lanes % S:
        raise ValueError(f"resets [{resets.shape[0]}] do not cover whole "
                         f"segments of {seg_len} samples over {lanes} lanes")
    return S


def gain_jacobi_cuda(m_t: torch.Tensor, carry: torch.Tensor, inv_a: float,
                     inv_r: float, full: bool,
                     resets: torch.Tensor | None = None):
    """K2's counterpart: one sweep. m_t [seg_len, lanes] time-major, lanes
    a multiple of 4 (G*S, S >= 8); carry [lanes] carry-ins; resets None
    (the unchunked route) or [S*seg_len/32] 0/1 flags, one a 32-sample
    group of the padded chain, shared by the G chains (the reset route).
    Returns (carry-outs [lanes], att_t [seg_len, lanes] when ``full`` else
    None)."""
    _check("gain_jacobi_cuda", m_t, 2)
    _check("gain_jacobi_cuda", carry, 1)
    seg_len, lanes = m_t.shape
    if carry.shape[0] != lanes or seg_len == 0 or lanes % 4:
        raise ValueError(f"gain_jacobi_cuda: m_t {tuple(m_t.shape)}, carry "
                         f"{tuple(carry.shape)}")
    S = 0
    if resets is not None:
        _check("gain_jacobi_cuda", resets, 1)
        S = _reset_segments(resets, seg_len, lanes)
    co = torch.empty_like(carry)
    att_t = torch.empty_like(m_t) if full else None
    with torch.cuda.device(m_t.device):
        _launch("gain_jacobi_f32", _lib().gain_jacobi_f32, m_t.data_ptr(),
                carry.data_ptr(), co.data_ptr(),
                None if att_t is None else att_t.data_ptr(),
                None if resets is None else resets.data_ptr(), seg_len,
                lanes, S, inv_a, inv_r)
    gain_jacobi_cuda.launches += 1
    if resets is not None:
        gain_jacobi_cuda.reset_launches += 1
    return co, att_t


def _lane_resets(resets: torch.Tensor, seg_len: int,
                 lanes: int) -> torch.Tensor:
    """The group flags as K2's lanes meet them: [seg_len, lanes] time-major,
    the flag of each group start at its row in the lane's segment (lane
    g*S + s walks samples s*seg_len ..), 0 elsewhere."""
    S = _reset_segments(resets, seg_len, lanes)
    per_sample = resets.new_zeros(S * seg_len)
    per_sample[::_K] = resets
    return per_sample.reshape(S, seg_len).T.repeat(1, lanes // S)


def gain_jacobi_plain(m_t: torch.Tensor, carry: torch.Tensor, inv_a: float,
                      inv_r: float, full: bool,
                      resets: torch.Tensor | None = None):
    """K2's plain version: every lane walked from its carry-in, its state
    zeroed at its flagged group starts."""
    r_t = (None if resets is None
           else _lane_resets(resets, m_t.shape[0], m_t.shape[1]))
    att_t = _gain_scan(m_t, inv_a, inv_r, carry, r_t)
    return att_t[-1].clone(), (att_t if full else None)


# ``launches``: the calls that launched each kernel. A call recorded into a
# CUDA graph counts once, at capture, and not at its replays.
for _fn in (gain_p1_cuda, gain_p2_cuda, gain_jacobi_cuda):
    _fn.launches = 0
# launches of K2's reset route and K3 with flags (within the counts above)
gain_jacobi_cuda.reset_launches = 0
gain_p1_cuda.reset_launches = 0


def _kernels(device: torch.device):
    """(jacobi, p1, p2) for a device: the CUDA kernels on a card, their
    plain versions on the CPU."""
    if device.type == "cuda":
        return gain_jacobi_cuda, gain_p1_cuda, gain_p2_cuda
    return gain_jacobi_plain, gain_p1_plain, gain_p2_plain


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _pad_block(n: int) -> int:
    """Padded length aligned to the reference engines' block granules."""
    blk = max(_TB, _BR * _K)
    return -(-n // blk) * blk


def _select_S(npad: int) -> int:
    """Segments = pow2 in [8, 2^11], targeting ~4 K-sample segments."""
    return 1 << max(3, min(_SMAX_LOG, int(math.log2(max(npad // 4096, 8)))))


def _identity_segments(m_t: torch.Tensor, G: int, S: int,
                       resets: torch.Tensor | None = None) -> torch.Tensor:
    """[G, S] bool: segments whose every step is att -> att exactly, i.e.
    all-zero m AND no flagged group start inside (a reset is not an
    identity: bridging past it would carry a stale state). resets: the
    group flags [S*seg_len/32] or None."""
    seg_id = (torch.amax(m_t, dim=0) == 0.0).reshape(G, S)
    if resets is not None:
        seg_len = m_t.shape[0]
        q = torch.arange(resets.shape[0], device=m_t.device)
        held = resets.new_zeros(S).index_add_(0, q * _K // seg_len, resets)
        seg_id = seg_id & (held == 0.0)[None]
    return seg_id


def _jacobi_carries(m_t: torch.Tensor, G: int, S: int, init: torch.Tensor,
                    inv_a: float, inv_r: float,
                    resets: torch.Tensor | None = None):
    """Relax the segment carries of G chains. m_t: [seg_len, G*S]
    time-major (lane g*S + s is segment s of chain g); init: [G]; resets:
    the group flags [S*seg_len/32] shared by the chains, or None.
    Returns (carries [G, S], converged [G] bool, sweeps: 0-d int64), all on
    m_t's device.

    ``ame_tpu``'s ``lax.while_loop`` as ``_RMAX`` sweep slots: the first
    always runs (its condition holds at the start), each later one is a
    ``device_if`` on ``go``, which the sweep before computed on the device
    with the stall rule. Eagerly the slots stop at the first ``go`` that
    reads false: one read a sweep."""
    jacobi = _kernels(m_t.device)[0]
    dev = m_t.device
    # identity segments are bridged by the last non-identity segment at or
    # before each position
    seg_id = _identity_segments(m_t, G, S, resets)
    ar = torch.arange(S, device=dev).expand(G, S)
    lasti = torch.cummax(torch.where(seg_id, torch.full_like(ar, -1), ar),
                         dim=1).values
    init_col = init.to(torch.float32)[:, None]

    def refresh(co):
        src = torch.gather(co, 1, torch.clamp(lasti, min=0))
        bridged = torch.where(lasti < 0, init_col.expand(G, S), src)
        return torch.cat([init_col, bridged[:, :-1]], dim=1)

    c = torch.cat([init_col, init_col.new_zeros((G, S - 1))], dim=1)
    done = torch.zeros(G, dtype=torch.bool, device=dev)
    j, nstab, prev_stab = (torch.zeros((), dtype=torch.int64, device=dev)
                           for _ in range(3))
    go = torch.ones((), dtype=torch.bool, device=dev)

    def sweep():
        co, _ = jacobi(m_t, c.reshape(-1), inv_a, inv_r, False, resets)
        nxt = refresh(co.reshape(G, S))
        stable = nxt == c                      # bit-exact acceptance
        torch.all(stable, dim=1, out=done)
        prev_stab.copy_(nstab)
        nstab.copy_(stable.sum())
        c.copy_(nxt)
        j.add_(1)
        # stall rule (ame_tpu/ops/pydub_gain.py:482-487): from sweep 3 on,
        # stop when the current resolution rate cannot cover the
        # unresolved carries in the sweeps left
        rate = torch.clamp(nstab - prev_stab, min=0)
        progressing = (j < 3) | (rate * (_RMAX - j) >= G * S - nstab)
        torch.logical_and((j < _RMAX) & ~torch.all(done), progressing,
                          out=go)

    sweep()
    for _ in range(_RMAX - 1):
        if not device_if(go, sweep):
            break
    return c, done, j


def _two_pass(m: torch.Tensor, init: torch.Tensor, inv_a: float,
              inv_r: float, resets=None) -> torch.Tensor:
    """Pass 1 (sequential walk, starts every 32 samples) + pass 2 (groups
    re-run in parallel). m [G, N]; returns att [G, N]."""
    _, p1, p2 = _kernels(m.device)
    starts = p1(m, resets, init.to(torch.float32).contiguous(), inv_a, inv_r)
    return p2(m, starts, inv_a, inv_r)


def _jacobi_layout(m: torch.Tensor, resets: torch.Tensor | None):
    """m [G, N] -> (m_t [seg_len, G*S] time-major, the group flags padded
    to the segments or None, S): the one transpose; zero padding is the
    below-threshold freeze, exact, and trimmed afterwards."""
    G, n = m.shape
    npad = _pad_block(n)
    S = _select_S(npad)
    m_t = torch.nn.functional.pad(m, (0, npad - n)).reshape(
        G, S, npad // S).permute(2, 0, 1).reshape(npad // S,
                                                  G * S).contiguous()
    if resets is not None:
        resets = torch.nn.functional.pad(resets,
                                         (0, npad // _K - resets.shape[0]))
    return m_t, resets, S


def _jacobi_full(att: torch.Tensor, ok: torch.Tensor, m_t: torch.Tensor,
                 c: torch.Tensor, S: int, inv_a: float, inv_r: float,
                 resets: torch.Tensor | None) -> None:
    """The full sweep from the relaxed carries c [G, S], written into the
    converged chains' rows of att [G, N] (the others keep theirs)."""
    G, n = att.shape
    seg_len = m_t.shape[0]
    _, att_t = _kernels(m_t.device)[0](m_t, c.reshape(-1), inv_a, inv_r,
                                       True, resets)
    jac = att_t.reshape(seg_len, G, S).permute(1, 2, 0).reshape(
        G, S * seg_len)[:, :n]
    torch.where(ok[:, None], jac, att, out=att)


def _jacobi(m: torch.Tensor, init: torch.Tensor, inv_a: float,
            inv_r: float, resets: torch.Tensor | None = None):
    """The Jacobi half of the engine alone. m [G, N]; resets None or
    [ceil(N/32)] group flags (K3's form). -> (att [G, N]: the full sweep's
    rows of the converged chains, the others unset; converged [G] bool;
    sweeps, 0-d)."""
    m_t, resets, S = _jacobi_layout(m, resets)
    c, ok, sweeps = _jacobi_carries(m_t, m.shape[0], S, init, inv_a, inv_r,
                                    resets)
    att = torch.empty_like(m)
    device_if(torch.any(ok),
              lambda: _jacobi_full(att, ok, m_t, c, S, inv_a, inv_r, resets))
    return att, ok, sweeps


def _gain_engine_hot(m: torch.Tensor, init: torch.Tensor, inv_a: float,
                     inv_r: float, resets: torch.Tensor | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Jacobi with the per-band two-pass fallback. m [G, N] -> att [G, N]
    (written into ``out`` when given); resets None or [ceil(N/32)] group
    flags, given to both engines.

    The verdicts stay on the device, as ``ame_tpu``'s ``lax.cond`` pair
    (:593-613): K3 + K4 for every chain under ``device_if(~all(ok))``, then
    the full sweep under ``device_if(any(ok))`` over the converged rows.
    Eagerly, when every chain converged, the second verdict is known and
    not read."""
    m_t, resets_p, S = _jacobi_layout(m, resets)
    c, ok, _ = _jacobi_carries(m_t, m.shape[0], S, init, inv_a, inv_r,
                               resets_p)
    att = torch.empty_like(m) if out is None else out

    def full():
        _jacobi_full(att, ok, m_t, c, S, inv_a, inv_r, resets_p)

    if device_if(~torch.all(ok), lambda: att.copy_(
            _two_pass(m, init, inv_a, inv_r, resets))):
        device_if(torch.any(ok), full)
    else:
        full()
    return att


def _gain_engine(m: torch.Tensor, init: torch.Tensor, inv_a: float,
                 inv_r: float,
                 resets: torch.Tensor | None = None) -> torch.Tensor:
    """The exact engine with the all-silent early-out: when every chain's
    m is identically zero and the state starts at zero, att is zero
    everywhere exactly (resets zero a zero state), and no kernel runs.
    m [G, N] -> att [G, N]; resets None or [ceil(N/32)] group flags."""
    silent = torch.logical_and(torch.all(init == 0.0), torch.all(m == 0.0))
    att = torch.empty_like(m)
    device_if_else(silent, att.zero_, lambda: _gain_engine_hot(
        m, init, inv_a, inv_r, resets, out=att))
    return att


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def pydub_gain_multi(ms, attack_frames: float, release_frames: float,
                     init=None):
    """Exact pydub attenuation for G independent chains sharing attack and
    release (the reference's three bands). ms: list of G same-length [N]
    float32 tensors; init: [G] state entering the first sample (default
    zeros = the track start). Returns a list of G [N] attenuations in dB."""
    m = torch.stack([torch.as_tensor(v, dtype=torch.float32) for v in ms])
    G = m.shape[0]
    inv_a, inv_r = _scal(attack_frames, release_frames)
    init = (m.new_zeros(G) if init is None
            else torch.as_tensor(init, dtype=torch.float32, device=m.device))
    att = _gain_engine(m.contiguous(), init, inv_a, inv_r)
    return [att[g] for g in range(G)]


def pydub_gain_ends(ms, attack_frames: float, release_frames: float,
                    init=None) -> torch.Tensor:
    """The attenuation state after the last sample only, [G] (``ame_tpu``'s
    carry-sweep function; the port's relaxation,
    ``parallel/sp_compat._pydub_gain_sp``, reads the same row from each
    sweep's full output). ms: list of G same-length [N] float32 tensors;
    init: [G] state entering the first sample (default zeros). The last
    row of ``pydub_gain_multi``: K2 from ``init`` on the card, bit-equal
    to the sequential walk."""
    att = pydub_gain_multi(ms, attack_frames, release_frames, init)
    return torch.stack([a[-1] for a in att])


def pydub_gain_chunked(ms, attack_frames: float, release_frames: float,
                       chunk_len: int):
    """Exact pydub attenuation with the state reset every ``chunk_len``
    samples: the reference's 30 s segment loop (quirk Q6), each chunk a
    fresh pydub call. ms: list of G same-length [N] float32 tensors;
    returns a list of G [N].

    Each chunk is padded up to whole 32-sample groups and its first group
    flagged, so the resets land on group starts, where K2's reset route and
    K3 apply them; the zero padding freezes the state, and the next chunk's
    flag zeroes it, so the trimmed result is exact."""
    m = torch.stack([torch.as_tensor(v, dtype=torch.float32) for v in ms])
    G, n = m.shape
    inv_a, inv_r = _scal(attack_frames, release_frames)
    m1, resets = _chunk_layout(m, chunk_len)
    att = _gain_engine(m1, m.new_zeros(G), inv_a, inv_r, resets)
    att = att.reshape(G, -(-n // chunk_len), -1)[:, :, :chunk_len].reshape(
        G, -1)[:, :n]
    return [att[g] for g in range(G)]


def _chunk_layout(m: torch.Tensor, chunk_len: int):
    """m [G, N] -> (m1 [G, n_chunks * cpad], resets [n_chunks * cpad / 32]):
    every chunk zero-padded to cpad, a whole number of 32-sample groups,
    and the first group of each flagged."""
    G, n = m.shape
    nc = -(-n // chunk_len)
    cpad = -(-chunk_len // _K) * _K
    rows = torch.nn.functional.pad(m, (0, nc * chunk_len - n)).reshape(
        G, nc, chunk_len)
    m1 = torch.nn.functional.pad(rows, (0, cpad - chunk_len)).reshape(
        G, nc * cpad)
    resets = m.new_zeros(nc * cpad // _K)
    resets[::cpad // _K].fill_(1.0)
    return m1.contiguous(), resets


def pydub_gain(m: torch.Tensor, attack_frames: float, release_frames: float):
    """Single-chain / stacked convenience wrapper. m: [N] or [N, G]."""
    if m.ndim == 1:
        return pydub_gain_multi([m], attack_frames, release_frames)[0]
    outs = pydub_gain_multi([m[:, g] for g in range(m.shape[1])],
                            attack_frames, release_frames)
    return torch.stack(outs, dim=1)
