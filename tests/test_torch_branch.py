"""The on-device verdicts that ame_tpu_torch.graph.chain.master_graph_fused
rests on, on the CPU: ops/_branch.device_if and device_if_else, the gain
engine's sweeps, per-band fallback and silent early-out against a copy of
its earlier host loop (the same decisions and the same bits), one read a
sweep when run eagerly, and a dispatch mode showing that the chain makes
no host read and uploads no host data outside device_if (what a CUDA graph
capture needs)."""

import threading
import traceback

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.ops import _branch
from ame_tpu_torch.ops import pydub_gain as pg
from tests.test_torch_fused import CASES, SR, chunk_seconds  # noqa: F401
from tests.test_torch_pydub_gain import ATTACK, RELEASE, _bursts


# ---------------------------------------------------------------------------
# The engine's verdicts against its earlier host loop
# ---------------------------------------------------------------------------

def _host_loop_carries(m_t, G, S, init, ia, ir, resets=None):
    """The relaxation as the engine ran it before its verdicts moved onto
    the device: the loop on the host, one read a sweep."""
    jacobi = pg._kernels(m_t.device)[0]
    seg_id = pg._identity_segments(m_t, G, S, resets)
    ar = torch.arange(S).expand(G, S)
    lasti = torch.cummax(torch.where(seg_id, torch.full_like(ar, -1), ar),
                         dim=1).values
    init_col = init.to(torch.float32)[:, None]

    def refresh(co):
        src = torch.gather(co, 1, torch.clamp(lasti, min=0))
        bridged = torch.where(lasti < 0, init_col.expand(G, S), src)
        return torch.cat([init_col, bridged[:, :-1]], dim=1)

    c = torch.cat([init_col, init_col.new_zeros((G, S - 1))], dim=1)
    done = torch.zeros(G, dtype=torch.bool)
    j, nstab, prev_stab = 0, 0, 0
    while j < pg._RMAX:
        rate = max(nstab - prev_stab, 0)
        if j >= 3 and rate * (pg._RMAX - j) < G * S - nstab:
            break
        co, _ = jacobi(m_t, c.reshape(-1).contiguous(), ia, ir, False,
                       resets)
        nxt = refresh(co.reshape(G, S))
        stable = nxt == c
        done = torch.all(stable, dim=1)
        verdict = torch.cat([done.to(torch.int64),
                             stable.sum().reshape(1)]).tolist()
        prev_stab, nstab = nstab, int(verdict[-1])
        c = nxt
        j += 1
        if all(verdict[:-1]):
            break
    return c, done, j


def _host_loop_engine(m, init, ia, ir, resets=None):
    """The earlier engine: host loop, host fallback list, host early-out.
    -> (att, converged list, sweeps, silent)."""
    if bool(torch.all(init == 0.0)) and bool(torch.all(m == 0.0)):
        return torch.zeros_like(m), None, 0, True
    m_t, resets_p, S = pg._jacobi_layout(m, resets)
    G, n = m.shape
    c, ok, sweeps = _host_loop_carries(m_t, G, S, init, ia, ir, resets_p)
    ok = ok.tolist()
    tp = pg._two_pass(m, init, ia, ir, resets) if not all(ok) else None
    if not any(ok):
        return tp, ok, sweeps, False
    _, att_t = pg._kernels(m.device)[0](m_t, c.reshape(-1).contiguous(),
                                        ia, ir, True, resets_p)
    att = att_t.reshape(-1, G, S).permute(1, 2, 0).reshape(G, -1)[:, :n]
    if all(ok):
        return att, ok, sweeps, False
    return (torch.where(torch.tensor(ok)[:, None], att, tp), ok, sweeps,
            False)


ENGINE_CASES = ("converging", "from_init", "slow", "one_band_stalls",
                "chunked", "silent", "silent_from_init")


def _engine_inputs():
    n = 1 << 15
    ia, ir = pg._scal(ATTACK, RELEASE)
    bursts = torch.from_numpy(_bursts(n))
    # translation-only content (attack 1e9: never saturates) in one chain
    # stalls its relaxation; the other, silent but for a freeze run,
    # converges: the fallback and the full sweep each take a row
    ia_t, ir_t = pg._scal(1e9, RELEASE)
    mixed = torch.zeros(2, 1 << 17)
    mixed[0] = 10.0
    mixed[1, 40000:42000] = 2.0
    chunk = 3000
    m1, flags = pg._chunk_layout(bursts, chunk)
    return {
        "converging": (bursts, torch.zeros(3), ia, ir, None),
        "from_init": (bursts, torch.tensor([0.0, 1.5, 6.0]), ia, ir, None),
        "slow": (bursts, torch.zeros(3), ia_t, ir_t, None),
        "one_band_stalls": (mixed, torch.zeros(2), ia_t, ir_t, None),
        "chunked": (m1, torch.zeros(3), ia, ir, flags),
        "silent": (torch.zeros(3, n), torch.zeros(3), ia, ir, None),
        "silent_from_init": (torch.zeros(3, n), torch.tensor([0.0, 2.0, 0.0]),
                             ia, ir, None),
    }


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_engine_verdicts_equal_host_loop(name, monkeypatch):
    """The sweeps taken, each chain's convergence, the fallback and the
    silent early-out equal the earlier host loop's, and the output bits
    are the same."""
    m, init, ia, ir, resets = _engine_inputs()[name]
    want, ok_w, sweeps_w, silent_w = _host_loop_engine(m, init, ia, ir,
                                                       resets)
    hot = []
    real_hot = pg._gain_engine_hot
    monkeypatch.setattr(pg, "_gain_engine_hot",
                        lambda *a, **k: hot.append(1) or real_hot(*a, **k))
    got = pg._gain_engine(m, init, ia, ir, resets)
    assert torch.equal(got, want)
    assert bool(hot) == (not silent_w)
    if silent_w:
        return
    m_t, resets_p, S = pg._jacobi_layout(m, resets)
    _, ok, sweeps = pg._jacobi_carries(m_t, m.shape[0], S, init, ia, ir,
                                       resets_p)
    assert ok.tolist() == ok_w and int(sweeps) == sweeps_w


def test_engine_reads_once_a_sweep(monkeypatch):
    """Eagerly the sweep slots stop at the first go that reads false: one
    read a sweep, as the host loop's .tolist() was."""
    m, init, ia, ir, _ = _engine_inputs()["converging"]
    m_t, _, S = pg._jacobi_layout(m, None)
    reads = []
    real = _branch.device_if
    monkeypatch.setattr(pg, "device_if",
                        lambda p, b: reads.append(1) or real(p, b))
    _, ok, sweeps = pg._jacobi_carries(m_t, 3, S, init, ia, ir)
    assert ok.all() and 1 <= int(sweeps) < pg._RMAX
    assert len(reads) == int(sweeps)


# ---------------------------------------------------------------------------
# The branch helper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", [True, False])
def test_device_if_runs_or_skips_its_body(value):
    out = torch.zeros(3)
    ran = _branch.device_if(torch.tensor(value),
                            lambda: out.copy_(torch.arange(3.0)))
    assert ran == value
    assert torch.equal(out, torch.arange(3.0) if value else torch.zeros(3))


@pytest.mark.parametrize("value", [True, False])
def test_device_if_else_runs_one_branch(value):
    out = torch.zeros(())
    _branch.device_if_else(torch.tensor(value), lambda: out.fill_(1.0),
                           lambda: out.fill_(-1.0))
    assert float(out) == (1.0 if value else -1.0)


def test_warm_all_branches_runs_every_body():
    seen = []
    with _branch.warm_all_branches():
        assert _branch.device_if(torch.tensor(False), lambda: seen.append(1))
        _branch.device_if_else(torch.tensor(True), lambda: seen.append(2),
                               lambda: seen.append(3))
    assert seen == [1, 2, 3]
    assert not _branch.device_if(torch.tensor(False), lambda: seen.append(4))


def test_warm_mode_is_the_calling_threads():
    """A warm-up on one thread leaves another thread's branches eager (a
    server's workers master while a capture warms up)."""
    seen = []

    def worker():
        seen.append(_branch.device_if(torch.tensor(False),
                                      lambda: seen.append("ran")))

    with _branch.warm_all_branches():
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [False]


class _HostReads(TorchDispatchMode):
    """Records every host read (``_local_scalar_dense``: ``.item()``,
    ``bool()``, ``.tolist()``, 0-d tensor indexing), upload of host data
    (``lift_fresh``: ``torch.tensor``, ``new_tensor``, ``as_tensor`` of a
    number) and op whose output shape depends on the data: what a capture
    cannot hold."""

    BAD = {"_local_scalar_dense", "lift_fresh", "nonzero", "masked_select",
           "bincount", "equal", "is_nonzero"}

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func).split(".")[1] if str(func).startswith("aten.") \
            else str(func)
        if name in self.BAD or name.startswith("unique"):
            frames = [f for f in traceback.extract_stack()
                      if "ame_tpu_torch" in f.filename]
            self.hits.append((name, f"{frames[-1].filename}:"
                                    f"{frames[-1].lineno}" if frames else "?"))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["quality_mb_edges", "compat_chunked",
                                  "compat_dynamic", "silent"])
def test_chain_reads_nothing_on_any_branch(case, chunk_seconds,
                                          monkeypatch):
    """What a capture needs: with the tables warm and every branch run
    (``warm_all_branches``: device_if reads no predicate), the chain makes
    no host read and uploads no host data (its parameters are made before
    the capture, as master_graph_fused does). The gain kernels' plain
    walks, Python loops over samples that only the CPU runs, are replaced
    by stand-ins of their shapes."""
    from ame_tpu_torch.graph import chain

    def jacobi(m_t, carry, ia, ir, full, resets=None):
        return carry.clone(), (torch.zeros_like(m_t) if full else None)

    def p1(m, resets, init, ia, ir):
        return m.new_zeros((m.shape[0], -(-m.shape[1] // pg._K)))

    monkeypatch.setattr(pg, "_kernels", lambda device: (
        jacobi, p1, lambda m, starts, ia, ir: torch.zeros_like(m)))
    settings, make = CASES[case]
    x = torch.from_numpy(make()[:1 << 15])
    settings, structure = chain._structure(MasterSettings(**settings))
    p = chain._params(settings, structure, x.device)
    chain._run(x, SR, p, structure, None)            # warm the caches
    mode = _HostReads()
    with mode, _branch.warm_all_branches():
        chain._run(x, SR, p, structure, None)
    assert mode.hits == []
