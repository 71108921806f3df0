"""master_graph_fused and the kernels' launch counters from several threads
at once.

On the CPU master_graph_fused runs the chain eagerly and must share no
mutable state across threads: four threads master four inputs at once,
each result bit-equal to master_graph on its own input. The launch
counters (ops/_count.bump) lose no count under contention. On the card
(the ``cuda`` marker): two threads, each on a stream of its own, replay
one captured graph on two inputs, interleaved, every output bit-equal to
master_graph (chip_smoke.py phase 19 (a) at a smaller size).

Imports no JAX: on the card run ``python -m pytest -m cuda --noconftest
-p no:cacheprovider tests/test_torch_fused_threads.py``."""

import ast
import os
import sys
import threading

import numpy as np
import pytest
import torch

from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph.chain import master_graph, master_graph_fused
from ame_tpu_torch.ops import _count

SR = 44100
FLAGSHIP = dict(analog_character=20.0, bass_boost=2.0, presence_boost=1.5,
                width=1.2, lufs=-14.0)
COMPAT = dict(FLAGSHIP, mode="compat", multiband=True)
JOIN_S = 300
OPS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ame_tpu_torch", "ops")


def _grid(x):
    """On the int16 grid, as api.master_array stages a compat input."""
    return (np.trunc(np.clip(x, -1.0, 1.0) * 32767.0) / 32768.0).astype(
        np.float32)


def _input(n, seed):
    """0.1 noise with full-scale clicks at a seed-dependent spacing, on the
    int16 grid: loudnorm's choice differs between seeds."""
    x = 0.1 * np.random.default_rng(seed).standard_normal((n, 2))
    x[::SR // (2 + seed)] = 0.9
    return _grid(x)


def _diff(got, want) -> dict:
    """The outputs of a master that differ from ``want``'s in any bit
    (NaN equal to NaN): name -> max abs difference."""
    (y, info), (y0, i0) = got, want
    out = {} if torch.equal(y, y0) else {"y": (y - y0).abs().max().item()}
    for k in set(info) | set(i0):
        a, b = info.get(k), i0.get(k)
        if a is None or b is None:
            out[k] = None
        elif not (torch.equal(a, b) or bool(torch.isnan(a).all()
                                            and torch.isnan(b).all())):
            out[k] = (a - b).abs().max().item()
    return out


def _run_threads(fns) -> list:
    """Each fn on its own thread, started together; joined with a timeout.
    Returns their results; re-raises the first exception."""
    barrier = threading.Barrier(len(fns))
    results, errors = [None] * len(fns), []

    def body(i, fn):
        try:
            barrier.wait(timeout=JOIN_S)
            results[i] = fn()
        except Exception as e:            # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i, fn), daemon=True)
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"
    if errors:
        raise errors[0]
    return results


# ---------------------------------------------------------------------------
# Launch counters
# ---------------------------------------------------------------------------

def test_bump_loses_no_count():
    """8 threads x 20 000 bumps of one counter (and a second attribute of
    the same wrapper) under a 1 us switch interval: exact totals."""
    def wrapper():
        pass
    wrapper.launches = 0
    wrapper.reset_launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(20_000):
                _count.bump(wrapper)
                _count.bump(wrapper, "reset_launches", i % 2)
        _run_threads([work] * 8)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 160_000
    assert wrapper.reset_launches == 80_000


@pytest.mark.parametrize("module", ["cascade_scan.py", "pydub_gain.py",
                                    "sos_grad.py", "wedge_env.py"])
def test_wrappers_count_through_bump(module):
    """No kernel wrapper adds to a launch counter in place: every count
    goes through ops/_count.bump."""
    with open(os.path.join(OPS, module)) as f:
        tree = ast.parse(f.read())
    in_place = [node.lineno for node in ast.walk(tree)
                if isinstance(node, ast.AugAssign)
                and isinstance(node.target, ast.Attribute)
                and node.target.attr.endswith("launches")]
    calls = [node for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and getattr(node.func, "id", None) == "bump"]
    assert not in_place and calls


# ---------------------------------------------------------------------------
# master_graph_fused from several threads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("settings", [FLAGSHIP, COMPAT],
                         ids=["quality", "compat"])
def test_fused_from_four_threads_cpu(settings):
    """Four threads at once, four inputs: each master bit-equal to
    master_graph on its own input.

    One intra-op thread: torch's CPU kernels split a tensor over an OpenMP
    team, and which worker computes a chunk can move its bits (seen with
    torch.tanh alone, from four Python threads right after eight others
    had exited: 8e-6 on one 6144-row chunk, none with one intra-op
    thread). That is torch's, not the port's; the port's own state is what
    this test holds."""
    s = MasterSettings(**settings)
    xs = [torch.from_numpy(_input(1 << 14, seed)) for seed in range(4)]
    intra = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        wants = [master_graph(x, SR, s) for x in xs]
        got = _run_threads([lambda x=x: master_graph_fused(x, SR, s)
                            for x in xs])
    finally:
        torch.set_num_threads(intra)
    diffs = [_diff(g, w) for g, w in zip(got, wants)]
    assert not any(diffs), diffs


@pytest.mark.cuda
def test_fused_two_streams_one_graph_on_card():
    """Phase 19 (a) of chip_smoke.py at 2^18 samples: one compat graph,
    two threads on streams of their own, 20 replays each on two inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the graph is a CUDA graph")
    from ame_tpu_torch.graph import chain
    s = MasterSettings(**COMPAT)
    xs = [torch.from_numpy(_input(1 << 18, seed)).cuda() for seed in (0, 1)]
    wants = [master_graph(x, SR, s) for x in xs]
    chain._fused.clear()
    master_graph_fused(xs[0], SR, s)                   # the capture

    def replayer(i):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            outs = [master_graph_fused(xs[i], SR, s) for _ in range(20)]
        stream.synchronize()
        return [_diff(o, wants[i]) for o in outs]

    try:
        diffs = _run_threads([lambda: replayer(0), lambda: replayer(1)])
        assert not any(any(d) for d in diffs), diffs
        assert len(chain._fused[xs[0].device]) == 1
    finally:
        chain._fused.clear()
