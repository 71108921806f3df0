"""The quality multiband stage on the card (the ``cuda`` marker): the
release scan's launch counter against the profiler's device records, of
the scan alone and inside span ``multiband.release``; the five
``multiband.*`` spans carry device times inside ``chain.multiband``'s and
their event pairs add up to it within 10 %; at the benchmark's existing
cells' settings (multiband off) no release scan runs on the card, since
the limiter is a kernel there. Without a card each test skips.

Imports no JAX: on the card run ``python -m pytest -m cuda --noconftest
-p no:cacheprovider tests/test_torch_multiband_card.py``."""

import math

import numpy as np
import pytest
import torch

from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph.chain import master_graph
from ame_tpu_torch.ops import window as W
from ame_tpu_torch.utils import telemetry

SR = 44100
RHO = math.exp(-1.0 / (50.0 * SR / 1000.0))
FLAGSHIP = dict(analog_character=20.0, bass_boost=2.0, presence_boost=1.5,
                width=1.2, lufs=None)
MB = MasterSettings(**FLAGSHIP, multiband=True)
CHILDREN = ["multiband.split", "multiband.level", "multiband.release",
            "multiband.attack", "multiband.apply"]
# the gain computer's own kernels in span multiband.release, beside the
# scan's: level - threshold, the clamp, 1 / ratio (a reciprocal and a
# product by 1.0), 1 - that, the product (read off the profiler)
GAIN_COMPUTER_KERNELS = 6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the counts and the event pairs "
                    "are of device work")
    return torch.device("cuda")


def _hot(n: int, device) -> torch.Tensor:
    """album_hot's level: 0.25 N(0, 1) + 0.25 sin(2 pi 100 t)."""
    rng = np.random.default_rng(n)
    t = np.arange(n) / SR
    x = 0.25 * rng.standard_normal((n, 2)) + 0.25 * np.sin(
        2 * np.pi * 100 * t)[:, None]
    return torch.from_numpy(np.clip(x, -1, 1).astype(np.float32)).to(device)


def _device_events(prof):
    """(name, start, end) of the device's activities, and of the program's
    ranges' copies on the device's timeline."""
    work, ranges = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        span = (e.name, e.time_range.start, e.time_range.end)
        if (e.name.startswith(("ame.", "ProfilerStep"))
                or getattr(e, "is_user_annotation", False)):
            ranges.append(span)
        else:
            work.append(span)
    return work, ranges


def _profiled(fn):
    """The profile of one call of fn, and the scan's count over it. A
    warm-up step of the profiler runs fn first and its records are
    dropped: the first kernels of a session can go unrecorded."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        before = W.release_scan.launches
        fn()
        torch.cuda.synchronize()
        counted = W.release_scan.launches - before
        prof.step()
    return prof, counted


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1,), (129, 3), (300_000,),
                                   (9_702_000, 3), (15_567_300, 3)])
def test_release_scan_launches_match_the_profiler(card, shape):
    u = torch.rand(shape, device=card)
    W.release_scan(u, RHO)                                   # warm
    prof, counted = _profiled(lambda: W.release_scan(u, RHO))
    work, _ = _device_events(prof)
    assert counted == len(work), sorted({n for n, _, _ in work})


@pytest.mark.cuda
def test_multiband_spans_on_card(card):
    """At the album mix's mean track the five children's event pairs are
    inside the stage's and sum to it within 10 % (untraced by the
    profiler, whose ranges cost host time between them)."""
    x = _hot(9_702_000, card)
    master_graph(x, SR, MB)                                  # warm
    with telemetry.tracing():
        master_graph(x, SR, MB)
    spans = telemetry.records()
    (stage,) = [s for s in spans if s.name == "chain.multiband"]
    kids = sorted((s for s in spans if s.parent == stage.id),
                  key=lambda s: s.t0)
    assert [s.name for s in kids] == CHILDREN
    for s in kids:
        assert s.dev_t0 is not None and s.dev_t0 <= s.dev_t1
        assert stage.dev_t0 <= s.dev_t0 and s.dev_t1 <= stage.dev_t1
    whole = stage.dev_t1 - stage.dev_t0
    parts = sum(s.dev_t1 - s.dev_t0 for s in kids)
    assert abs(parts - whole) <= 0.1 * whole, (parts, whole)


@pytest.mark.cuda
def test_release_span_holds_the_counted_kernels(card):
    """Span ``multiband.release`` holds the scan's counted kernels and the
    gain computer's, no more."""
    x = _hot(20 * SR, card)
    master_graph(x, SR, MB)                                  # warm
    with telemetry.tracing():
        prof, counted = _profiled(lambda: master_graph(x, SR, MB))
    work, ranges = _device_events(prof)
    (rel,) = [(a, b) for n, a, b in ranges if n == "ame.multiband.release"]
    inside = [n for n, a, b in work if rel[0] <= a and b <= rel[1]]
    assert counted > 0
    assert len(inside) == counted + GAIN_COMPUTER_KERNELS, sorted(set(inside))


@pytest.mark.cuda
@pytest.mark.parametrize("lufs", [None, -14.0])
def test_existing_cells_run_no_release_scan(card, lufs):
    x = _hot(5 * SR, card)
    before = W.release_scan.launches
    master_graph(x, SR, MasterSettings(**dict(FLAGSHIP, lufs=lufs)))
    torch.cuda.synchronize()
    assert W.release_scan.launches == before
