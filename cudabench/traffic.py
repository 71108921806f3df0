"""The one traffic generator: a mix file's parameters and a seed -> a pool
of stereo 16-bit tracks and the seeded order in which the window plays
them.

A mix (``traffic/<name>.json``) holds:

  * ``pool``: how many distinct tracks, ``sample_rate``; ``check``, where
    given, how many masters a run compares with the reference (the
    harness's default otherwise);
  * ``lengths``: ``{"kind": "fixed", "seconds": s}`` or
    ``{"kind": "lognormal_quantiles", "median_s", "sigma", "min_s",
    "max_s"}``: the pool's lengths are the distribution's quantiles at
    (i + 0.5) / pool, clipped, so every seed plays the same set of lengths
    and the seed only orders them;
  * ``content``: ``{"kind": "steady", "noise": a}`` (a * N(0, 1) on each
    channel) or ``{"kind": "gated", "noise": a, "sine": b, "sine_hz": f,
    "on_s": [lo, hi], "off_s": [lo, hi], "click": {"at_s", "ms",
    "level"}}``: a * N(0, 1) + b * sin(2 pi f t), switched on and off in
    sections of uniform lengths (starting on, silence off), with a click
    of ``level`` on both channels ``at_s`` into every on section long
    enough to hold it;
  * ``source`` and ``assumed``: where the parameters come from, and what
    no source backs (read by people, not by the generator).

The noise comes from a ``torch.Generator`` on ``device`` in one call a
track; the gate and click positions from numpy's generator on the host.
Samples are rounded to int16 as round(clip(x, -1, 1) * 32767).
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np
import torch


@dataclasses.dataclass
class Track:
    pcm: np.ndarray          # int16 [N, 2]
    sample_rate: int
    on_sections: int         # gated content: sections that play
    clicks: int              # gated content: clicks placed

    @property
    def seconds(self) -> float:
        return self.pcm.shape[0] / self.sample_rate


def lengths(mix: dict) -> list[int]:
    """The pool's track lengths in samples, in pool order."""
    spec, pool, sr = mix["lengths"], int(mix["pool"]), int(mix["sample_rate"])
    if spec["kind"] == "fixed":
        secs = [float(spec["seconds"])] * pool
    elif spec["kind"] == "lognormal_quantiles":
        z = [NormalDist().inv_cdf((i + 0.5) / pool) for i in range(pool)]
        secs = [min(max(spec["median_s"] * math.exp(spec["sigma"] * v),
                        spec["min_s"]), spec["max_s"]) for v in z]
    else:
        raise ValueError(f"unknown lengths kind {spec['kind']!r}")
    return [int(round(s * sr)) for s in secs]


def _seeds(seed: int, n: int) -> list[np.random.SeedSequence]:
    return np.random.SeedSequence(int(seed)).spawn(n)


def _torch_seed(ss: np.random.SeedSequence) -> int:
    hi, lo = ss.generate_state(2, np.uint32)
    return ((int(hi) & 0x7FFFFFFF) << 32) | int(lo)


def order(mix: dict, seed: int) -> list[int]:
    """The seeded order of the pool's indices that the window cycles."""
    ss = _seeds(seed, int(mix["pool"]) + 1)[-1]
    return [int(i) for i in np.random.default_rng(ss).permutation(
        int(mix["pool"]))]


def _gate(content: dict, n: int, sr: int, rng: np.random.Generator):
    """(section starts in samples, starting with an on section)."""
    starts, pos, on = [], 0, True
    while pos < n:
        starts.append(pos)
        lo, hi = content["on_s"] if on else content["off_s"]
        pos += max(int(round(rng.uniform(lo, hi) * sr)), 1)
        on = not on
    return starts


def make_track(mix: dict, n: int, ss: np.random.SeedSequence,
               device) -> Track:
    content, sr = mix["content"], int(mix["sample_rate"])
    g = torch.Generator(device=device)
    g.manual_seed(_torch_seed(ss))
    x = float(content["noise"]) * torch.randn((n, 2), generator=g,
                                              device=device)
    on_sections = clicks = 0
    if content["kind"] == "gated":
        k = torch.arange(n, device=device, dtype=torch.int64)
        f = int(content["sine_hz"])
        phase = (k * f % sr).to(torch.float64) * (2.0 * math.pi / sr)
        sine = torch.sin(phase).to(torch.float32)
        x += float(content["sine"]) * sine[:, None]
        starts = _gate(content, n, sr, np.random.default_rng(ss))
        bounds = torch.tensor(starts[1:], device=device, dtype=torch.int64)
        on = torch.searchsorted(bounds, k, right=True) % 2 == 0
        x *= on[:, None]
        click = content["click"]
        at = int(round(click["at_s"] * sr))
        width = max(int(round(click["ms"] * sr / 1000.0)), 1)
        ends = starts[1:] + [n]
        for s, e in zip(starts[0::2], ends[0::2]):
            on_sections += 1
            if s + at + width <= e:
                x[s + at:s + at + width] = float(click["level"])
                clicks += 1
    elif content["kind"] != "steady":
        raise ValueError(f"unknown content kind {content['kind']!r}")
    pcm = torch.round(torch.clamp(x, -1.0, 1.0) * 32767.0).to(torch.int16)
    return Track(pcm.cpu().numpy(), sr, on_sections, clicks)


def make_pool(mix: dict, seed: int, device) -> list[Track]:
    ns = lengths(mix)
    return [make_track(mix, n, ss, device)
            for n, ss in zip(ns, _seeds(seed, len(ns)))]
