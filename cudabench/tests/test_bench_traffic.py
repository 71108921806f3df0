"""Each mix is deterministic for a seed, plays the same set of lengths for
every seed, and holds the content it states."""

import json

import numpy as np
import pytest

from cudabench import traffic
from cudabench.spec import BENCH_DIR

SEED = 2**33 + 12345


def _mix(name):
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def _short(mix, seconds=6.0, pool=3):
    mix = json.loads(json.dumps(mix))
    mix["lengths"] = {"kind": "fixed", "seconds": seconds}
    mix["pool"] = pool
    return mix


def test_album_lengths_are_the_lognormal_quantiles():
    n = traffic.lengths(_mix("album_dynamic"))
    secs = [v / 44100 for v in n]
    assert len(n) == 12 and secs == sorted(secs)
    assert 120 <= secs[0] < 130 and 350 < secs[-1] <= 420
    assert abs(np.median(secs) - 210.0) < 7.0
    assert abs(np.mean(np.log(secs)) - np.log(210.0)) < 1e-6


def test_clips_are_exactly_thirty_seconds():
    assert traffic.lengths(_mix("clips30_dynamic")) == [1323000] * 12


@pytest.mark.parametrize("name", ["album_dynamic", "clips30_dynamic"])
def test_order_is_a_seeded_permutation(name):
    mix = _mix(name)
    a, b = traffic.order(mix, SEED), traffic.order(mix, SEED + 1)
    assert sorted(a) == list(range(12)) == sorted(b)
    assert a == traffic.order(mix, SEED) and a != b


@pytest.mark.parametrize("name", ["album_dynamic", "clips30_dynamic"])
def test_pool_is_deterministic_and_gated(name):
    mix = _short(_mix(name))
    p1 = traffic.make_pool(mix, SEED, "cpu")
    p2 = traffic.make_pool(mix, SEED, "cpu")
    p3 = traffic.make_pool(mix, SEED + 1, "cpu")
    assert [t.pcm.shape for t in p1] == [(264600, 2)] * 3
    for a, b, c in zip(p1, p2, p3):
        assert a.pcm.dtype == np.int16
        assert np.array_equal(a.pcm, b.pcm)
        assert not np.array_equal(a.pcm, c.pcm)
        # silent off sections, a click at 0.95 of full scale in on sections
        silent = np.all(a.pcm == 0, axis=1).mean()
        assert 0.1 < silent < 0.9
        assert a.clicks >= 1 and a.on_sections >= a.clicks
        assert np.abs(a.pcm).max() == round(0.95 * 32767)
        # the on sections hold 0.05 N(0, 1) + 0.05 sin(2 pi 100 t)
        on = a.pcm[~np.all(a.pcm == 0, axis=1)].astype(np.float64) / 32767
        body = on[np.abs(on).max(axis=1) < 0.9]
        assert 0.055 < body.std() < 0.07
        # the two channels carry independent noise
        assert abs(np.corrcoef(body[:, 0], body[:, 1])[0, 1] - 1 / 3) < 0.1


def test_click_lands_half_a_second_into_an_on_section():
    mix = _short(_mix("album_dynamic"))
    t = traffic.make_pool(mix, SEED, "cpu")[0]
    loud = np.flatnonzero(t.pcm[:, 0] == round(0.95 * 32767))
    assert loud[0] == 22050      # the track starts with an on section
    assert np.all(t.pcm[loud[0]:loud[0] + 220, :] == round(0.95 * 32767))


def test_steady_content():
    mix = _short(_mix("album_dynamic"), seconds=4.0, pool=2)
    mix["content"] = {"kind": "steady", "noise": 0.5}
    a = traffic.make_pool(mix, SEED, "cpu")
    b = traffic.make_pool(mix, SEED, "cpu")
    for t, u in zip(a, b):
        assert np.array_equal(t.pcm, u.pcm) and t.clicks == 0
        assert 0.45 < t.pcm.std() / 32767 < 0.5     # clipped at full scale
