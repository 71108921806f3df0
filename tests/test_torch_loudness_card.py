"""The loudness stage's spans on the card (the ``cuda`` marker): at
``lufs=-14`` the four children of ``chain.loudnorm`` carry device times
from their CUDA event pairs, inside the stage's own; a
``master_graph_fused`` capture and replays,
traced or not, keep the staged chain's bits, and record no span event
under the capture. Without a card each test skips.

Imports no JAX: on the card run ``python -m pytest -m cuda --noconftest
-p no:cacheprovider tests/test_torch_loudness_card.py``."""

import contextlib

import numpy as np
import pytest
import torch

from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph.chain import master_graph, master_graph_fused
from ame_tpu_torch.utils import telemetry

SR = 44100
FLAGSHIP = MasterSettings(analog_character=20.0, bass_boost=2.0,
                          presence_boost=1.5, width=1.2, lufs=-14.0)
CHILDREN = ["loudness.kweight", "loudness.gate", "loudness.true_peak",
            "loudness.gain"]


def _card_input(seconds=20.0, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the spans' device times are "
                    "CUDA events")
    n = int(seconds * SR)
    x = 0.1 * np.random.default_rng(seed).standard_normal((n, 2))
    x[n // 3: n // 2] = 0.0                    # digital silence
    return torch.from_numpy(x.astype(np.float32)).cuda()


@pytest.mark.cuda
def test_children_carry_device_times_on_card():
    x = _card_input()
    master_graph(x, SR, FLAGSHIP)                           # warm
    with telemetry.tracing():
        master_graph(x, SR, FLAGSHIP)
    spans = telemetry.records()
    (stage,) = [s for s in spans if s.name == "chain.loudnorm"]
    kids = sorted((s for s in spans if s.parent == stage.id),
                  key=lambda s: s.t0)
    assert [s.name for s in kids] == CHILDREN
    for s in kids:
        assert s.dev_t0 is not None and s.dev_t0 <= s.dev_t1
        assert stage.dev_t0 <= s.dev_t0 and s.dev_t1 <= stage.dev_t1


@pytest.mark.cuda
def test_fused_replays_keep_their_bits_on_card():
    """The first call warms the chain eagerly (spans with device times),
    then captures it (spans without: no event enters the graph); the
    replays run no Python stage at all."""
    x = _card_input(12.0, seed=1)
    want_y, want_i = master_graph(x, SR, FLAGSHIP)
    from ame_tpu_torch.graph import chain
    chain._fused.clear()
    for call, traced in enumerate((True, False, True)):
        with telemetry.tracing() if traced else contextlib.nullcontext():
            y, info = master_graph_fused(x, SR, FLAGSHIP)
        torch.cuda.synchronize()
        assert torch.equal(y, want_y)
        assert all(torch.equal(info[k], want_i[k]) for k in want_i)
        gates = [s for s in telemetry.records()
                 if s.name == "loudness.gate"]
        if call == 0:   # the warm run is timed, the capture is not
            timed = {s.dev_t0 is not None for s in gates}
            assert timed == {True, False}
        elif traced:
            assert gates == []
