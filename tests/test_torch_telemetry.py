"""The port's memory telemetry (ame_tpu_torch.utils.telemetry) reads only
the cards this process uses and never creates a CUDA context: on the CPU,
torch.cuda is made to show two cards of which one holds memory, and every
per-card call is recorded."""

import logging

import pytest
import torch

from ame_tpu_torch.utils import telemetry


class TwoCards:
    """torch.cuda with two cards; `segments` lists the caching allocator's
    segments by card. Records each per-card call."""

    def __init__(self, monkeypatch, segments):
        self.segments = segments
        self.calls = []
        for name, fn in (("is_available", lambda: True),
                         ("is_initialized", lambda: True),
                         ("device_count", lambda: 2),
                         ("memory_snapshot", self.snapshot),
                         ("memory_stats", self.memory_stats),
                         ("mem_get_info", self.mem_get_info)):
            monkeypatch.setattr(torch.cuda, name, fn)
        monkeypatch.setattr(telemetry, "_seen_cards", set())

    def snapshot(self):
        return [{"device": d, "total_size": 2 << 20} for d in self.segments]

    def memory_stats(self, device=None):
        self.calls.append(("memory_stats", device))
        return {"allocated_bytes.all.current": 1 << 20,
                "allocated_bytes.all.peak": 3 << 20}

    def mem_get_info(self, device=None):
        self.calls.append(("mem_get_info", device))
        return (70 << 30, 80 << 30)


def test_device_memory_stats_reads_only_the_card_in_use(monkeypatch):
    cards = TwoCards(monkeypatch, segments=[1, 1])
    stats = telemetry.device_memory_stats()
    assert stats == [{"device": "cuda:1", "bytes_in_use": 1 << 20,
                      "peak_bytes_in_use": 3 << 20, "free_bytes": 70 << 30,
                      "total_bytes": 80 << 30}]
    assert cards.calls == [("memory_stats", 1), ("mem_get_info", 1)]


def test_a_card_that_held_memory_stays_listed(monkeypatch):
    """A card counts once its allocator was seen holding memory, also after
    its segments are released (its context exists); a card never seen is
    never asked."""
    cards = TwoCards(monkeypatch, segments=[0])
    assert [s["device"] for s in telemetry.device_memory_stats()] == \
        ["cuda:0"]
    cards.segments = []
    cards.calls.clear()
    assert [s["device"] for s in telemetry.device_memory_stats()] == \
        ["cuda:0"]
    assert {d for _, d in cards.calls} == {0}


def test_log_memory_usage_touches_only_the_card_in_use(monkeypatch, caplog):
    cards = TwoCards(monkeypatch, segments=[1])
    with caplog.at_level(logging.INFO, logger="ame_tpu_torch.telemetry"):
        telemetry.log_memory_usage("After Graph")
    assert {d for _, d in cards.calls} == {1}
    lines = [r.getMessage() for r in caplog.records]
    assert any("cuda:1" in ln for ln in lines)
    assert not any("cuda:0" in ln for ln in lines)


def test_no_card_in_use_reads_nothing(monkeypatch):
    cards = TwoCards(monkeypatch, segments=[])
    assert telemetry.device_memory_stats() == []
    assert cards.calls == []


def test_uninitialized_cuda_reads_nothing(monkeypatch):
    cards = TwoCards(monkeypatch, segments=[0, 1])
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert telemetry.device_memory_stats() == []
    assert cards.calls == []


def test_cpu_process_reports_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert telemetry.device_memory_stats() == []
    assert telemetry.host_rss_mb() > 0
