"""The port's profiling utilities (vectorsearch_tpu_torch/utils)."""
import json

import pytest
import torch

from vectorsearch_tpu_torch import utils


def test_device_memory_stats_empty_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert utils.device_memory_stats() == []


def test_device_memory_stats_per_card(monkeypatch):
    """One entry per visible card, from the caching allocator's counters
    and the driver's free/total bytes (the torch.cuda calls stubbed: no
    card here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (10 + i, 80))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"card{i}")
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 5, "allocated_bytes.all.peak": 7,
        "reserved_bytes.all.current": 8,
    })
    got = utils.device_memory_stats()
    assert [d["device"] for d in got] == ["cuda:0", "cuda:1"]
    assert got[1] == {"device": "cuda:1", "name": "card1", "bytes_in_use": 5,
                      "peak_bytes_in_use": 7, "bytes_reserved": 8,
                      "bytes_free": 11, "bytes_limit": 80}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with utils.device_trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = tmp_path.glob("trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_device_trace_writes_on_error(tmp_path):
    with pytest.raises(RuntimeError):
        with utils.device_trace(str(tmp_path)):
            raise RuntimeError("inside the traced block")
    assert list(tmp_path.glob("trace-*.json"))
