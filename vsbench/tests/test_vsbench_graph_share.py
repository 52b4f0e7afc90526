"""The reader of search.graph_share: the program's counters `ivf.graph_replays`
over `ivf.calls`, in percent."""
import pytest

from vsbench import harness, spans
from vsbench.tests import tiny


@pytest.mark.parametrize("counters, want", [
    ({"ivf.calls": 4, "ivf.graph_replays": 3}, 75.0),
    ({"ivf.calls": 4, "ivf.graph_replays": 4}, 100.0),
    # a program that keeps no graphs replayed none of its calls
    ({"ivf.calls": 4}, 0.0),
    # no search call in the window: nothing to read
    ({"ivf.graph_replays": 3}, None),
    ({}, None),
])
def test_graph_share(monkeypatch, counters, want):
    graph_share = harness.load_module(
        tiny.ROOT / "vsbench" / "metrics" / "search.graph_share.py", "t_search.graph_share")
    monkeypatch.setattr(spans, "counters", lambda: counters)
    assert graph_share.read(None) == want
