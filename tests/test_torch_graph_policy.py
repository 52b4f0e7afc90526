"""When IVFIndex.search takes a CUDA graph (index/graphs.py), on the CPU:
the policy as a pure function, the graph cache's bounds, and the key and
facts a search hands the policy. The graphs themselves run on the card
(tests/test_torch_ivf_graph.py)."""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from vectorsearch_tpu_torch import constants
from vectorsearch_tpu_torch.device import to_host
from vectorsearch_tpu_torch.index import IVFIndex, graphs
from vectorsearch_tpu_torch.quant import layout

KEY = graphs.Key(b=512, nprobe=8, k=10, refine=32, epilogue="auto", b_max=512)


def plan(key=KEY, *, cuda=True, exhaustive=False, memoized=False, seen=(), held=(),
         refused=()):
    return graphs.plan(key, cuda=cuda, exhaustive=exhaustive, memoized=memoized,
                       seen=set(seen), held=set(held), refused=set(refused))


def test_a_shape_runs_eagerly_then_captures_then_replays():
    assert plan() == graphs.EAGER
    assert plan(seen=[KEY]) == graphs.CAPTURE
    assert plan(seen=[KEY], held=[KEY]) == graphs.REPLAY


@pytest.mark.parametrize("facts", [
    {"cuda": False}, {"exhaustive": True}, {"memoized": True}, {"refused": [KEY]},
], ids=["cpu", "exhaustive", "oom_memo", "refused"])
def test_no_graph(facts):
    """CPU tensors, the exhaustive route, an out-of-memory memo and a
    failed capture keep a call eager, however often its shape ran."""
    assert plan(seen=[KEY], held=[KEY], **facts) == graphs.EAGER
    assert plan(seen=[KEY], **facts) == graphs.EAGER


@pytest.mark.parametrize("field", graphs.Key._fields)
def test_every_key_field_tells_shapes_apart(field):
    other = KEY._replace(**{field: "flat" if field == "epilogue" else getattr(KEY, field) + 1})
    assert plan(other, seen=[KEY], held=[KEY]) == graphs.EAGER
    assert plan(other, seen=[KEY, other], held=[KEY]) == graphs.CAPTURE


def cache_plan(cache, key):
    return graphs.plan(key, cuda=True, exhaustive=False, memoized=False,
                       seen=cache.seen, held=cache.held, refused=cache.refused)


def test_the_cache_holds_its_bound_least_recently_used_out(monkeypatch):
    monkeypatch.setattr(graphs, "GRAPHS", 4)
    cache = graphs.GraphCache()
    keys = [KEY._replace(b=b) for b in range(1, 8)]
    for i, key in enumerate(keys[:4]):
        cache.put(key, f"graph {i}")
    assert list(cache.held) == keys[:4]
    assert cache.get(keys[0]) == "graph 0"  # now the most recently used
    for key in keys[4:]:
        cache.put(key, "later")
    assert list(cache.held) == [keys[0], *keys[4:]]
    assert cache.get(keys[1]) is None
    assert cache.refused == {keys[1], keys[2], keys[3]}
    # an evicted shape stays eager, however often it ran
    cache.saw(keys[1])
    assert cache_plan(cache, keys[1]) == graphs.EAGER


@pytest.mark.parametrize("shapes", [5, 12])
def test_shapes_taking_turns_past_the_bound_capture_each_at_most_once(monkeypatch, shapes):
    """More shapes than the cache holds, called in turn: the search loop
    (eager, then capture, then replays) captures each shape at most once,
    and the cache ends full of graphs that replay."""
    monkeypatch.setattr(graphs, "GRAPHS", 4)
    cache = graphs.GraphCache()
    keys = [KEY._replace(b=b) for b in range(1, shapes + 1)]
    did = {graphs.EAGER: 0, graphs.CAPTURE: 0, graphs.REPLAY: 0}
    captured = []
    for _ in range(20):
        for key in keys:
            what = cache_plan(cache, key)
            did[what] += 1
            if what == graphs.EAGER:
                cache.saw(key)
            elif what == graphs.CAPTURE:
                captured.append(key)
                cache.put(key, "graph")
            else:
                assert cache.get(key) == "graph"
    assert len(captured) == len(set(captured)) <= shapes
    assert len(cache.held) == 4
    # the last rounds: the held shapes replay, the rest run eagerly
    assert [cache_plan(cache, key) for key in keys].count(graphs.REPLAY) == 4
    assert did[graphs.CAPTURE] == len(captured)


def test_the_cache_remembers_a_bounded_number_of_shapes(monkeypatch):
    monkeypatch.setattr(graphs, "SEEN", 3)
    cache = graphs.GraphCache()
    keys = [KEY._replace(b=b) for b in range(1, 6)]
    for key in keys:
        cache.saw(key)
    cache.saw(keys[2])
    assert list(cache.seen) == [keys[3], keys[4], keys[2]]
    assert cache_plan(cache, keys[0]) == graphs.EAGER
    assert cache_plan(cache, keys[4]) == graphs.CAPTURE


def test_threads_recording_shapes_keep_the_bound(monkeypatch):
    """Eager calls of many threads record their shapes at once: no update
    is lost past the bound and nothing raises."""
    monkeypatch.setattr(graphs, "SEEN", 16)
    cache = graphs.GraphCache()
    errors = []

    def run(t):
        try:
            for i in range(2000):
                cache.saw(KEY._replace(b=(t * 7 + i) % 40))
        except Exception as e:  # reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors
    assert len(cache.seen) == 16


def test_clear_drops_graphs_shapes_and_pool():
    cache = graphs.GraphCache()
    cache.saw(KEY)
    cache.put(KEY, "graph")
    cache.shared.pool = object()
    cache.clear()
    assert not cache.held and not cache.seen and cache.shared.pool is None
    assert cache_plan(cache, KEY) == graphs.EAGER


# ---- what IVFIndex.search hands the policy


@pytest.fixture
def ivf(monkeypatch):
    monkeypatch.setattr(constants, "BUCKET_ROUND", 64)
    torch.set_num_threads(2)
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(12, 64)).astype(np.float32) * 4
    v = (centers[:, None, :] + rng.normal(size=(12, 40, 64))).reshape(-1, 64)
    return IVFIndex.build(layout.pack_float(v.astype(np.float32)),
                          np.arange(len(v), dtype=np.int64), centers, device="cpu")


@pytest.fixture
def asked(monkeypatch):
    """Each search's (key, facts) as the policy receives them."""
    calls = []
    real = graphs.plan

    def spy(key, *, seen, held, refused, **facts):
        calls.append((key, facts))
        return real(key, seen=seen, held=held, refused=refused, **facts)

    monkeypatch.setattr(graphs, "plan", spy)
    return calls


def query(ivf, b, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, ivf.dim)).astype(np.float32)


def test_search_keys_the_call_by_its_shape(ivf, asked):
    ivf.search(query(ivf, 5), k=4, nprobe=3, refine=8)
    ivf.search(query(ivf, 7), k=6, nprobe=2)
    assert [key for key, _ in asked] == [
        graphs.Key(5, 3, 4, 8, "auto", 5), graphs.Key(7, 2, 6, 0, "auto", 7)]
    assert all(facts == {"cuda": False, "exhaustive": False, "memoized": False}
               for _, facts in asked)


def test_cpu_searches_never_take_a_graph(ivf, asked):
    q = query(ivf, 5)
    first = ivf.search(q, k=4, nprobe=3, refine=8)
    for _ in range(3):
        again = ivf.search(q, k=4, nprobe=3, refine=8)
        np.testing.assert_array_equal(again[0], first[0])
        np.testing.assert_array_equal(again[1], first[1])
    assert list(ivf._graphs.seen) == [graphs.Key(5, 3, 4, 8, "auto", 5)]
    assert not ivf._graphs.held and ivf._graphs.shared.pool is None
    assert {facts["cuda"] for _, facts in asked} == {False}


def test_an_oom_memo_keys_the_call_and_keeps_it_eager(ivf, asked):
    ivf._oom_memo[3] = ("flat", 2)
    ivf.search(query(ivf, 5), k=4, nprobe=3, refine=8)
    ((key, facts),) = asked
    assert key == graphs.Key(5, 3, 4, 8, "flat", 2)
    assert facts["memoized"]
    assert plan(key, seen=[key], held=[key], **{**facts, "cuda": True}) == graphs.EAGER


@pytest.mark.parametrize("nprobe", [-1, 12, 99])
def test_the_exhaustive_route_is_told_so(ivf, asked, nprobe):
    ivf.search(query(ivf, 3), k=4, nprobe=nprobe, refine=8)
    ((key, facts),) = asked
    assert key.nprobe == ivf.k_clusters and facts["exhaustive"]


def test_a_write_returns_an_index_without_the_parents_shapes(ivf):
    q = query(ivf, 5)
    ivf.search(q, k=4, nprobe=3)
    assert ivf._graphs.seen
    ivf2 = ivf.insert(layout.pack_float(q), np.arange(5) + 10_000)
    assert ivf2._graphs is not ivf._graphs and not ivf2._graphs.seen
    ivf3 = ivf.remove_ids(np.arange(3))
    assert ivf3._graphs is not ivf._graphs and not ivf3._graphs.seen
    # the lock, stream and pool go on along the writes
    assert ivf2._graphs.shared is ivf._graphs.shared is ivf3._graphs.shared
    assert ivf2._graphs.lock is ivf._graphs.lock
    # a build is another index
    assert IVFIndex.build(*ivf.export_live_assigned()[:2], to_host(ivf.centroids),
                          device="cpu")._graphs.shared is not ivf._graphs.shared



@pytest.mark.parametrize("write", ["frozen_insert", "insert_past_cap", "remove_spill_row"])
def test_a_write_to_the_spill_tail_alone_keeps_the_graphs(ivf, write):
    """A write that leaves the buckets as they are (rows to the spill tail
    of a frozen store or of a full cluster, or a removal from the tail)
    hands on the folded rows and the graph cache; each instance answers
    from its own tail."""
    rows = query(ivf, 6, seed=1)
    ids = np.arange(6) + 10_000
    if write == "frozen_insert":
        old = dataclasses.replace(ivf, frozen=True)
    elif write == "insert_past_cap":
        cid = np.zeros(6, np.int64)
        old, n = ivf, 0
        while int(old.counts[0]) < old.cap:  # fill cluster 0
            old = old.insert(layout.pack_float(rows), np.arange(6) + 20_000 + n, cids=cid)
            n += 6
        old = dataclasses.replace(old, spill=ivf.spill)  # its tail empty again
    else:
        old = dataclasses.replace(ivf, frozen=True).insert(layout.pack_float(rows), ids)
    old.search(rows, k=4, nprobe=3)  # folds the sidecar rows
    if write == "remove_spill_row":
        new = old.remove_ids(ids[:1])
    else:
        new = old.insert(layout.pack_float(rows), ids,
                         cids=cid if write == "insert_past_cap" else None)
    assert new.spill.live != old.spill.live and new.buckets is old.buckets
    assert new._graphs is old._graphs and new.folded is old.folded
    in_old, in_new = (ids[0] in set(i.search(rows[:1], k=4, nprobe=3)[1][0])
                      for i in (old, new))
    if write == "remove_spill_row":
        assert in_old and not in_new
    else:
        assert in_new and not in_old
