"""IVFIndex.search's CUDA graphs on the card (index/graphs.py): from a
shape's second call on, the device chain between the upload and the read
is one graph replay. Every test holds the replayed answers to the eager
chain's (`IVFIndex._chain`, which both paths run, read back through
`IVFIndex._answers`), bit for bit: the graph replays the same kernels in
the same order on the same inputs.

Every test needs an NVIDIA GPU and nvcc and skips without one. This file
imports no jax (the machine with the card has none), so it runs there as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ivf_graph.py
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vectorsearch_tpu_torch import constants
from vectorsearch_tpu_torch.device import to_device
from vectorsearch_tpu_torch.index import IVFIndex, graphs
from vectorsearch_tpu_torch.kernels import grouped_scan
from vectorsearch_tpu_torch.quant import layout
from vectorsearch_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

K = 10


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    monkeypatch.setattr(constants, "BUCKET_ROUND", 64)
    profiling.reset()
    yield torch.device("cuda")
    profiling.reset()


def blobs(n_per=60, k=12, d=64, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 4
    v = (centers[:, None, :] + rng.normal(size=(k, n_per, d))).reshape(-1, d)
    return centers, v.astype(np.float32)


def index(dev, **kw):
    centers, v = blobs(**kw)
    ids = np.arange(1, len(v) + 1, dtype=np.int64) * 7
    return IVFIndex.build(layout.pack_float(v), ids, centers, device=dev), v


def queries(v, b, seed):
    rng = np.random.default_rng(seed)
    return (v[rng.integers(0, len(v), b)] + rng.normal(size=(b, v.shape[1]))).astype(np.float32)


def eager(ivf, q, nprobe, refine):
    """The eager chain's answers to `q`, as search reads them."""
    qd = torch.atleast_2d(to_device(q, ivf.device, torch.float32))
    key = graphs.Key(len(q), nprobe, K, refine, grouped_scan._default_epilogue(), len(q))
    return ivf._answers(qd, K, refine, *ivf._chain(qd, key))


def assert_bit_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def counters():
    return profiling.snapshot()["counters"]


@pytest.mark.parametrize("nprobe", [1, 8])
@pytest.mark.parametrize("refine", [0, 32])
def test_replays_are_bit_equal_to_the_eager_chain(cuda, nprobe, refine):
    ivf, v = index(cuda)
    n, b = 6, 48
    qs = [queries(v, b, seed) for seed in range(n)]
    want = [eager(ivf, q, nprobe, refine) for q in qs]
    launches = []
    with profile(activities=[ProfilerActivity.CPU]):
        for q, w in zip(qs, want):
            before = grouped_scan.LAUNCHES
            assert_bit_equal(ivf.search(q, k=K, nprobe=nprobe, refine=refine), w)
            launches.append(grouped_scan.LAUNCHES - before)
    c = counters()
    assert c["ivf.graph_captures"] == 1 and c["ivf.graph_replays"] == n - 2
    assert c["ivf.calls"] == n and c["ivf.syncs"] == 2 * n
    # every call, replayed or not, counts its one scan launch
    assert launches == [1] * n
    assert len(ivf._graphs.held) == 1
    # a replay has the span ivf.graph and no ivf.dispatch of its own
    spans = profiling.snapshot()["spans"]
    assert spans["ivf.graph"]["count"] == n - 2
    assert spans["ivf.dispatch"]["count"] == 3  # eager, warm-up, capture


def test_replays_with_the_spill_tail_live(cuda):
    ivf, v = index(cuda)
    extra = layout.pack_float(queries(v, 20, 99))
    ivf = dataclasses.replace(ivf, frozen=True).insert(extra, np.arange(20) + 100_000)
    assert ivf.spill.live == 20
    for seed in range(5):
        q = queries(v, 32, seed)
        got = ivf.search(q, k=K, nprobe=8, refine=32)
        assert_bit_equal(got, eager(ivf, q, 8, 32))
    assert len(ivf._graphs.held) == 1


def test_an_insert_recaptures_and_leaves_the_old_graphs_answers(cuda):
    ivf, v = index(cuda)
    q = queries(v, 40, 1)
    for _ in range(3):
        old = ivf.search(q, k=K, nprobe=8, refine=32)
    new_rows = queries(v, 30, 7)
    ivf2 = ivf.insert(layout.pack_float(new_rows), np.arange(30) + 200_000)
    assert ivf2.spill.live == 0 and not ivf2._graphs.held
    assert ivf2._graphs.shared is ivf._graphs.shared  # one pool, one lock
    for seed in range(4):
        q2 = queries(v, 40, 10 + seed)
        assert_bit_equal(ivf2.search(q2, k=K, nprobe=8, refine=32), eager(ivf2, q2, 8, 32))
    assert len(ivf2._graphs.held) == 1
    # the new rows are found, by the new instance's graph from the third call
    for _ in range(3):
        got = ivf2.search(new_rows, k=K, nprobe=8, refine=32)
    assert set(got[1][:, 0]) <= set(range(200_000, 200_030))
    # the old instance still replays its own graph on the old store
    assert_bit_equal(ivf.search(q, k=K, nprobe=8, refine=32), old)
    assert_bit_equal(old, eager(ivf, q, 8, 32))


def test_writes_that_drop_each_instance_keep_capturing_into_one_pool(cuda):
    """Bucket-changing writes, each dropping the instance before it: every
    new instance captures into the pool the first one opened, though no
    graph of the instances that used it is left, and answers as its eager
    chain does."""
    ivf, v = index(cuda)
    q = queries(v, 24, 0)
    pools = set()
    for w in range(5):
        for _ in range(3):  # eager, capture, replay
            got = ivf.search(q, k=K, nprobe=8, refine=32)
        assert len(ivf._graphs.held) == 1
        assert_bit_equal(got, eager(ivf, q, 8, 32))
        pools.add(id(ivf._graphs.shared.pool))
        rows = queries(v, 4, 50 + w)
        ivf = ivf.insert(layout.pack_float(rows), np.arange(4) + 300_000 + 4 * w)
        assert ivf.spill.live == 0 and not ivf._graphs.held
    assert len(pools) == 1


def test_more_shapes_than_the_cache_holds(cuda):
    ivf, v = index(cuda)
    sizes = [3, 5, 9, 17, 24, 31, 33, 38, 40, 41]
    assert len(sizes) > graphs.GRAPHS
    for b in sizes:
        for seed in range(3):
            q = queries(v, b, seed)
            assert_bit_equal(ivf.search(q, k=K, nprobe=8, refine=32), eager(ivf, q, 8, 32))
        assert len(ivf._graphs.held) <= graphs.GRAPHS
    assert [key.b for key in ivf._graphs.held] == sizes[-graphs.GRAPHS:]
    # the evicted shapes still answer, eagerly: each shape is captured once
    evicted = sizes[:-graphs.GRAPHS]
    want = {(b, seed): eager(ivf, queries(v, b, seed), 8, 32)
            for b in evicted for seed in range(3, 6)}
    with profile(activities=[ProfilerActivity.CPU]):
        for b in evicted:
            for seed in range(3, 6):
                q = queries(v, b, seed)
                assert_bit_equal(ivf.search(q, k=K, nprobe=8, refine=32), want[b, seed])
    assert [key.b for key in ivf._graphs.held] == sizes[-graphs.GRAPHS:]
    c = counters()
    assert c["ivf.calls"] == 3 * len(evicted)
    assert "ivf.graph_captures" not in c and "ivf.graph_replays" not in c


def test_a_spill_only_insert_replays_the_same_graph(cuda):
    """Rows to a frozen store's spill tail leave the buckets as they are:
    the new instance replays the graph the old one captured, and each
    answers from its own tail."""
    ivf, v = index(cuda)
    ivf = dataclasses.replace(ivf, frozen=True)
    q = queries(v, 32, 0)
    for _ in range(3):  # eager, capture, replay
        old = ivf.search(q, k=K, nprobe=8, refine=32)
    extra = queries(v, 32, 99)
    ivf2 = ivf.insert(layout.pack_float(extra), np.arange(32) + 100_000)
    assert ivf2.spill.live == 32 and ivf2._graphs is ivf._graphs
    qs = (extra, queries(v, 32, 1), queries(v, 32, 2))
    want = [eager(ivf2, q2, 8, 32) for q2 in qs]
    with profile(activities=[ProfilerActivity.CPU]):
        for q2, w in zip(qs, want):
            got = ivf2.search(q2, k=K, nprobe=8, refine=32)
            assert_bit_equal(got, w)
            if q2 is extra:  # each row finds itself in the new tail
                assert set(got[1][:, 0]) <= set(range(100_000, 100_032))
    c = counters()
    assert c["ivf.graph_replays"] == 3 and "ivf.graph_captures" not in c
    assert_bit_equal(ivf.search(q, k=K, nprobe=8, refine=32), old)


def test_a_failed_capture_stays_eager_and_counts_no_launch(cuda, monkeypatch):
    """An out-of-memory error while the chain records: the shape stays
    eager on the instance, its answers are the eager chain's, and the scan
    launches the capture recorded are not counted."""
    ivf, v = index(cuda)
    real = IVFIndex._chain
    failed = []

    def chain(self, queries, key):
        out = real(self, queries, key)
        if torch.cuda.is_current_stream_capturing() and not failed:
            failed.append(key)
            raise torch.cuda.OutOfMemoryError("out of memory while recording")
        return out

    monkeypatch.setattr(IVFIndex, "_chain", chain)
    q = queries(v, 40, 0)
    want = eager(ivf, q, 8, 32)
    launches = []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            before = grouped_scan.LAUNCHES
            assert_bit_equal(ivf.search(q, k=K, nprobe=8, refine=32), want)
            launches.append(grouped_scan.LAUNCHES - before)
    # eager; the warm-up, then the eager retry; eager; eager
    assert launches == [1, 2, 1, 1]
    assert not ivf._graphs.held and len(ivf._graphs.refused) == 1
    c = counters()
    assert c["ivf.calls"] == 4 and "ivf.graph_captures" not in c
    # the failed capture was the pool's first: the next shape captures
    # into a pool of its own, and replays
    q2 = queries(v, 41, 1)
    want2 = eager(ivf, q2, 8, 32)
    for _ in range(3):
        assert_bit_equal(ivf.search(q2, k=K, nprobe=8, refine=32), want2)
    assert [key.b for key in ivf._graphs.held] == [41]


def test_four_threads_on_one_index(cuda):
    ivf, v = index(cuda)
    # two threads share a shape, two have shapes of their own: captures
    # happen while the other threads search
    plan = {t: [(b, queries(v, b, 100 * t + i)) for i in range(8)]
            for t, b in enumerate([24, 24, 31, 45])}
    want = {t: [eager(ivf, q, 8, 32) for _, q in calls] for t, calls in plan.items()}
    got, errors = {t: [] for t in plan}, []
    start = threading.Barrier(len(plan))

    def run(t):
        try:
            start.wait()
            for _, q in plan[t]:
                got[t].append(ivf.search(q, k=K, nprobe=8, refine=32))
        except Exception as e:  # reported below, with its thread
            errors.append((t, repr(e)))

    threads = [threading.Thread(target=run, args=(t,)) for t in plan]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads) and not errors
    for t in plan:
        for g, w in zip(got[t], want[t]):
            assert_bit_equal(g, w)
    assert {key.b for key in ivf._graphs.held} == {24, 31, 45}


def test_release_device_drops_the_graphs(cuda):
    ivf, v = index(cuda)
    q = queries(v, 16, 0)
    for _ in range(3):
        ivf.search(q, k=K, nprobe=8, refine=32)
    assert ivf._graphs.held and ivf._graphs.shared.pool is not None
    ivf.release_device()
    assert not ivf._graphs.held and ivf._graphs.shared.pool is None
