"""IVFIndex.insert between searches: a seeded sequence of writes at a small
size on the CPU, the answers after each held against the plain reference
over the rows live at that call (vsbench/reference/stream.py and
reference/ivf.py), read-your-writes, and the write path's spans and
counters (utils/profiling.py).

Rows follow the stream configuration's law (vsbench/configs/
vdbb-768d10m-stream.json, vsbench/corpus.py) at 6,000 x 64, K = 24; a
bucket capacity rounded to 64 slots with no headroom makes the fuller
clusters spill into the flat tail after a few writes."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vectorsearch_tpu_torch import constants
from vectorsearch_tpu_torch.index import IVFIndex
from vectorsearch_tpu_torch.quant.layout import PackedVectors
from vectorsearch_tpu_torch.utils import profiling
from vsbench import checks, corpus
from vsbench.drivers import stream as stream_driver
from vsbench.reference import ivf as ref_ivf
from vsbench.reference import stream as ref_stream
from vsbench.trace import from_profiler

N, D, K = 6000, 64, 24
WRITE_ROWS, WRITES, NPROBE, TOPK, REFINE = 256, 6, 3, 10, 32
# the stream cell's limits (vsbench/traffic/stream-b512-np8-w1024.json):
# the refine's float32 cosines against the reference's float64 ones, and
# ties at rank k within float32 rounding
SIM_TOL, GAP_TOL = 2e-05, 5e-06
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    monkeypatch.setattr(constants, "BUCKET_ROUND", 64)
    profiling.reset()
    yield
    profiling.reset()


def recipe():
    return corpus.Recipe(N, D, K, center_scale=2.0, cluster_size_sigma=0.2, query_noise=0.1)


@pytest.fixture
def data():
    """(base packed, base members, centroids, stream packed, stream
    members, queries) from one seed."""
    gen = corpus.Corpus(recipe(), 2**31 + 24, CPU)
    base, members = corpus.packed_rows(gen)
    stream, stream_members = stream_driver.stream_rows(gen, WRITE_ROWS * WRITES)
    queries = corpus.query_pool(recipe(), 2**31 + 24, 64,
                                lambda idx: ref_stream.rows_f64(base, stream, idx))
    return base, members, gen.centroids(), stream, stream_members, queries


def build(base, members, centroids, frozen=False, headroom=1.0):
    ivf = IVFIndex.build(PackedVectors(*base), np.arange(N), centroids, assignments=members,
                         headroom=headroom, device="cpu")
    if frozen:  # a store too large to copy: every write goes to the spill tail
        object.__setattr__(ivf, "frozen", True)
    return ivf


def write_rows(stream, w):
    lo = w * WRITE_ROWS
    return PackedVectors(*[a[lo : lo + WRITE_ROWS] for a in stream]), N + np.arange(lo, lo + WRITE_ROWS)


def rw_queries(base, stream, w, n=8):
    """n of write w's rows plus the query noise, and their ids: each must
    find its own row first."""
    rng = np.random.default_rng(w)
    ids = N + w * WRITE_ROWS + np.arange(n)
    rows = ref_stream.rows_f64(base, stream, ids)
    return (rows + 0.1 * rng.standard_normal(rows.shape)).astype(np.float32), ids


def held_to_reference(ivf, queries, base, members, centroids, stream, stream_members, writes):
    live = ref_stream.n_live(N, WRITE_ROWS, writes)
    scores, ids = ivf.search(queries, k=TOPK, nprobe=NPROBE, refine=REFINE)
    ref_sims, _ = ref_ivf.search(
        queries, centroids, ref_stream.members(members, stream_members, live),
        ref_stream.slabs(base, stream, live, CPU, step=1000), NPROBE, TOPK, CPU)
    got = checks.judge_search(ids, scores, queries,
                              lambda idx: ref_stream.rows_f64(base, stream, idx), ref_sims, live)
    return got, ids


@pytest.mark.parametrize("frozen", [False, True])
def test_writes_between_searches_against_the_reference(data, frozen):
    base, members, centroids, stream, stream_members, queries = data
    ivf = build(base, members, centroids, frozen)
    for w in range(WRITES + 1):
        rw, rw_ids = rw_queries(base, stream, w - 1) if w else (queries[:0], [])
        q = np.concatenate([rw, queries])
        got, ids = held_to_reference(ivf, q, base, members, centroids, stream, stream_members, w)
        assert got["sim_err"] <= SIM_TOL and got["topk_gap"] <= GAP_TOL, (w, got)
        assert got["bad_answers"] == 0
        # read your writes: the previous write's rows come back first
        assert np.array_equal(ids[: len(rw_ids), 0], rw_ids)
        if w < WRITES:
            ivf = ivf.insert(*write_rows(stream, w))
        assert ivf.n_live == ref_stream.n_live(N, WRITE_ROWS, min(w + 1, WRITES))
    # the fuller clusters spilled, so the spill tail took part in the answers
    assert ivf.spill.live > 0
    assert sorted(ivf.live_ids()) == list(range(N + WRITES * WRITE_ROWS))


def test_written_rows_land_in_their_own_clusters(data):
    """A stream row's generating direction is its nearest centroid: the
    program's assignment equals the members the reference owes queries by."""
    base, members, centroids, stream, stream_members, _ = data
    ivf = build(base, members, centroids)
    assert np.array_equal(ivf.assign(PackedVectors(*stream)), stream_members)


def test_dropped_write_fails_the_comparison(data):
    """Searching the index from before the write, as a caller that lost it
    would: the rows the reference owes are missing."""
    base, members, centroids, stream, stream_members, queries = data
    ivf = build(base, members, centroids)
    rw, rw_ids = rw_queries(base, stream, 0)
    got, ids = held_to_reference(ivf, rw, base, members, centroids, stream, stream_members, 1)
    assert got["topk_gap"] > GAP_TOL
    assert not np.array_equal(ids[:, 0], rw_ids)


def expected_copy(ivf: IVFIndex) -> int:
    """A write to the buckets copies the device store and the counts; the
    host grids take it as edits."""
    kk, cap, d = ivf.buckets.codes.shape
    device = kk * cap * (d + 12 + 1 + 8)  # codes, three f32 sidecars, mask, ids_dev
    return device + kk * 8  # the counts' int64 copy


@pytest.mark.parametrize("case", ["buckets", "spill", "frozen"])
def test_write_spans_and_counters(data, case):
    base, members, centroids, stream, _, _ = data
    ivf = build(base, members, centroids, frozen=case == "frozen",
                headroom=2.0 if case == "buckets" else 1.0)
    if case == "spill":  # fill the tail up to a write that spills
        while ivf.spill.n == 0:
            ivf = ivf.insert(*write_rows(stream, 0))
    rows, ids = write_rows(stream, 1)
    before, tail = ivf, ivf.spill.n
    ivf.ids, ivf.mask_host  # the earlier writes' edits applied: none left to fold
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ivf = ivf.insert(rows, ids)
    snap = profiling.snapshot()
    c = snap["counters"]
    spilled = ivf.spill.n - tail
    in_buckets = WRITE_ROWS - spilled
    assert c["ivf.inserts"] == 1 and c["ivf.inserted_rows"] == WRITE_ROWS
    assert c.get("ivf.spilled_rows", 0) == spilled
    assert (spilled > 0) == (case != "buckets") and (case != "frozen") == (in_buckets > 0)
    want = (expected_copy(before) if in_buckets else 0) + (tail * (D + 22) if spilled else 0)
    assert c["ivf.copied_bytes"] == want
    assert c.get("ivf.graph_resets", 0) == (1 if in_buckets else 0)
    events = [e for e in from_profiler(prof).host if e.name.startswith("vs::")]
    (call,) = [e for e in events if e.name == "vs::ivf.insert"]
    inside = {e.name[4:] for e in events if call.start <= e.start and e.end <= call.end}
    children = ({"ivf.assign", "ivf.insert_host", "ivf.insert_copy"} if in_buckets else set())
    children |= {"ivf.spill"} if spilled else set()
    assert inside - {"ivf.insert"} == children
    assert snap["spans"]["ivf.insert"]["count"] == 1


def grids(ivf):
    return ivf.ids.copy(), ivf.mask_host.copy()


def test_host_grids_take_writes_as_edits(data):
    """The host grids after a chain of writes and removals equal the
    copies the writes stand for, an instance keeps its own grids after the
    writes that follow it, no write copies them, and the first read copies
    each once."""
    base, members, centroids, stream, _, _ = data
    ivf = build(base, members, centroids, headroom=2.0)
    chain, want_ids, want_mask = [ivf], *grids(ivf)
    wants = [(want_ids.copy(), want_mask.copy())]
    for w in range(4):
        rows, ids = write_rows(stream, w)
        cid = ivf.assign(PackedVectors(*rows))
        if w == 2:  # a removal between the writes
            gone = N + np.arange(0, 2 * WRITE_ROWS, 3)
            ivf = ivf.remove_ids(gone)
            want_mask &= ~np.isin(want_ids, gone)
        counts = ivf.counts.copy()  # each cluster's next free slot
        for r, c in enumerate(cid):
            want_ids[c, counts[c]], want_mask[c, counts[c]] = ids[r], True
            counts[c] += 1
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.reset()
            ivf = ivf.insert(rows, ids)
            assert "ivf.host_mirror" not in profiling.snapshot()["spans"]
        chain.append(ivf)
        wants.append((want_ids.copy(), want_mask.copy()))
    assert ivf.spill.n == 0
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.reset()
        for idx, (ids, mask) in reversed(list(zip(chain, wants))):
            assert np.array_equal(idx.ids, ids) and np.array_equal(idx.mask_host, mask)
            assert np.array_equal(idx.ids, ids)  # read again: the same copy
        snap = profiling.snapshot()
    # one copy of each grid for every instance but the first, whose grids
    # are the build's own, and the third, whose grids the removal read
    assert snap["spans"]["ivf.host_mirror"]["count"] == 2 * (len(chain) - 2)
    assert snap["counters"]["ivf.copied_bytes"] == (len(chain) - 2) * ivf.ids.size * 9
    assert sorted(ivf.live_ids()) == sorted(np.flatnonzero(np.r_[
        np.ones(N, bool), ~np.isin(N + np.arange(4 * WRITE_ROWS), gone)]))


@pytest.mark.parametrize("rows, folds", [(1, False), (2, True)])
def test_host_mirror_folds_its_edits(rows, folds):
    """Edits past an eighth of the grid are applied at the write; fewer wait
    for a read. Either way the grid reads the same, and the base is never
    written."""
    from vectorsearch_tpu_torch.index.ivf import HostMirror

    base = np.arange(32, dtype=np.int64).reshape(4, 8)  # an eighth: 4 entries
    m = HostMirror(base)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.reset()
        for i in range(4):  # 4 or 8 edits
            m = m.edited(np.full(rows, i), np.arange(rows), -1 - i)
        spans = profiling.snapshot()["spans"]
    assert ("ivf.host_mirror" in spans) == folds
    want = base.copy()
    for i in range(4):
        want[i, :rows] = -1 - i
    assert np.array_equal(m.array(), want)
    assert np.array_equal(base, np.arange(32).reshape(4, 8))
