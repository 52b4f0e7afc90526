"""Race-safety on the port (the 14 scenarios of tests/test_concurrency.py),
each run on the port's engine, store and caches and on the JAX package's,
with what each run observed compared across the two: row counts, the ids
uploads return, the hits of searches after a race, the batcher's and the
upload coalescer's counts.

The rebuild races are where the port's store differs from the JAX one: a
file-backed store reads on a connection per thread, outside the write lock
(store/db.py `_read`). Monkeypatch targets are each package's own
(`engine_mod.build_centroids`, `IVFIndex.insert`,
`Engine._process_upload_batch`).
"""
import threading
import time

import numpy as np
import pytest

from test_engine import WordHashAI
from torch_parity import JAX, PORT, both, small_buckets  # noqa: F401 (autouse fixture)


def docs(n, fmt="w{m} base {i}", mod=3):
    return [{"name": f"d{i}", "document": {"text": fmt.format(m=i % mod, i=i)}}
            for i in range(n)]


def test_concurrent_upload_and_search():
    def scenario(P):
        store = P.Store(":memory:")
        eng = P.Engine(store, WordHashAI(), cache=P.EngineCache(ttl=0.0))
        errors = []
        # the searchers start once the category exists: the owner and
        # category creation race of an upload that joins a search's miss
        # is held deterministically by test_upload_joining_a_search_miss
        created = threading.Event()

        def uploader(tag):
            try:
                for i in range(5):
                    eng.upload("alice", "docs", [
                        {"name": f"{tag}-{i}", "document": {"text": f"topic{tag} item {i}"}}])
                    created.set()
            except Exception as e:  # pragma: no cover
                errors.append(e)
            finally:
                created.set()

        def searcher():
            try:
                assert created.wait(30)
                for _ in range(10):
                    eng.search("alice", "docs", "topic1 item", count=3)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=uploader, args=(t,)) for t in range(3)]
        threads += [threading.Thread(target=searcher) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        hits = eng.search("alice", "docs", "topic2 item", count=5)
        assert hits
        cat = store.get_category(store.get_owner("alice").id, "docs")
        ids = store.document_ids_for_category(cat.id)
        names = sorted(d.name for d in store.fetch_documents(ids))
        out = (len(ids), store.count_embeddings(cat.id), names,
               sorted(h.name for h in hits))
        eng.close()
        store.close()
        return out

    n_docs, n_emb, names, _ = both(scenario)
    assert n_docs == n_emb == 15 and len(set(names)) == 15


class _JoinSignal(threading.Event):
    """A flight's event that reports each waiter as it starts to wait."""

    def __init__(self, joined):
        super().__init__()
        self.joined = joined

    def wait(self, timeout=None):
        self.joined.set()
        return super().wait(timeout)


@pytest.mark.parametrize("row", ["owner", "category"])
def test_upload_joining_a_search_miss(row):
    """A search misses the owner (or the category: the owner exists) and
    its read is held while an upload of the same name arrives and waits on
    the search's single flight of that key. The port's upload runs its own
    get_or_create and creates the row; the JAX package's upload is handed
    the search's None and raises AttributeError at `.id` (the reference
    fault, documented: vectorsearch_tpu/engine/cache.py:49-54)."""
    def scenario(P):
        store = P.Store(":memory:")
        eng = P.Engine(store, WordHashAI(), cache=P.EngineCache(ttl=60.0))
        if row == "category":
            store.get_or_create_owner("alice")
        cache = eng.cache.owners if row == "owner" else eng.cache.categories
        read = store.get_owner if row == "owner" else store.get_category
        in_read, release, joined = threading.Event(), threading.Event(), threading.Event()

        def held_read(*a):
            in_read.set()
            assert release.wait(30)
            return read(*a)

        setattr(store, read.__name__, held_read)
        found, uploaded = [], []
        search = threading.Thread(target=lambda: found.append(
            eng.search("alice", "docs", "alpha words", count=3)))
        search.start()
        assert in_read.wait(30)
        (flight,) = cache._inflight.values()
        flight.event = _JoinSignal(joined)

        def upload():
            try:
                uploaded.append(eng.upload("alice", "docs", [
                    {"name": "a", "document": {"text": "alpha words"}}]))
            except Exception as e:
                uploaded.append(e)

        up = threading.Thread(target=upload)
        up.start()
        assert joined.wait(30), "the upload did not join the search's flight"
        release.set()
        for t in (search, up):
            t.join(30)
            assert not t.is_alive()
        setattr(store, read.__name__, read)
        out = {"search": found, "upload": uploaded[0]}
        if not isinstance(uploaded[0], Exception):
            out["hits"] = [h.document_id for h in eng.search("alice", "docs", "alpha words")]
        eng.close()
        store.close()
        return out

    port = scenario(PORT)
    assert port == {"search": [[]], "upload": [1], "hits": [1]}
    jax = scenario(JAX)
    assert jax["search"] == [[]]
    assert isinstance(jax["upload"], AttributeError)
    assert "'NoneType' object has no attribute 'id'" in str(jax["upload"])


def test_build_lock_contention(tmp_path):
    def scenario(P, path):
        store = P.Store(str(path / f"{P.name}.sqlite"))
        eng = P.Engine(store, WordHashAI())
        eng.upload("alice", "docs", docs(30, "w{m} x {i}"))
        cat = store.get_category(store.get_owner("alice").id, "docs")
        # another instance holds the DB lock -> refresh skips (not retried)
        assert store.try_acquire_build_lock(cat.id, "other-instance")
        out = [eng.refresh_category(cat.id, target_cluster_size=10, chunk=64)]
        store.release_build_lock(cat.id, "other-instance")
        out.append(eng.refresh_category(cat.id, target_cluster_size=10, chunk=64))
        out.append(len(store.centroids(cat.id)))
        eng.close()
        store.close()
        return out

    assert both(scenario, tmp_path)[:2] == [False, True]


def test_build_lock_stale_expiry(tmp_path):
    def scenario(P, path):
        store = P.Store(str(path / f"{P.name}.sqlite"))
        out = [store.try_acquire_build_lock(1, "a"), store.try_acquire_build_lock(1, "b")]
        # a crashed holder: the lock aged past the stale window
        with store._lock, store._conn:
            store._conn.execute("UPDATE build_locks SET acquired_at=?",
                                (time.time() - P.db.BUILD_LOCK_STALE_S - 1,))
        out.append(store.try_acquire_build_lock(1, "b"))
        store.close()
        return out

    assert both(scenario, tmp_path) == [True, False, True]


def test_singleflight_one_loader_call():
    def scenario(P):
        cache = P.TTLCache(ttl=60)
        calls, results = [], []
        gate = threading.Event()

        def loader():
            calls.append(1)
            gate.wait(1)
            return "value"

        def worker():
            results.append(cache.get_or_load("k", loader))

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        gate.set()
        for t in threads:
            t.join()
        return len(calls), results

    assert both(scenario) == (1, ["value"] * 8)


def test_singleflight_error_propagates_then_recovers():
    def scenario(P):
        cache = P.TTLCache(ttl=60)
        state = {"fail": True}

        def loader():
            if state["fail"]:
                raise RuntimeError("boom")
            return 42

        with pytest.raises(RuntimeError, match="boom"):
            cache.get_or_load("k", loader)
        state["fail"] = False
        return cache.get_or_load("k", loader)

    assert both(scenario) == 42


def slow_build_until(P, monkeypatch, release):
    """Patch P's engine_mod.build_centroids to signal its start and wait
    for `release` before building; returns the start event."""
    started = threading.Event()
    real = P.engine_mod.build_centroids

    def slow_build(*a, **kw):
        started.set()
        assert release.wait(30)
        return real(*a, **kw)

    monkeypatch.setattr(P.engine_mod, "build_centroids", slow_build)
    return started


def test_upload_during_rebuild_survives(monkeypatch):
    """A document uploaded while the k-means build runs survives the
    centroid swap in SQL and in the device index."""
    def scenario(P):
        store = P.Store(":memory:")
        eng = P.Engine(store, WordHashAI(), cache=P.EngineCache(ttl=0.0))
        eng.upload("alice", "docs", docs(30))
        cat = store.get_category(store.get_owner("alice").id, "docs")
        upload_done = threading.Event()
        result = {}
        with monkeypatch.context() as m:
            started = slow_build_until(P, m, upload_done)
            t = threading.Thread(target=lambda: result.update(
                ok=eng.refresh_category(cat.id, target_cluster_size=10, chunk=64)))
            t.start()
            assert started.wait(30)
            mid = eng.upload("alice", "docs", [
                {"name": "mid", "document": {"text": "midbuild zebra unique"}}])
            upload_done.set()
            t.join(timeout=60)
        assert result.get("ok") is True
        assert store.embeddings_for_documents(mid) != []
        hits = eng.search("alice", "docs", "midbuild zebra unique", count=1, centroids=-1)
        assert hits and hits[0].document_id == mid[0]
        out = [mid, store.count_embeddings(cat.id), len(store.centroids(cat.id))]
        eng.delete_document("alice", "docs", mid[0])
        hits = eng.search("alice", "docs", "midbuild zebra unique", count=1, centroids=-1)
        assert not hits or hits[0].document_id != mid[0]
        eng.close()
        store.close()
        return out

    assert both(scenario)[1] == 31


def test_delete_during_rebuild_stays_deleted(monkeypatch):
    """A document deleted while the build runs stays deleted after the
    swap (the rebuilt index was packed from the pre-delete snapshot)."""
    def scenario(P):
        store = P.Store(":memory:")
        eng = P.Engine(store, WordHashAI(), cache=P.EngineCache(ttl=0.0))
        ids = eng.upload("alice", "docs", docs(30))
        cat = store.get_category(store.get_owner("alice").id, "docs")
        delete_done = threading.Event()
        with monkeypatch.context() as m:
            started = slow_build_until(P, m, delete_done)
            t = threading.Thread(target=lambda: eng.refresh_category(
                cat.id, target_cluster_size=10, chunk=64))
            t.start()
            assert started.wait(30)
            eng.delete_document("alice", "docs", ids[0])
            delete_done.set()
            t.join(timeout=60)
        hits = eng.search("alice", "docs", "w0 base 0", count=5, centroids=-1)
        assert all(h.document_id != ids[0] for h in hits)
        out = [store.count_embeddings(cat.id), [h.document_id for h in hits]]
        eng.close()
        store.close()
        return out

    assert both(scenario)[0] == 29


def test_cross_instance_upload_during_rebuild(monkeypatch, tmp_path):
    """Instance B uploads to the shared store while instance A's rebuild
    runs: B's embeddings survive A's centroid swap."""
    def scenario(P):
        db = str(tmp_path / f"{P.name}-shared.sqlite")
        store_a, store_b = P.Store(db), P.Store(db)
        a = P.Engine(store_a, WordHashAI(), cache=P.EngineCache(ttl=0.0))
        b = P.Engine(store_b, WordHashAI(), cache=P.EngineCache(ttl=0.0))
        a.upload("alice", "docs", docs(30))
        cat = store_a.get_category(store_a.get_owner("alice").id, "docs")
        b.sync_with_store()
        upload_done = threading.Event()
        with monkeypatch.context() as m:
            started = slow_build_until(P, m, upload_done)
            t = threading.Thread(target=lambda: a.refresh_category(
                cat.id, target_cluster_size=10, chunk=64))
            t.start()
            assert started.wait(30)
            # B writes through the shared store mid-build (A cannot see it)
            mid = b.upload("alice", "docs", [
                {"name": "bmid", "document": {"text": "remote zebra row"}}])
            upload_done.set()
            t.join(timeout=60)
        assert store_a.embeddings_for_documents(mid) != []
        a.sync_with_store()
        hits = a.search("alice", "docs", "remote zebra row", count=1, centroids=-1)
        assert hits and hits[0].document_id == mid[0]
        out = [mid, store_a.count_embeddings(cat.id)]
        for e, s in ((a, store_a), (b, store_b)):
            e.close()
            s.close()
        return out

    assert both(scenario)[1] == 31


def test_query_batcher_coalesces_and_is_correct():
    """Concurrent searches over one snapshot coalesce into fewer device
    dispatches and return the hits of serial searches."""
    def scenario(P):
        store = P.Store(":memory:")
        eng = P.Engine(store, WordHashAI(), cache=P.EngineCache(ttl=60.0))
        eng.upload("alice", "docs", docs(40, "topic{m} word {i}", mod=7))
        expected = {
            t: [h.document_id for h in eng.search("alice", "docs", f"topic{t} word", count=3)]
            for t in range(7)
        }
        base = eng._batcher.stats()
        results, errors = {}, []
        start = threading.Barrier(28)

        def worker(i):
            t = i % 7
            try:
                start.wait(5)
                hits = eng.search("alice", "docs", f"topic{t} word", count=3)
                results[i] = (t, [h.document_id for h in hits])
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(28)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errors
        for t, got in results.values():
            assert got == expected[t]
        after = eng._batcher.stats()
        rows = after["rows_served"] - base["rows_served"]
        assert after["dispatches"] - base["dispatches"] < rows
        eng.close()
        store.close()
        return expected, rows

    assert both(scenario)[1] == 28


def test_query_batcher_error_propagates():
    def scenario(P):
        b = P.QueryBatcher()

        def boom(q):
            raise RuntimeError("kernel failed")

        with pytest.raises(RuntimeError, match="kernel failed"):
            b.submit(("k",), object(), np.zeros(4, np.float32), boom)
        # the batcher recovers for the next dispatch
        s, i = b.submit(
            ("k2",), object(), np.zeros(4, np.float32),
            lambda q: (np.ones((len(q), 2)), np.zeros((len(q), 2), np.int64)),
        )
        return s.tolist(), i.tolist()

    assert both(scenario) == ([1.0, 1.0], [0, 0])


def queue_uploads_behind_lock(eng, state, names, one):
    """Hold state.lock so the first arrival (the leader) blocks, start one
    upload thread per name, wait until all are queued, release."""
    state.lock.acquire()
    try:
        threads = [threading.Thread(target=one, args=(nm,)) for nm in names]
        for t in threads:
            t.start()
        deadline = time.time() + 10
        while len(state.upload_queue) < len(names) and time.time() < deadline:
            time.sleep(0.01)
        queued = len(state.upload_queue)
    finally:
        state.lock.release()
    for t in threads:
        t.join(timeout=30)
    return queued


def seeded_engine(P):
    store = P.Store(":memory:")
    eng = P.Engine(store, WordHashAI(), cache=P.EngineCache(ttl=0.0))
    eng.upload("o", "c", [{"name": "seed", "document": {"text": "seed row"}}])
    cat = store.get_category(store.get_owner("o").id, "c")
    return store, eng, cat, eng._state_for(cat.id, create=False)


def test_upload_coalescing_deterministic():
    """Concurrent uploads to one category share one assign dispatch and one
    index insert: all queued requests land in ONE batch."""
    def scenario(P):
        store, eng, cat, state = seeded_engine(P)
        base = eng._upload_batches
        results, errors = {}, []

        def one(i):
            try:
                results[i] = eng.upload("o", "c", [
                    {"name": f"t{i}", "document": {"text": f"coal tok{i}"}}])
            except BaseException as e:  # pragma: no cover
                errors.append(e)

        assert queue_uploads_behind_lock(eng, state, range(6), one) == 6
        assert not errors and len(results) == 6
        ids = [i for r in results.values() for i in r]
        assert len(set(ids)) == 6
        batches = eng._upload_batches - base
        for i in range(6):
            hits = eng.search("o", "c", f"coal tok{i}", count=1, centroids=-1)
            assert hits and hits[0].document_id == results[i][0]
        eng.close()
        store.close()
        return batches, sorted(ids)

    assert both(scenario)[0] == 1


def test_upload_batch_failure_isolated():
    """A request whose SQL transaction fails does not fail its batch
    siblings (per-request transactions inside the coalesced batch)."""
    def scenario(P):
        store, eng, cat, state = seeded_engine(P)
        real_insert = store.insert_documents_with_embeddings

        def poisoned(category_id, doc_rows, embeddings_per_doc):
            if any(name == "bad" for name, _, _ in doc_rows):
                raise RuntimeError("injected SQL failure")
            return real_insert(category_id, doc_rows, embeddings_per_doc)

        store.insert_documents_with_embeddings = poisoned
        results, errors = {}, {}

        def one(name):
            try:
                results[name] = eng.upload("o", "c", [
                    {"name": name, "document": {"text": f"tok {name}"}}])
            except BaseException as e:
                errors[name] = e

        queue_uploads_behind_lock(eng, state, ("good1", "bad", "good2"), one)
        store.insert_documents_with_embeddings = real_insert
        assert set(errors) == {"bad"} and "injected" in str(errors["bad"])
        assert set(results) == {"good1", "good2"}
        for nm in ("good1", "good2"):
            hits = eng.search("o", "c", f"tok {nm}", count=1, centroids=-1)
            assert hits and hits[0].document_id == results[nm][0]
        out = store.count_embeddings(cat.id)  # seed + good1 + good2
        eng.close()
        store.close()
        return out

    assert both(scenario) == 3


def test_upload_batch_insert_failure_fails_all(monkeypatch):
    """The shared device insert throwing after the per-request SQL commits:
    the error surfaces and the committed rows are rolled back, so a retry
    leaves exactly one copy."""
    def scenario(P):
        store, eng, cat, state = seeded_engine(P)
        n_before = state.ivf.n_live

        def exploding(self, *a, **kw):
            raise RuntimeError("injected insert failure")

        with monkeypatch.context() as m:
            m.setattr(P.IVFIndex, "insert", exploding)
            with pytest.raises(RuntimeError, match="injected insert"):
                eng.upload("o", "c", [{"name": "x", "document": {"text": "boom row"}}])
        assert state.ivf.n_live == n_before  # nothing reached the device
        assert store.count_embeddings(cat.id) == n_before
        assert eng.sync_with_store() == []  # nothing diverged, nothing to heal
        eng.upload("o", "c", [{"name": "x", "document": {"text": "boom row"}}])
        hits = eng.search("o", "c", "boom row", count=5, centroids=-1)
        assert [h.name for h in hits].count("x") == 1
        out = [n_before, [h.name for h in hits]]
        eng.close()
        store.close()
        return out

    both(scenario)


def test_upload_batch_failure_raises_fresh_exception_per_waiter(monkeypatch):
    """Every waiter of a failed batch gets its own exception instance,
    chained to the one underlying cause."""
    def scenario(P):
        store, eng, cat, state = seeded_engine(P)
        start = threading.Barrier(3)
        real_process = P.EngineClass._process_upload_batch

        def exploding(self, *a, **kw):
            raise RuntimeError("injected insert failure")

        def slow_batch(self2, st, cid, jobs):
            time.sleep(0.2)  # let followers queue behind the leader
            return real_process(self2, st, cid, jobs)

        errors = {}

        def worker(name):
            start.wait()
            try:
                eng.upload("o", "c", [{"name": name, "document": {"text": name}}])
            except Exception as e:
                errors[name] = e

        with monkeypatch.context() as m:
            m.setattr(P.IVFIndex, "insert", exploding)
            m.setattr(P.EngineClass, "_process_upload_batch", slow_batch)
            threads = [threading.Thread(target=worker, args=(f"w{i}",)) for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        insts = list(errors.values())
        assert len(insts) == 3
        assert all(isinstance(e, P.UploadError) for e in insts)
        assert len({id(e) for e in insts}) == 3  # distinct instances
        assert all(isinstance(e.__cause__, RuntimeError) for e in insts)
        out = [sorted(errors), store.count_embeddings(cat.id)]
        eng.close()
        store.close()
        return out

    assert both(scenario) == [["w0", "w1", "w2"], 1]


def test_batcher_coalesces_while_a_dispatch_holds_the_interpreter():
    """The port's repair: 16 callers released together, each dispatch a
    Python loop that keeps the interpreter. The batch leader yields once
    before it closes its batch, so the callers coalesce; without that
    yield each ran alone (28 dispatches for 28 rows in
    test_query_batcher_coalesces_and_is_correct on the CPU, where JAX's
    jitted dispatch lets the interpreter go and its rows coalesce)."""
    from vectorsearch_tpu_torch.engine.batcher import QueryBatcher

    b = QueryBatcher()
    start = threading.Barrier(16)
    snapshot = object()

    def run(q):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.002:
            pass
        return q[:, :2] * 2, np.zeros((len(q), 2), np.int64)

    def worker(i):
        start.wait(5)
        s, _ = b.submit(("k",), snapshot, np.full(4, i, np.float32), run)
        assert s.tolist() == [2.0 * i, 2.0 * i]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stats = b.stats()
    assert stats["rows_served"] == 16 and stats["dispatches"] < 16
