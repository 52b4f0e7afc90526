"""Engine paths of tests/test_engine.py that no other port test held (ROADMAP
queue 1 item 11), each run on the port's Engine and on the JAX package's
with the same store operations, and what each observed compared: pages
(ids and names in order, similarities within 1e-5), ids, row and cluster
counts.

- snapshot staleness: a stale row count, a changed centroid set, equal-count
  churn, a corrupt snapshot file (test_engine.py:282, :414, :446, :470);
- the SQL boot takes stored assignments, no device assignment pass (:618);
- two instances over one store kept in step by sync_with_store (:372);
- deep pagination, single and batched (:503, :742);
- an upload cancelled before it persists (:573; a search cancelled before
  its dispatch is held by test_torch_api.py's
  test_client_disconnect_cancels_engine);
- the configured warmup probe widths and the env override, and a
  malformed override (:321, :313): the port's warmup ignored
  server.warm_nprobes and searched at nprobe 1 only (repaired here).
"""
import glob
import json

import pytest

from test_engine import FRUIT_DOCS, TinyCtxAI, WordHashAI
from torch_parity import both, page, small_buckets  # noqa: F401 (autouse fixture)


def paths(P, tmp_path):
    return str(tmp_path / f"{P.name}.sqlite"), str(tmp_path / f"{P.name}-snaps")


def test_stale_snapshot_rebuilds_from_sql(tmp_path):
    """A snapshot whose row count no longer matches the store is stale at
    boot; the index is rebuilt from SQL."""
    def scenario(P):
        db, snaps = paths(P, tmp_path)
        store = P.Store(db)
        eng = P.Engine(store, WordHashAI(), snapshot_dir=snaps)
        eng.upload("alice", "docs", FRUIT_DOCS[:2])
        eng.close()  # the snapshot holds 2 rows
        # another writer adds a document without snapshotting
        eng_b = P.Engine(store, WordHashAI(), snapshot_dir=None)
        eng_b.upload("alice", "docs", FRUIT_DOCS[2:])
        eng_b.close()
        eng2 = P.Engine(store, WordHashAI(), snapshot_dir=snaps)
        hits = eng2.search("alice", "docs", "gearbox road", count=1, centroids=-1)
        assert hits and hits[0].name == "cars"  # the row missing from the snapshot
        eng2.close()
        store.close()
        return [page(hits)]

    both(scenario)


def test_snapshot_stale_on_centroid_change(tmp_path):
    """A rebuild that changes the centroid set but not the row count
    invalidates the snapshot (its meta records the centroid ids)."""
    def scenario(P):
        db, snaps = paths(P, tmp_path)
        store = P.Store(db)
        eng = P.Engine(store, WordHashAI(), snapshot_dir=snaps)
        eng.upload("alice", "docs", [
            {"name": f"d{i}", "document": {"text": f"w{i % 4} common {i}"}} for i in range(40)])
        eng.close()  # snapshot: 1 bootstrap centroid, 40 rows
        eng_b = P.Engine(store, WordHashAI(), snapshot_dir=None)
        eng_b.refresh_centroids(target_cluster_size=10, chunk=64)
        eng_b.close()
        eng2 = P.Engine(store, WordHashAI(), snapshot_dir=snaps)
        cat = store.get_category(store.get_owner("alice").id, "docs")
        st = eng2._state_for(cat.id, create=False)
        assert st.ivf.k_clusters == len(store.centroids(cat.id)) >= 2
        hits = eng2.search("alice", "docs", "w2 common", count=3, centroids=-1)
        assert hits
        out = [st.ivf.k_clusters, page(hits)]
        eng2.close()
        store.close()
        return out

    both(scenario)


def test_snapshot_stale_on_equal_count_churn(tmp_path):
    """Equal-count churn while the process is down (a delete and an upload)
    invalidates the snapshot through its max-id meta."""
    def scenario(P):
        db, snaps = paths(P, tmp_path)
        store = P.Store(db)
        eng = P.Engine(store, WordHashAI(), snapshot_dir=snaps)
        ids = eng.upload("alice", "docs", FRUIT_DOCS)
        eng.close()
        eng_b = P.Engine(store, WordHashAI(), snapshot_dir=None)
        eng_b.delete_document("alice", "docs", ids[0])
        eng_b.upload("alice", "docs", [{"name": "mango", "document": {"text": "mango tree"}}])
        eng_b.close()
        eng2 = P.Engine(store, WordHashAI(), snapshot_dir=snaps)
        hits = eng2.search("alice", "docs", "mango tree", count=1, centroids=-1)
        assert hits and hits[0].name == "mango"
        eng2.close()
        store.close()
        return [page(hits)]

    both(scenario)


def test_snapshot_corrupt_file_falls_back(tmp_path):
    """A corrupt snapshot file falls back to the SQL boot path."""
    def scenario(P):
        db, snaps = paths(P, tmp_path)
        store = P.Store(db)
        eng = P.Engine(store, WordHashAI(), snapshot_dir=snaps)
        ids = eng.upload("alice", "docs", FRUIT_DOCS)
        eng.close()
        torn = glob.glob(f"{snaps}/*/snap-*.npz")
        assert torn
        for path in torn:
            with open(path, "wb") as f:
                f.write(b"not a zip at all")
        eng2 = P.Engine(store, WordHashAI(), snapshot_dir=snaps)
        hits = eng2.search("alice", "docs", "banana tropical", count=1, centroids=-1)
        assert hits and hits[0].document_id == ids[1]
        eng2.close()
        store.close()
        return [page(hits)]

    both(scenario)


def test_sql_boot_uses_stored_assignments(tmp_path, monkeypatch):
    """The SQL boot takes assignments from the embeddings' centroid_id
    column, not from a device assignment pass."""
    def scenario(P):
        db, _ = paths(P, tmp_path)
        store = P.Store(db)
        eng = P.Engine(store, WordHashAI(), cache=P.EngineCache(ttl=0.0))
        eng.upload("o", "c", FRUIT_DOCS)
        eng.close()

        def forbidden(*a, **kw):
            raise AssertionError("SQL boot ran a device assignment pass")

        with monkeypatch.context() as m:
            m.setattr(P.ivf_mod, "assign_clusters", forbidden)
            eng2 = P.Engine(store, WordHashAI(), cache=P.EngineCache(ttl=0.0))
            hits = eng2.search("o", "c", "banana tropical", count=2)
            assert hits and hits[0].name == "bananas"
            eng2.close()
        store.close()
        return [page(hits)]

    both(scenario)


def test_multi_instance_sync(tmp_path):
    """Two engines over one store: writes from A reach B at
    sync_with_store, including a delete+upload pair that leaves the row
    count and the centroid ids unchanged, and an owner's delete."""
    def scenario(P):
        db, _ = paths(P, tmp_path)
        store_a, store_b = P.Store(db), P.Store(db)
        a = P.Engine(store_a, WordHashAI(), cache=P.EngineCache(ttl=0.0))
        b = P.Engine(store_b, WordHashAI(), cache=P.EngineCache(ttl=0.0))
        ids = a.upload("alice", "docs", FRUIT_DOCS)
        out = [b.search("alice", "docs", "banana tropical"), b.sync_with_store()]
        hits = b.search("alice", "docs", "banana tropical", count=1, centroids=-1)
        assert hits and hits[0].document_id == ids[1]
        out.append(page(hits))
        a.upload("alice", "docs", [{"name": "kiwi", "document": {"text": "kiwi fruit"}}])
        out.append(b.sync_with_store())
        out.append(page(b.search("alice", "docs", "kiwi fruit", count=1, centroids=-1)))
        out.append(b.sync_with_store())  # nothing changed
        a.delete_document("alice", "docs", ids[0])
        a.upload("alice", "docs", [{"name": "mango", "document": {"text": "mango tree"}}])
        out.append(b.sync_with_store())
        out.append(page(b.search("alice", "docs", "mango tree", count=1, centroids=-1)))
        a.delete_owner("alice")
        out.append(b.sync_with_store())
        out.append(b.search("alice", "docs", "kiwi fruit"))
        for e, s in ((a, store_a), (b, store_b)):
            e.close()
            s.close()
        return out

    out = both(scenario)
    assert out[0] == [] and out[1] and out[4][0][2] == "kiwi" and out[5] == []
    assert out[6] and out[7][0][2] == "mango" and out[8] and out[9] == []


def test_deep_pagination_returns_exact_window():
    """Any offset window is exact: with 8 identical sections a document,
    deep windows force the escalating re-dispatch."""
    def scenario(P):
        store = P.Store(":memory:")
        eng = P.Engine(store, TinyCtxAI(), cache=P.EngineCache(ttl=0.0))
        n_docs = 48
        eng.upload("o", "deep", [
            {"name": f"d{i:02d}", "document": {"text": "\n".join([f"word{i:02d} tok{i:02d}"] * 8)}}
            for i in range(n_docs)])
        st = eng._state_for(store.get_category(store.get_owner("o").id, "deep").id, create=False)
        assert st.ivf.n_live >= 8 * n_docs  # the sections really fanned out
        pages = [page(eng.search("o", "deep", "word07 tok07", count=12, offset=offset,
                                 centroids=-1)) for offset in range(0, n_docs, 12)]
        assert [len(p) for p in pages] == [12, 12, 12, 12]
        assert len({n for p in pages for _, _, n in p}) == n_docs  # disjoint, exhaustive
        sims = [s for p in pages for _, s, _ in p]
        assert all(s1 >= s2 - 1e-6 for s1, s2 in zip(sims, sims[1:]))
        eng.close()
        store.close()
        return pages

    both(scenario)


def test_search_many_deep_window_falls_back_to_exact():
    """A batched row whose candidates dedup below the window falls back to
    the escalating window helper, reusing the batched embed."""
    def scenario(P):
        store = P.Store(":memory:")
        eng = P.Engine(store, TinyCtxAI(), cache=P.EngineCache(ttl=0.0))
        eng.upload("o", "c", [
            {"name": f"d{i}",
             "document": {"text": "\n".join(f"melon slice {i} part {j}" for j in range(12))}}
            for i in range(8)])
        eng.ai = WordHashAI()
        window_calls, embed_calls = [], []
        real_window, real_embed = eng._window_hits, eng.ai.embed

        def counting_window(*a, **kw):
            window_calls.append(a)
            return real_window(*a, **kw)

        def counting_embed(texts, model):
            embed_calls.append(list(texts))
            return real_embed(texts, model)

        eng._window_hits, eng.ai.embed = counting_window, counting_embed
        pages = eng.search_many("o", "c", ["melon slice"], count=4, offset=4)
        eng._window_hits, eng.ai.embed = real_window, real_embed
        assert window_calls and len(embed_calls) == 1
        single = eng.search("o", "c", "melon slice", count=4, offset=4)
        assert [h.document_id for h in pages[0]] == [h.document_id for h in single]
        assert len(pages[0]) == 4
        eng.close()
        store.close()
        return [page(pages[0]), page(single)]

    both(scenario)


def test_upload_cancel_aborts_before_persist():
    def scenario(P):
        import threading

        store = P.Store(":memory:")
        eng = P.Engine(store, WordHashAI(), cache=P.EngineCache(ttl=0.0))
        cancel = threading.Event()
        cancel.set()
        with pytest.raises(P.RequestCanceled):
            eng.upload("alice", "docs", FRUIT_DOCS, cancel=cancel)
        out = [eng.fetch_category_names("alice")]  # nothing persisted
        eng.close()
        store.close()
        return out

    assert both(scenario) == [[]]


def test_warmup_config_nprobes(monkeypatch):
    """The config file's warm_nprobes drives warmup; the env overrides it.
    The port's repair: its Engine took no warm_nprobes and warmed at
    nprobe 1 only."""
    def scenario(P):
        cfg = P.config.Config.parse('{"server": {"warm_nprobes": [1, 8]}}')
        assert cfg.server.warm_nprobes == (1, 8)
        # round-trips through to_dict
        again = P.config.Config.parse(json.dumps(cfg.to_dict())).server.warm_nprobes
        store = P.Store(":memory:")
        eng = P.Engine(store, WordHashAI(), warm_nprobes=cfg.server.warm_nprobes)
        eng.upload("alice", "docs", FRUIT_DOCS)
        seen = []
        orig = P.IVFIndex.search

        def spy(self, q, k, nprobe=1, refine=0):
            seen.append(nprobe)
            return orig(self, q, k, nprobe=nprobe, refine=refine)

        with monkeypatch.context() as m:
            m.setattr(P.IVFIndex, "search", spy)
            eng.warmup()
            from_config = set(seen)
            seen.clear()
            m.setenv("VSTPU_WARM_NPROBES", "1")
            eng.warmup()
        out = [again, from_config, set(seen)]
        eng.close()
        store.close()
        return out

    assert both(scenario) == [(1, 8), {1, 8}, {1}]


def test_warmup_malformed_env_degrades(monkeypatch):
    """A malformed VSTPU_WARM_NPROBES degrades to the default with a
    warning; it does not raise out of boot."""
    def scenario(P):
        store = P.Store(":memory:")
        eng = P.Engine(store, WordHashAI(), cache=P.EngineCache(ttl=0.0))
        eng.upload("alice", "docs", FRUIT_DOCS[:1])
        with monkeypatch.context() as m:
            m.setenv("VSTPU_WARM_NPROBES", "1;8")
            eng.warmup()
        hits = eng.search("alice", "docs", "apple orchard", count=1)
        eng.close()
        store.close()
        return [page(hits)]

    both(scenario)
