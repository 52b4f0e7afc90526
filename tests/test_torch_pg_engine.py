"""Engines sharing one Postgres, on the port (the 3 scenarios of
tests/test_pg_engine.py): the port's PgStore against a mock Postgres
(tests/pg_mock.py) that answers from a real sqlite database, and two port
Engines on two connections to it, as two application hosts. Each scenario
also runs on the JAX package, against a mock of its own, and the ids, row
counts, lock outcomes and hits the two observed must agree.
"""
import threading

import pytest

from pg_mock import MockPg, SqliteBackend
from test_engine import WordHashAI
from torch_parity import both, small_buckets  # noqa: F401 (autouse fixture)


@pytest.fixture
def shared_pg():
    """One mock Postgres a package, answering from a real sqlite database."""
    made = {}

    def get(P):
        made.setdefault(P.name, MockPg(backend=SqliteBackend()))
        return made[P.name]

    yield get
    for m in made.values():
        m.close()


def test_pgstore_real_sql_roundtrip(shared_pg):
    """The sqlite-backed mock carries the whole Store surface."""
    def scenario(P):
        store = P.PgStore([shared_pg(P).dsn])
        owner = store.get_or_create_owner("alice")
        assert store.get_or_create_owner("alice").id == owner.id  # idempotent
        cat = store.get_or_create_category(owner.id, "docs")
        cent_id = store.create_centroid(cat.id, b"\x01\x02\x03")
        doc_ids, emb_ids = store.insert_documents_with_embeddings(
            cat.id, [("doc-a", "ext-1", {"text": "hello", "n": 3})],
            [[(b"\x09" * 16, cent_id)]])
        docs = store.fetch_documents(doc_ids)
        out = [doc_ids, emb_ids, docs[0].document, docs[0].external_id,
               store.centroids(cat.id)[0].vector, store.count_embeddings(cat.id),
               store.max_embedding_id(cat.id), store.embedding_doc_map(cat.id),
               list(store.iter_embeddings(cat.id, batch=10))]
        # replace_centroids runs the VALUES-join UPDATE translation
        new_ids = store.replace_centroids(cat.id, [b"\x05\x06"], {emb_ids[0]: 0})
        assert [c.id for c in store.centroids(cat.id)] == new_ids
        out += [new_ids, store.embedding_doc_map(cat.id)]
        store.delete_document(cat.id, doc_ids[0])  # cascades to the embeddings
        out.append(store.count_embeddings(cat.id))
        store.close()
        return out

    out = both(scenario)
    assert out[2] == {"text": "hello", "n": 3} and out[8] == [[(out[1][0], b"\x09" * 16,
                                                                out[0][0], 1)]]
    assert out[-1] == 0


def test_build_lock_contention_across_stores(shared_pg):
    """Two stores (two application hosts) contend on the SQL build lock:
    exactly one wins until it releases."""
    def scenario(P):
        a = P.PgStore([shared_pg(P).dsn])
        b = P.PgStore([shared_pg(P).dsn], migrate=False)
        out = [a.try_acquire_build_lock(7, "host-a"), b.try_acquire_build_lock(7, "host-b")]
        a.release_build_lock(7, "host-a")
        out.append(b.try_acquire_build_lock(7, "host-b"))
        b.release_build_lock(7, "host-b")
        a.close()
        b.close()
        return out

    assert both(scenario) == [True, False, True]


def test_two_engines_share_pgstore(shared_pg, monkeypatch):
    """Engine A uploads; engine B (another PgStore connection, another
    host) syncs and serves the rows. A's rebuild holds the SQL lock: B's
    rebuild meanwhile is skipped, and B's upload during it survives the
    swap."""
    def scenario(P):
        dsn = shared_pg(P).dsn
        a = P.Engine(P.PgStore([dsn]), WordHashAI(), cache=P.EngineCache(ttl=0.0))
        b = P.Engine(P.PgStore([dsn], migrate=False), WordHashAI(),
                     cache=P.EngineCache(ttl=0.0))
        a.upload("alice", "docs", [{"name": f"d{i}", "document": {"text": f"w{i % 3} base {i}"}}
                                   for i in range(30)])
        cat = a.store.get_category(a.store.get_owner("alice").id, "docs")
        out = [b.sync_with_store()]
        hits = b.search("alice", "docs", "w1 base 1", count=3, centroids=-1)
        assert hits
        out.append([h.document_id for h in hits])

        started, mid_done = threading.Event(), threading.Event()
        real_build = P.engine_mod.build_centroids

        def slow_build(*args, **kw):
            started.set()
            assert mid_done.wait(30)
            return real_build(*args, **kw)

        with monkeypatch.context() as m:
            m.setattr(P.engine_mod, "build_centroids", slow_build)
            t = threading.Thread(target=lambda: a.refresh_category(
                cat.id, target_cluster_size=10, chunk=64))
            t.start()
            assert started.wait(30)
            # exactly one rebuild wins: B is lock-skipped while A builds
            out.append(b.refresh_category(cat.id, target_cluster_size=10, chunk=64))
            mid = b.upload("alice", "docs", [
                {"name": "bmid", "document": {"text": "remote zebra row"}}])
            mid_done.set()
            t.join(timeout=120)
        out.append(a.store.count_embeddings(cat.id))
        a.sync_with_store()
        hits = a.search("alice", "docs", "remote zebra row", count=1, centroids=-1)
        assert hits and hits[0].document_id == mid[0]
        b.sync_with_store()
        assert b.search("alice", "docs", "w1 base 1", count=3, centroids=-1)
        out.append(b.refresh_category(cat.id, target_cluster_size=10, chunk=64))
        out.append(mid)
        a.close()
        b.close()
        return out

    out = both(scenario)
    assert out[0] == [1] and out[2] is False and out[3] == 31 and out[4] is True
