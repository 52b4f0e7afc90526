"""The port's store (vectorsearch_tpu_torch/store) beside the JAX
package's: the scenarios of tests/test_store.py and
tests/test_remote_store.py on both packages' Store, in memory and on a
file, and the two faults of the JAX store that the port's does not share:

- zstd contexts shared across threads (concurrent round trips must all
  come back equal);
- every query behind the one connection's lock (a read while a rewrite
  transaction is open must return the committed rows within 1 s).
"""
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import vectorsearch_tpu.store as jax_store
import vectorsearch_tpu.store.db as jax_db
import vectorsearch_tpu_torch.store as port_store
import vectorsearch_tpu_torch.store.db as port_db
from vectorsearch_tpu import constants
from vectorsearch_tpu.engine import Engine as JaxEngine
from vectorsearch_tpu.engine import EngineCache as JaxEngineCache
from vectorsearch_tpu.engine import engine as jax_engine_mod
from vectorsearch_tpu_torch import constants as port_constants
from vectorsearch_tpu_torch.engine import Engine, EngineCache
from vectorsearch_tpu_torch.engine import engine as port_engine_mod

from test_engine import WordHashAI

PACKAGES = {
    "jax": SimpleNamespace(
        store=jax_store, db=jax_db, engine_mod=jax_engine_mod,
        engine=lambda s: JaxEngine(s, WordHashAI(), cache=JaxEngineCache(ttl=0.0))),
    "port": SimpleNamespace(
        store=port_store, db=port_db, engine_mod=port_engine_mod,
        engine=lambda s: Engine(s, WordHashAI(), cache=EngineCache(ttl=0.0), device="cpu")),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture(params=["memory", "file"])
def store(request, pkg, tmp_path):
    s = pkg.store.Store(":memory:" if request.param == "memory" else str(tmp_path / "s.db"))
    yield s
    s.close()


@pytest.fixture
def small_buckets(monkeypatch):
    monkeypatch.setattr(constants, "BUCKET_ROUND", 64)
    monkeypatch.setattr(port_constants, "BUCKET_ROUND", 64)


def seed(store):
    o = store.get_or_create_owner("alice")
    c = store.get_or_create_category(o.id, "docs")
    cent = store.create_centroid(c.id, b"\x00" * 16)
    doc_ids = store.insert_documents(
        c.id, [("d1", "x1", {"title": "hello"}), ("d2", "x2", [1, 2, 3])]
    )
    emb_ids = store.insert_embeddings(
        [(b"\x01" * 16, doc_ids[0], cent), (b"\x02" * 16, doc_ids[1], cent)]
    )
    return o, c, cent, doc_ids, emb_ids


# ------------------------------------------- tests/test_store.py scenarios


def test_zstd_roundtrip(pkg):
    raw = b'{"a": 1, "b": [1,2,3]}' * 100
    assert pkg.db.decompress(pkg.db.compress(raw)) == raw
    assert len(pkg.db.compress(raw)) < len(raw)


def test_zstd_bytes_match_jax():
    raw = b'{"text": "the same bytes from either package"}' * 50
    assert port_db.compress(raw) == jax_db.compress(raw)
    assert port_db.decompress(jax_db.compress(raw)) == raw


def test_owner_category_idempotent(store):
    a = store.get_or_create_owner("alice")
    b = store.get_or_create_owner("alice")
    assert a.id == b.id
    c1 = store.get_or_create_category(a.id, "docs")
    c2 = store.get_or_create_category(a.id, "docs")
    assert c1.id == c2.id
    o2 = store.get_or_create_owner("bob")
    c3 = store.get_or_create_category(o2.id, "docs")
    assert c3.id != c1.id


def test_document_json_roundtrip(store):
    _, c, cent, doc_ids, _ = seed(store)
    by_id = {d.id: d for d in store.fetch_documents(doc_ids)}
    assert by_id[doc_ids[0]].document == {"title": "hello"}
    assert by_id[doc_ids[1]].document == [1, 2, 3]
    assert by_id[doc_ids[0]].external_id == "x1"


def test_cascade_owner_delete(store):
    o, c, cent, doc_ids, emb_ids = seed(store)
    store.delete_owner("alice")
    assert store.get_owner("alice") is None
    assert store.fetch_documents(doc_ids) == []
    assert store.centroids(c.id) == []
    assert store.count_embeddings(c.id) == 0


def test_cascade_document_delete(store):
    o, c, cent, doc_ids, emb_ids = seed(store)
    store.delete_document(c.id, doc_ids[0])
    assert store.count_embeddings(c.id) == 1
    assert store.embeddings_for_documents(doc_ids) == [emb_ids[1]]


def test_iter_embeddings_batches(store):
    o = store.get_or_create_owner("o")
    c = store.get_or_create_category(o.id, "c")
    cent = store.create_centroid(c.id, b"\x00")
    doc = store.insert_documents(c.id, [("d", "", {})])[0]
    store.insert_embeddings([(bytes([i]), doc, cent) for i in range(25)])
    batches = list(store.iter_embeddings(c.id, batch=10))
    assert [len(b) for b in batches] == [10, 10, 5]
    seen = [row[0] for b in batches for row in b]
    assert seen == sorted(seen)


def test_replace_centroids_transaction(store):
    o, c, cent_old, doc_ids, emb_ids = seed(store)
    new_ids = store.replace_centroids(
        c.id, [b"\x10" * 16, b"\x20" * 16], {emb_ids[0]: 0, emb_ids[1]: 1},
    )
    rows = store.centroids(c.id)
    assert [r.id for r in rows] == new_ids
    assert rows[0].vector == b"\x10" * 16
    batches = list(store.iter_embeddings(c.id))
    assert len(batches[0]) == 2
    assert sorted(r[3] for r in batches[0]) == sorted(new_ids)


def test_snapshots_roundtrip(pkg, tmp_path):
    snapshots = pkg.store.snapshots
    root = str(tmp_path)
    arrays = {"codes": np.arange(12, dtype=np.int8).reshape(3, 4)}
    assert snapshots.save(root, "cat-1", arrays, {"n": 3}) == 1
    assert snapshots.save(root, "cat-1", arrays, {"n": 4}) == 2
    meta, loaded = snapshots.load(root, "cat-1")
    assert meta == {"n": 4}
    np.testing.assert_array_equal(loaded["codes"], arrays["codes"])
    assert snapshots.load(root, "cat-1", version=1)[0] == {"n": 3}
    snapshots.prune(root, "cat-1", keep=1)
    assert snapshots.load(root, "cat-1", version=1) is None
    assert snapshots.load(root, "cat-1")[0] == {"n": 4}
    snapshots.purge(root, "cat-1")
    assert snapshots.load(root, "cat-1") is None


def test_snapshot_missing_returns_none(pkg, tmp_path):
    assert pkg.store.snapshots.load(str(tmp_path), "nope") is None


def test_snapshots_cross_load(tmp_path):
    """A snapshot written by either package loads in the other."""
    arrays = {"codes": np.arange(24, dtype=np.int8).reshape(4, 6),
              "scale": np.linspace(0, 1, 4, dtype=np.float32)}
    for writer, reader in ((jax_store, port_store), (port_store, jax_store)):
        root = str(tmp_path / writer.__name__)
        writer.snapshots.save(root, "cat", arrays, {"n": 4})
        meta, got = reader.snapshots.load(root, "cat")
        assert meta == {"n": 4}
        for k, v in arrays.items():
            np.testing.assert_array_equal(got[k], v)


# ------------------------------------ tests/test_remote_store.py scenarios


@pytest.fixture
def served_store(pkg, tmp_path):
    local = pkg.store.Store(str(tmp_path / "hostA" / "store.db"))
    server = pkg.store.StoreServer(local).start()
    yield local, server.address
    server.close()
    local.close()


def test_remote_store_api_roundtrip(pkg, served_store):
    _, url = served_store
    remote = pkg.store.RemoteStore(url)
    owner = remote.get_or_create_owner("alice")
    cat = remote.get_or_create_category(owner.id, "docs")
    cent_id = remote.create_centroid(cat.id, b"\x01\x02\x03")
    doc_ids, emb_ids = remote.insert_documents_with_embeddings(
        cat.id, [("doc-a", "ext-1", {"text": "hello", "n": 3})], [[(b"\x09" * 16, cent_id)]],
    )
    assert doc_ids and emb_ids
    docs = remote.fetch_documents(doc_ids)
    assert docs[0].document == {"text": "hello", "n": 3}
    assert docs[0].external_id == "ext-1"
    assert remote.centroids(cat.id)[0].vector == b"\x01\x02\x03"
    assert remote.count_embeddings(cat.id) == 1
    assert remote.max_embedding_id(cat.id) == emb_ids[0]
    assert remote.embedding_doc_map(cat.id) == {emb_ids[0]: doc_ids[0]}
    pages = list(remote.iter_embeddings(cat.id, batch=10))
    assert pages == [[(emb_ids[0], b"\x09" * 16, doc_ids[0], cent_id)]]
    ek, dk = remote.embedding_doc_pairs(cat.id)
    assert ek.tolist() == [emb_ids[0]] and dk.tolist() == [doc_ids[0]]
    with pytest.raises(AttributeError):
        remote.definitely_not_a_method()


def test_remote_build_lock_cross_host(pkg, served_store):
    local, url = served_store
    remote = pkg.store.RemoteStore(url)
    assert remote.try_acquire_build_lock(7, "host-b") is True
    assert local.try_acquire_build_lock(7, "host-a") is False
    remote.release_build_lock(7, "host-b")
    assert local.try_acquire_build_lock(7, "host-a") is True
    local.release_build_lock(7, "host-a")


def test_two_hosts_coordinate_rebuild(pkg, served_store, small_buckets, monkeypatch):
    """Engine A on the served store and engine B on a remote mount: B's
    upload during A's rebuild survives it, B's rebuild is lock-skipped, and
    both serve the same corpus afterwards."""
    local, url = served_store
    a = pkg.engine(local)
    b = pkg.engine(pkg.store.RemoteStore(url))
    a.upload("alice", "docs", [
        {"name": f"d{i}", "document": {"text": f"w{i % 3} base {i}"}} for i in range(30)])
    cat = local.get_category(local.get_owner("alice").id, "docs")
    assert b.sync_with_store() == [cat.id]

    build_started, mid_done = threading.Event(), threading.Event()
    real_build = pkg.engine_mod.build_centroids

    def slow_build(*args, **kw):
        build_started.set()
        assert mid_done.wait(30)
        return real_build(*args, **kw)

    monkeypatch.setattr(pkg.engine_mod, "build_centroids", slow_build)
    t = threading.Thread(
        target=lambda: a.refresh_category(cat.id, target_cluster_size=10, chunk=64))
    t.start()
    assert build_started.wait(30)
    assert b.refresh_category(cat.id, target_cluster_size=10, chunk=64) is False
    mid = b.upload("alice", "docs", [{"name": "bmid", "document": {"text": "remote zebra row"}}])
    mid_done.set()
    t.join(timeout=120)

    assert local.count_embeddings(cat.id) == 31
    a.sync_with_store()
    hits = a.search("alice", "docs", "remote zebra row", count=1, centroids=-1)
    assert hits and hits[0].document_id == mid[0]
    b.sync_with_store()
    assert b.search("alice", "docs", "w1 base 1", count=3, centroids=-1)
    assert b.refresh_category(cat.id, target_cluster_size=10, chunk=64) is True
    a.close()
    b.close()


def test_store_rpc_token_auth(pkg, tmp_path):
    store = pkg.store.Store(str(tmp_path / "s.db"))
    server = pkg.store.StoreServer(store, port=0, token="sekrit").start()
    try:
        with pytest.raises(PermissionError, match="token"):
            pkg.store.RemoteStore(server.address).all_categories()
        with pytest.raises(PermissionError):
            pkg.store.RemoteStore(server.address, token="nope").all_categories()
        good = pkg.store.RemoteStore(server.address, token="sekrit")
        good.get_or_create_owner("o")
        assert good.get_owner("o").name == "o"
    finally:
        server.close()
        store.close()


# --------------------------------------- the faults the port's store repairs


def test_concurrent_zstd_round_trips():
    """16 threads each round-trip 200 distinct payloads through the port's
    compress/decompress at once; every payload comes back equal."""
    n_threads, n_payloads = 16, 200
    start = threading.Barrier(n_threads)
    bad, errors = [], []

    def work(t):
        try:
            start.wait(30)
            for i in range(n_payloads):
                raw = (f'{{"thread": {t}, "payload": {i}, "text": "'.encode()
                       + bytes([(t * 31 + i * 7 + j) % 251 for j in range(64 + i)])
                       + b'"}' * (1 + i % 9))
                if port_db.decompress(port_db.compress(raw)) != raw:
                    bad.append((t, i))
        except Exception as e:  # a shared context raises ZstdError
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert not errors and not bad


def test_concurrent_writes_read_back(tmp_path):
    """16 threads each insert documents and read every one back at once,
    through their own read connections: a committed write is always seen
    by the next read, in any thread."""
    store = port_store.Store(str(tmp_path / "s.db"))
    cat = store.get_or_create_category(store.get_or_create_owner("o").id, "c")
    start = threading.Barrier(16)
    missing, errors = [], []

    def work(t):
        try:
            start.wait(30)
            for i in range(25):
                (doc,) = store.insert_documents(cat.id, [(f"t{t}-{i}", "", {"t": t, "i": i})])
                got = store.fetch_documents([doc])
                if [(d.id, d.document) for d in got] != [(doc, {"t": t, "i": i})]:
                    missing.append((t, i))
        except Exception as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert not errors and not missing
    assert len(store.document_ids_for_category(cat.id)) == 16 * 25
    store.close()


def test_read_during_open_rewrite_sees_committed_rows(tmp_path):
    """On a file-backed store, a write transaction held open on the write
    connection (as replace_centroids holds one while it rewrites a
    category's embeddings) does not hold up fetch_documents in another
    thread: it returns within 1 s with the rows as committed before the
    transaction, and the new state after the commit."""
    store = port_store.Store(str(tmp_path / "s.db"))
    _, c, cent, doc_ids, emb_ids = seed(store)
    new_cent = store.create_centroid(c.id, b"\x07" * 16)
    in_txn, release, done = threading.Event(), threading.Event(), threading.Event()

    def rewrite():
        with store._lock:
            conn = store._conn
            conn.execute("BEGIN IMMEDIATE")
            conn.execute("UPDATE embeddings SET centroid_id=?", (new_cent,))
            conn.execute("UPDATE documents SET name='renamed' WHERE id=?", (doc_ids[0],))
            in_txn.set()
            release.wait(30)
            conn.execute("COMMIT")
        done.set()

    writer = threading.Thread(target=rewrite)
    writer.start()
    try:
        assert in_txn.wait(30)
        got = {}

        def read():
            t0 = time.perf_counter()
            got["docs"] = store.fetch_documents(doc_ids)
            got["s"] = time.perf_counter() - t0

        reader = threading.Thread(target=read)
        reader.start()
        reader.join(1.0)
        assert not reader.is_alive(), "fetch_documents waited on the open transaction"
        assert got["s"] < 1.0
        names = {d.id: d.name for d in got["docs"]}
        assert names == {doc_ids[0]: "d1", doc_ids[1]: "d2"}
    finally:
        release.set()
        writer.join(30)
    assert done.is_set()
    names = {d.id: d.name for d in store.fetch_documents(doc_ids)}
    assert names[doc_ids[0]] == "renamed"
    assert {r[3] for b in store.iter_embeddings(c.id) for r in b} == {new_cent}
    store.close()
