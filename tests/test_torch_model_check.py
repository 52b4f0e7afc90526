"""Randomized engine model check on the port (tests/test_model_check.py,
both meshes): a seeded sequence of upload / delete / rebuild operations is
checked against a trivial oracle after every phase (live documents are
found first by their own text, deleted ones never surface, the SQL store's
row count equals the index's). The same sequence runs on the JAX engine
(one device, and its 8-device virtual CPU mesh) and on the port's (one
device, and 8 CPU shards), and the two traces must agree: the ids each
upload returns, the counts at every check, and the top hit of every
sampled search.
"""
import numpy as np
import pytest

from test_engine import WordHashAI
from torch_parity import both, small_buckets  # noqa: F401 (autouse fixture)


def _doc(i: int) -> dict:
    # a token set of its own per document: near-orthogonal embeddings
    return {"name": f"d{i}", "document": {"text": f"tok{i}alpha tok{i}beta tok{i}gamma"}}


def run_model_check(P, path, with_mesh):
    rng = np.random.default_rng(7)
    store = P.Store(str(path / f"{P.name}-store.db"))
    engine = P.Engine(
        store, WordHashAI(), cache=P.EngineCache(ttl=0.0),
        snapshot_dir=str(path / f"{P.name}-snaps"), mesh=P.mesh8() if with_mesh else None,
    )
    live: dict[int, int] = {}  # doc index -> document_id
    dead: set[int] = set()
    deleted_ids: set[int] = set()
    trace = []
    next_i = 0

    def check(sample=6):
        cat = store.get_category(store.get_owner("o").id, "c")
        state = engine._state_for(cat.id)
        assert store.count_embeddings(cat.id) == len(live)
        assert state.ivf is None or state.ivf.n_live == len(live)
        trace.append(("count", len(live)))
        idxs = list(live)
        rng.shuffle(idxs)
        for i in idxs[:sample]:
            hits = engine.search("o", "c", f"tok{i}alpha tok{i}beta tok{i}gamma",
                                 count=3, centroids=-1)
            assert hits, f"doc {i} unfindable"
            assert hits[0].document_id == live[i], f"doc {i} not ranked first"
            assert deleted_ids.isdisjoint(h.document_id for h in hits)
            trace.append(("top", i, hits[0].document_id))
        for i in list(dead)[:sample]:
            hits = engine.search("o", "c", f"tok{i}alpha tok{i}beta tok{i}gamma",
                                 count=3, centroids=-1)
            assert deleted_ids.isdisjoint(h.document_id for h in hits)

    for step in range(40):
        op = rng.choice(["upload", "upload", "upload", "delete", "rebuild"])
        if op == "upload" or not live:
            batch = [_doc(next_i + j) for j in range(int(rng.integers(1, 4)))]
            ids = engine.upload("o", "c", batch)
            for j, did in enumerate(ids):
                live[next_i + j] = did
            next_i += len(ids)
            trace.append(("upload", ids))
        elif op == "delete":
            i = int(rng.choice(list(live)))
            engine.delete_document("o", "c", live[i])
            deleted_ids.add(live.pop(i))
            dead.add(i)
            trace.append(("delete", i))
        else:
            cat = store.get_category(store.get_owner("o").id, "c")
            trace.append(("rebuild", engine.refresh_category(cat.id, target_cluster_size=8,
                                                             chunk=64)))
        if step % 8 == 7:
            check()
    check(sample=10)
    # a final rebuild preserves everything exactly
    cat = store.get_category(store.get_owner("o").id, "c")
    engine.refresh_category(cat.id, target_cluster_size=8, chunk=64)
    check(sample=10)
    if with_mesh:
        trace.append(("replica", engine._state_for(cat.id).sharded is not None))
    engine.close()
    store.close()
    return trace


@pytest.mark.parametrize("with_mesh", [False, True], ids=["1dev", "mesh8"])
def test_engine_model_check(tmp_path, with_mesh):
    trace = both(run_model_check, tmp_path, with_mesh)
    assert sum(t[0] == "top" for t in trace) >= 30
