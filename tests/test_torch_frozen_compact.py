"""The frozen-store re-pack on the port (the 3 scenarios of
tests/test_frozen_compact.py): a device budget that holds one copy of the
bucket store and not two freezes the rebuilt index, streaming inserts land
in its spill tail, and crossing COMPACT_MIN_SPILL runs the sequenced
re-pack (`Engine._compact_frozen`: stage the rows on the host, close the
search gate, free the old device buffers, build and upload the new layout,
reopen). Each scenario runs on the port and on the JAX package, and their
row counts and hits must agree.

The port's frees are storage resizes (`IVFIndex.release_device`), so
"freed" is a storage of 0 bytes where JAX asks `is_deleted()`. A fourth
case reaches the budget through VSTPU_HBM_BUDGET_GB (device.hbm_budget),
the deployment's knob, rather than by setting the engine's attribute.
"""
import threading
import time

import pytest

from test_engine import WordHashAI
from torch_parity import JAX, PACKAGES, PORT, both, small_buckets  # noqa: F401


@pytest.fixture(autouse=True)
def small_spill(monkeypatch):
    for P in PACKAGES:
        monkeypatch.setattr(P.engine_mod, "COMPACT_MIN_SPILL", 8)


def _docs(lo, hi):
    return [{"name": f"d{i}", "document": {"text": f"w{i % 5} base row{i}"}}
            for i in range(lo, hi)]


def freed(P, ivf) -> bool:
    codes = ivf.buckets.codes
    return codes.is_deleted() if P is JAX else codes.untyped_storage().size() == 0


def frozen_engine(P):
    """An engine whose one category serves a FROZEN index: the budget, set
    on the engine from the first rebuild's footprint as the JAX test sets
    it, fits one copy of the bucket store, not two."""
    store = P.Store(":memory:")
    eng = P.Engine(store, WordHashAI(), cache=P.EngineCache(ttl=0.0))
    eng.upload("alice", "docs", _docs(0, 120))
    cat = store.get_category(store.get_owner("alice").id, "docs")
    assert eng.refresh_category(cat.id, target_cluster_size=30, chunk=64)
    st = eng._states[cat.id]
    eng._hbm_budget = st.ivf.hbm_bytes + st.ivf.hbm_bytes // 2
    assert eng.refresh_category(cat.id, target_cluster_size=30, chunk=64)
    assert st.ivf.frozen, "budget should freeze the rebuilt store"
    return eng, store, cat, st


def close(eng, store):
    eng.close()
    store.close()


def test_frozen_spill_drains_without_restart():
    def scenario(P):
        eng, store, cat, st = frozen_engine(P)
        old = st.ivf
        n0 = old.n_live
        # inserts on a frozen store land in the spill tail; crossing the
        # trigger re-packs in-process
        eng.upload("alice", "docs", _docs(1000, 1040))
        assert st.ivf is not old, "sequenced re-pack must have swapped"
        assert st.ivf.spill.live == 0, "spill must drain to zero"
        assert st.ivf.n_live == n0 + 40
        assert freed(P, old)  # the budget cannot hold two copies
        a = eng.search("alice", "docs", "w0 base row1005", count=3, centroids=-1)
        b = eng.search("alice", "docs", "w2 base row7", count=3, centroids=-1)
        assert a[0].name == "d1005" and b[0].name == "d7"
        out = [n0, st.ivf.n_live, st.ivf.k_clusters, [h.name for h in a + b]]
        close(eng, store)
        return out

    both(scenario)


def test_searches_stay_correct_through_the_gap(monkeypatch):
    """Concurrent searches during the re-pack block on the gate (never
    read freed buffers) and return correct results throughout."""
    def scenario(P):
        eng, store, cat, st = frozen_engine(P)
        real_build = P.IVFIndex.build

        def slow_build(*args, **kwargs):
            time.sleep(0.3)  # widen the gap so the hammer lands inside it
            return real_build(*args, **kwargs)

        stop = threading.Event()
        errors, served = [], [0]

        def hammer():
            while not stop.is_set():
                try:
                    hits = eng.search("alice", "docs", "w2 base row7", count=3, centroids=-1)
                    assert hits and hits[0].name == "d7"
                    served[0] += 1
                except BaseException as e:  # noqa: BLE001 - collected for the assert
                    errors.append(e)
                    return

        with monkeypatch.context() as m:
            m.setattr(P.IVFIndex, "build", staticmethod(slow_build))
            threads = [threading.Thread(target=hammer) for _ in range(3)]
            for t in threads:
                t.start()
            eng.upload("alice", "docs", _docs(1000, 1040))
            time.sleep(0.2)
            stop.set()
            for t in threads:
                t.join(timeout=30)
        assert not errors, errors
        assert served[0] > 0
        assert st.gate.is_set() and st.inflight == 0
        out = [st.ivf.spill.live, st.ivf.n_live]
        close(eng, store)
        return out

    assert both(scenario) == [0, 160]


def test_failed_repack_degrades_not_poisons(monkeypatch):
    """A rebuild that fails after the old buffers are freed leaves the
    category with no index (reload from SQL), never an index whose device
    buffers are gone."""
    def scenario(P):
        eng, store, cat, st = frozen_engine(P)

        def boom(*args, **kwargs):
            raise RuntimeError("injected build failure")

        with monkeypatch.context() as m:
            m.setattr(P.IVFIndex, "build", staticmethod(boom))
            # the upload succeeds (rows are in SQL and the spill before the
            # maintenance step); the compaction failure is contained
            ids = eng.upload("alice", "docs", _docs(1000, 1040))
        assert len(ids) == 40
        assert st.ivf is None and st.gate.is_set()
        eng.sync_with_store(cat.id)
        assert st.ivf is not None and st.ivf.n_live == 160
        hits = eng.search("alice", "docs", "w0 base row1005", count=3, centroids=-1)
        assert hits and hits[0].name == "d1005"
        out = [ids, st.ivf.n_live, [h.name for h in hits]]
        close(eng, store)
        return out

    both(scenario)


def test_budget_from_the_environment_freezes_and_repacks(monkeypatch):
    """VSTPU_HBM_BUDGET_GB sized to one and a half copies of the first
    rebuild's store: an engine booted under it (the port's
    device.hbm_budget reads it, as JAX's _device_hbm_budget does) freezes
    its next rebuild and drains the spill by the sequenced re-pack."""
    def scenario(P):
        probe, store, cat, st = frozen_engine(P)  # measures the footprint
        gb = (st.ivf.hbm_bytes + st.ivf.hbm_bytes // 2) / 2**30
        probe.close()
        with monkeypatch.context() as m:
            m.setenv("VSTPU_HBM_BUDGET_GB", repr(gb))
            eng = P.Engine(store, WordHashAI(), cache=P.EngineCache(ttl=0.0))
        assert eng._hbm_budget == int(gb * 2**30)
        assert eng.refresh_category(cat.id, target_cluster_size=30, chunk=64)
        st = eng._states[cat.id]
        assert st.ivf.frozen
        old = st.ivf
        eng.upload("alice", "docs", _docs(1000, 1040))
        assert st.ivf is not old and freed(P, old) and st.ivf.spill.live == 0
        out = [st.ivf.n_live, st.ivf.frozen]
        close(eng, store)
        return out

    assert both(scenario)[0] == 160


def test_release_device_frees_every_buffer_after_an_insert():
    """The port's repair behind the scenarios above: on the CPU,
    device.to_device handed back a view of the caller's numpy array, so an
    inserted index's counts_dev (uploaded from the host counts) had a
    storage that cannot be resized. release_device then raised after it had
    already freed the bucket store, and the frozen re-pack left the old,
    half-freed index installed. Every buffer now owns its memory."""
    import numpy as np

    from vectorsearch_tpu_torch.quant import layout

    v = np.random.default_rng(0).normal(size=(300, 32)).astype(np.float32)
    ivf = PORT.IVFIndex.build(layout.pack_float(v), np.arange(300), v[:4], device="cpu")
    ivf = ivf.insert(layout.pack_float(v[:5]), np.arange(1000, 1005))
    tensors = (*ivf.buckets, ivf.bucket_mask, ivf.counts_dev, *ivf.spill.packed, ivf.spill.mask)
    assert all(t.untyped_storage().resizable() for t in tensors)
    ivf.release_device()
    assert all(t.untyped_storage().size() == 0 for t in tensors)
