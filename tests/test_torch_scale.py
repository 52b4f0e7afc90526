"""The port's scale checks (vectorsearch_tpu_torch/tools) at a small N on
the CPU: 20,000 rows of D=768 from 16 generating centers, a store in
tmp_path. The corpus recipe and the exact truth against numpy; the index's
recall against the floors; one SQLite store populated by the tool and
booted by the JAX package's Engine and by the port's, whose top-10 sets
agree but at ties (torch_parity's tolerance); the port's cold and warm
boots alike; the engine check end to end (uploads find themselves, deletes
never return); both tools' main() printing their JSON line; and
chip_smoke.py's 1M corpus against bench.py's."""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from vectorsearch_tpu.engine import Engine as JaxEngine
from vectorsearch_tpu.store import Store as JaxStore
from vectorsearch_tpu_torch.device import upload_packed
from vectorsearch_tpu_torch.engine import Engine
from vectorsearch_tpu_torch.quant import layout
from vectorsearch_tpu_torch.store import Store
from vectorsearch_tpu_torch.tools import bench_10m_serving as bs
from vectorsearch_tpu_torch.tools import engine_10m_check as ec
from vectorsearch_tpu_torch.tools import scale_corpus as sc
from torch_parity import ATOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, K = 20_000, 16
CPU = torch.device("cpu")
# recall@10 floors of the 1M and 10M cells (chip_smoke.py)
FLOORS = {1: 0.94, 8: 0.96, 64: 0.96}


@pytest.fixture(scope="module")
def corpus():
    torch.set_num_threads(2)
    packed = sc.packed_host(CPU, N, sc.DIM, K, seed=0)
    queries = sc.make_queries(packed)
    truth = sc.exact_truth(queries, CPU, N, sc.DIM, K, seed=0)
    return packed, queries, truth, sc.build(packed, CPU, k=K)


@pytest.fixture
def small_runs(monkeypatch):
    """The tools' timed loops and HTTP load cut to a few requests."""
    monkeypatch.setattr(bs, "BULK_BATCHES", (1024,))
    monkeypatch.setattr(bs, "REPS", 1)
    monkeypatch.setattr(ec, "THREADS", 4)
    monkeypatch.setattr(ec, "PER_THREAD", 3)
    monkeypatch.setattr(ec, "BATCH_REPS", (("ids", 1, False), ("docs", 1, True)))


def test_rows_queries_and_truth(corpus):
    """The packed rows are the original rows' codec packing, the queries
    bench_10m_serving's recipe, and the truth the exact cosine top-10 over
    the original rows (numpy, f64)."""
    packed, queries, truth, _ = corpus
    rows = np.concatenate([v.numpy() for _, v in sc.regen_slabs(CPU, N, sc.DIM, K, seed=0)])
    want = layout.pack_float(rows)
    for got, exp in zip(packed[:3], want[:3]):
        np.testing.assert_array_equal(got, exp)
    np.testing.assert_allclose(packed.inv_norm, want.inv_norm, rtol=1e-6)
    rng = np.random.default_rng(123)
    idx = np.sort(rng.choice(N, size=sc.N_QUERIES, replace=False))
    noise = rng.normal(size=(sc.N_QUERIES, sc.DIM)).astype(np.float32) * np.float32(0.1)
    np.testing.assert_array_equal(queries, layout.unpack(layout.take(packed, idx)) + noise)
    rn = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    sims = qn.astype(np.float64) @ rn.T.astype(np.float64)
    want_i = np.argsort(-sims, axis=1)[:, : sc.TOPK]
    want_s = np.take_along_axis(sims, want_i, 1)
    got_s = np.take_along_axis(sims, truth, 1)
    assert sc.sets_differ(got_s, truth, want_s, want_i, 1e-6) == 0


def test_index_recall_clears_the_floors(corpus, small_runs):
    packed, queries, truth, result = corpus
    queries, truth = queries[:128], truth[:128]
    rows, facts, _ = bs.index_rows(packed, result.centroids, result.assignments, queries,
                                   truth, CPU)
    assert facts["k"] == result.centroids.shape[0] and not facts["frozen"]
    assert [r["nprobe"] for r in rows] == [*bs.NPROBES, 1]
    for r in rows[: len(bs.NPROBES)]:
        assert r["recall"] >= FLOORS[r["nprobe"]], r
    flat = bs.flat_rows(upload_packed(packed, CPU), queries, truth, CPU)
    assert [r["label"] for r in flat] == ["flat_search s8", "flat_search bf16",
                                          "FlatIndex.search refine=32"]
    assert min(r["recall"] for r in flat) >= 0.96


def test_one_store_booted_by_both_packages(corpus, tmp_path):
    """The tool's populate, then the JAX Engine, the port's cold boot (from
    SQL) and its warm boot (from the snapshot the cold one wrote) on that
    store: the same top-10 sets at nprobe 8 but at ties."""
    packed, queries, truth, result = corpus
    db, snaps = str(tmp_path / "store.db"), str(tmp_path / "snaps")
    store = Store(db)
    cat_id = ec.populate(store, packed, result.centroids, result.assignments)["category_id"]
    ai = ec.QueryAI(queries)
    b = 128
    top = {}
    try:
        for name in ("cold", "warm"):
            boot, _, ids, sims = ec.boot_top10(
                lambda: Engine(store, ai, snapshot_dir=snaps, device=CPU), cat_id, b, CPU)
            assert boot["source"] == ("sql" if name == "cold" else "snapshot")
            assert boot["rows"] == N
            top[name] = sims, ids
    finally:
        store.close()
    jstore = JaxStore(db)
    try:
        jax_eng = JaxEngine(jstore, ai, snapshot_dir=None)
        try:
            jax_ids, jax_sims = ec.top10(jax_eng, b)
        finally:
            jax_eng.close()
    finally:
        jstore.close()
    assert sc.sets_differ(*top["warm"], *top["cold"], 0.0) == 0
    assert sc.sets_differ(*top["cold"], jax_sims, jax_ids, ATOL) == 0
    np.testing.assert_allclose(np.sort(top["cold"][0], 1), np.sort(jax_sims, 1), atol=ATOL)
    # document id = row + 1
    assert sc.recall(top["cold"][1], truth[:b] + 1) >= FLOORS[8]


def test_engine_check_end_to_end(corpus, small_runs, monkeypatch, tmp_path):
    """Steps (a) to (c); the entry serves where VSTPU_DEVICE asks."""
    monkeypatch.setenv("VSTPU_DEVICE", "cpu")
    packed, queries, truth, result = corpus
    b = 64
    out = ec.check(packed, result.centroids, result.assignments, queries[:b], truth[:b], CPU,
                   str(tmp_path))
    assert out["failures"] == []
    assert out["boots_differ"] == 0
    assert out["cold_boot"]["source"] == "sql" and out["warm_boot"]["source"] == "snapshot"
    entry = out["entry"]
    assert entry["recall_at_10"] >= ec.MIN_HTTP_RECALL
    assert entry["upload"]["not_first"] == 0 and entry["upload"]["docs"] == 200
    assert entry["delete"]["returned"] == 0 and entry["delete"]["docs"] == 20
    assert entry["live_vectors"] == N + 200 - 20
    assert entry["boot"]["source"] == "snapshot"


def test_engine_check_refuses_a_full_disk(corpus, monkeypatch, tmp_path):
    """Too little free space fails the check, naming the bytes needed; it
    never drops to a smaller N."""
    packed, queries, truth, result = corpus
    monkeypatch.setattr(ec.shutil, "disk_usage", lambda path: type("U", (), {"free": 10})())
    out = ec.check(packed, result.centroids, result.assignments, queries, truth, CPU,
                   str(tmp_path))
    need = ec.disk_needed(N, sc.DIM)
    assert out["failures"] == [f"10 bytes free in {tmp_path}, {need} needed for {N} rows"]
    assert not (tmp_path / "store.db").exists()


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_main_prints_its_json_line(small_runs, monkeypatch, capsys):
    monkeypatch.setenv("VSTPU_DEVICE", "cpu")
    assert bs.main(["--n", "8000", "--k", "8"]) == 0
    out = last_json(capsys)
    assert out["n"] == 8000 and out["device"] == "cpu" and out["unit"] == "qps"
    labels = [r["label"] for r in out["rows"]]
    assert labels[:3] == [f"ivf+refine nprobe={p}" for p in bs.NPROBES]
    assert "flat_search s8" in labels and "FlatIndex.search refine=32" in labels


def test_engine_main_prints_its_json_line(small_runs, monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("VSTPU_DEVICE", "cpu")
    make_queries = sc.make_queries
    monkeypatch.setattr(sc, "make_queries", lambda packed: make_queries(packed, 64))
    assert ec.main(["--n", "8000", "--k", "8", "--dir", str(tmp_path)]) == 0
    out = last_json(capsys)
    assert out["n"] == 8000 and out["failures"] == [] and out["device"] == "cpu"
    assert out["entry"]["upload"]["not_first"] == 0


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke_and_bench():
    """chip_smoke.py and the JAX package's bench.py, as fresh modules."""
    return (load(os.path.join(ROOT, "chip_smoke.py"), "chip_smoke_script"),
            load(os.path.join(ROOT, "bench.py"), "jax_bench_script"))


def test_make_corpus_bit_equal_to_bench_py(smoke_and_bench):
    """chip_smoke.py's recall floors were measured on bench.py's corpus."""
    smoke, jax_bench = smoke_and_bench
    for shape in ((4_000, 64, 16), (150_001, 8, 5)):  # one 100,000-row noise chunk and more
        np.testing.assert_array_equal(smoke.make_corpus(*shape), jax_bench.make_corpus(*shape))


def test_queries_and_truth_match_bench_py(smoke_and_bench, monkeypatch, tmp_path):
    """bench.py's setup() at 4,000 x 64, K=16, 64 queries (its cache in
    tmp_path) beside chip_smoke.py's make_queries and exact_truth: the
    queries bit-equal, the truth the same id sets but at a tie within 1e-6
    of the tenth f64 cosine."""
    smoke, jax_bench = smoke_and_bench
    n, dim, k, nq = 4_000, 64, 16, 64
    for name, v in (("N", n), ("DIM", dim), ("K_CLUSTERS", k), ("N_QUERIES", nq),
                    ("CACHE", str(tmp_path / "jax-setup.npz"))):
        monkeypatch.setattr(jax_bench, name, v)
    _, want_q, want_t = jax_bench.setup()
    data = smoke.make_corpus(n, dim, k)
    queries = smoke.make_queries(data, nq)
    np.testing.assert_array_equal(queries, want_q)
    truth = smoke.exact_truth(data, queries, CPU)
    sims = (queries / np.linalg.norm(queries, axis=1, keepdims=True)).astype(np.float64) @ (
        data / np.linalg.norm(data, axis=1, keepdims=True)).T.astype(np.float64)
    assert truth.shape == (nq, smoke.TOPK) and truth.dtype == np.int64
    assert sc.sets_differ(np.take_along_axis(sims, truth, 1), truth,
                          np.take_along_axis(sims, want_t, 1), want_t, 1e-6) == 0
