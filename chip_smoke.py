#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases (any failure exits non-zero before the last line is printed):
  1. environment: torch/CUDA versions, nvcc, the card's name and power limit;
  2. build: nvcc builds every kernel of the path from vectorsearch_tpu_torch/csrc;
  3. kernel against plain: the grouped bucket-scan kernel against its plain
     PyTorch version at the main path's shapes (D=768, cap=3072, K=995,
     B=512 at nprobe 1, 8 and 64), with median CUDA-event times of both;
  4. index at the bench's scale: bench.py's 1M x 768 clustered corpus and
     512 queries (recipe copied), exact-f32 ground truth, the k-means build
     with bench.py's arguments, IVFIndex.build, then IVFIndex.search at
     nprobe 1, 2, 8, 64 and -1 (recall@10 and QPS), 10,000 inserts that
     must find themselves first and 10,000 deletes that must never return;
  5. engine: upload, rebuild, search, search_many, delete and a snapshot
     reboot through Engine, with the deterministic noop embedder;
  6. the kernels line, the card line, and the contract line.

The kernel launch counts are set to 0 after phase 3 and read after phase
5: every kernel of the path must have been launched by phases 4-5. It
imports only the port, vectorsearch_tpu_torch (the codec, store and noop
embedder through vectorsearch_tpu_torch.host), and checks at the end that
jax was never imported.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# bench.py's corpus and query recipe (bench.py:162-172, :207-211)
N, DIM, K_GEN = 1_000_000, 768, 1024
N_QUERIES, TOPK, REFINE = 512, 10, 32
NPROBES = (1, 2, 8, 64, -1)
# recall@10 floors: bench.py's corpus measured 0.9453 at nprobe=1 and the
# corpus-quantization floor 0.9672 at nprobe >= 2 (BENCH_r05.json)
MIN_RECALL = {1: 0.94}
MIN_RECALL_WIDE = 0.96
# the scan kernel's shapes on that corpus
K_SCAN, CAP_SCAN = 995, 3072
KERNEL_NPROBES = (1, 8, 64)
KERNEL_ATOL = 1e-4  # f32 sums in another order over exact products


def log(msg: str) -> None:
    print(msg, flush=True)


def make_corpus(n, dim, k, seed=0):
    """Clustered synthetic corpus (bench.py make_corpus, copied)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim), dtype=np.float32)
    assign = rng.integers(0, k, size=n)
    out = centers[assign] * np.float32(2.0)
    for start in range(0, n, 100_000):
        end = min(start + 100_000, n)
        out[start:end] += rng.standard_normal((end - start, dim), dtype=np.float32)
    return out


def make_queries(data, n_queries, seed=123):
    """bench.py's queries: corpus rows plus 0.1 gaussian noise."""
    rng = np.random.default_rng(seed)
    q_idx = rng.choice(data.shape[0], size=n_queries, replace=False)
    noise = rng.normal(size=(n_queries, data.shape[1])).astype(np.float32) * 0.1
    return (data[q_idx] + noise).astype(np.float32)


def median_ms(torch, fn, runs=20):
    """Median CUDA-event time of fn() over `runs` launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


# ---------------------------------------------------------------- phases


def phase_env(torch) -> str:
    from vectorsearch_tpu_torch.kernels import _build

    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True)
    log("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi} (torch sees {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)})")
    return smi


def phase_build() -> float:
    from vectorsearch_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.load()._name
    secs = time.perf_counter() - t0
    log(f"build: {os.path.relpath(path)} in {secs:.2f} s")
    return secs


def phase_kernel(torch, dev, smi: str) -> dict:
    """grouped_scores against grouped_scores_ref on seeded data at the main
    path's shapes; the groups come from the port's own group build."""
    from vectorsearch_tpu_torch.kernels import grouped_scan as gs

    gen = torch.Generator(device=dev).manual_seed(0)
    kk, cap, d, b = K_SCAN, CAP_SCAN, DIM, N_QUERIES
    codes = torch.randint(-127, 128, (kk, cap, d), generator=gen, device=dev,
                          dtype=torch.int8)
    a = torch.rand((kk, cap), generator=gen, device=dev) * 0.01
    bv = torch.rand((kk, cap), generator=gen, device=dev) * 0.01
    counts = torch.randint(cap // 2, cap + 1, (kk,), generator=gen, device=dev)
    live = torch.rand((kk, cap), generator=gen, device=dev) > 0.05
    col = torch.arange(cap, device=dev)
    bias = torch.where((col[None] < counts[:, None]) & live, 0.0, float("-inf")).float()
    by_nprobe, worst = {}, 0.0
    for nprobe in KERNEL_NPROBES:
        sims = torch.rand((b, kk), generator=gen, device=dev)
        probed = torch.topk(sims, nprobe, dim=-1).indices.to(torch.int32)
        qt, gcl, qidx, _ = gs.build_groups(probed, kk)
        q = torch.randn((b, d), generator=gen, device=dev)
        q = q / q.norm(dim=-1, keepdim=True)
        qg, qsum = q.bfloat16()[qidx], q.sum(-1)[qidx]
        args = (qg, qsum, gcl, codes, a, bv, bias, 128)
        out, bmax = gs.grouped_scores(*args, True)
        torch.cuda.synchronize()
        ref, _ = gs.grouped_scores_ref(*args, False)
        finite = torch.isfinite(ref)
        if not torch.equal(torch.isfinite(out), finite):
            raise AssertionError(f"nprobe={nprobe}: -inf pattern differs from plain")
        err = float((out[finite] - ref[finite]).abs().max())
        if err > KERNEL_ATOL:
            raise AssertionError(f"nprobe={nprobe}: max |kernel - plain| {err} > {KERNEL_ATOL}")
        own = out.view(out.shape[0], qt, cap // 128, 128).amax(-1)
        if not torch.equal(bmax, own):
            raise AssertionError(f"nprobe={nprobe}: block maxima differ from the scores' own")
        ms = median_ms(torch, lambda: gs.grouped_scores(*args, True))
        plain_ms = median_ms(torch, lambda: gs.grouped_scores_ref(*args, True))
        g = int(gcl.numel())
        by_nprobe[nprobe] = {
            "G": g, "QT": qt, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "code_GB_per_s": g * cap * d / ms / 1e6,
        }
        worst = max(worst, err)
        log(f"kernel nprobe={nprobe}: G={g} QT={qt} max_abs_err={err:.3g} "
            f"bmax exact; kernel {ms:.3f} ms vs plain {plain_ms:.3f} ms "
            f"(median of 20, {smi})")
    del codes, a, bv, bias
    torch.cuda.empty_cache()
    main = by_nprobe[8]
    return {
        "name": "grouped_scores",
        "route": "cuda",
        "source": "vectorsearch_tpu_torch/csrc/grouped_scan.cu",
        "replaces": "vectorsearch_tpu/kernels/pallas_scan.py:131",
        "max_abs_err": worst,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "ms_at": "nprobe=8, B=512, K=995, cap=3072, D=768",
        "by_nprobe": by_nprobe,
    }


def phase_index(torch, dev, n=N, dim=DIM, k_gen=K_GEN, n_queries=N_QUERIES) -> dict:
    """bench.py's corpus through the port's build and search."""
    from vectorsearch_tpu_torch.build import build_centroids
    from vectorsearch_tpu_torch.device import check_exact_f32
    from vectorsearch_tpu_torch.host import layout
    from vectorsearch_tpu_torch.index import IVFIndex

    t0 = time.perf_counter()
    data = make_corpus(n, dim, k_gen)
    packed = layout.pack_float(data)
    queries = make_queries(data, n_queries)
    ids = np.arange(1, n + 1, dtype=np.int64)
    # exact f32 ground truth on the card, TF32 off
    corpus = torch.from_numpy(data).to(dev)
    corpus /= corpus.norm(dim=-1, keepdim=True)
    qn = torch.from_numpy(queries).to(dev)
    qn /= qn.norm(dim=-1, keepdim=True)
    check_exact_f32(qn)
    truth = np.concatenate([
        torch.topk(qn[i : i + 64] @ corpus.T, TOPK, dim=-1).indices.cpu().numpy()
        for i in range(0, n_queries, 64)
    ])
    del corpus, data
    torch.cuda.empty_cache()
    truth_ids = ids[truth]
    log(f"index: corpus {n}x{dim}, queries and f32 truth in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    result = build_centroids(
        packed, k=k_gen, min_cluster_size=max(1, (n // k_gen) // 10),
        max_iters=10, superset_iters=4, chunk=65_536, device=dev,
    )
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivf = IVFIndex.build(packed, ids, result.centroids,
                         assignments=result.assignments, device=dev)
    pack_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"index: k-means build {build_s:.1f} s ({result.iterations} iters, final "
        f"churn {result.final_changes}), bucket pack {pack_s:.1f} s, "
        f"K={ivf.k_clusters} cap={ivf.cap}, device memory in use {mem / 2**30:.2f} GiB")

    recalls, qps = {}, {}
    for nprobe in NPROBES:
        _, got = ivf.search(queries, k=TOPK, nprobe=nprobe, refine=REFINE)
        recalls[nprobe] = float(np.mean(
            [len(set(got[i]) & set(truth_ids[i])) / TOPK for i in range(n_queries)]
        ))
        reps = 5
        t1 = time.perf_counter()
        for _ in range(reps):
            ivf.search(queries, k=TOPK, nprobe=nprobe, refine=REFINE)
        qps[nprobe] = n_queries * reps / (time.perf_counter() - t1)
        log(f"search nprobe={nprobe}: recall@10 {recalls[nprobe]:.4f}, "
            f"{qps[nprobe]:.0f} QPS (B={n_queries}, host clock, end to end)")

    # 10,000 inserts: each new row is its own top-1
    m = 10_000
    new = make_corpus(m, dim, 64, seed=7)
    new_packed = layout.pack_float(new)
    new_ids = np.arange(n + 1, n + m + 1, dtype=np.int64)
    ivf = ivf.insert(new_packed, new_ids)
    probe_vecs = layout.unpack(new_packed)
    found = np.concatenate([
        ivf.search(probe_vecs[i : i + 512], k=1, nprobe=8, refine=8)[1][:, 0]
        for i in range(0, m, 512)
    ])
    self_top1 = float((found == new_ids).mean())
    log(f"insert {m}: self top-1 {self_top1:.4f}, spill {ivf.spill.live} rows")
    # 10,000 deletes: half the inserts and half originals, every query's
    # true top-1 among them; none may come back
    rng = np.random.default_rng(11)
    old = np.unique(np.concatenate([truth_ids[:, 0], rng.choice(ids, m, replace=False)]))
    gone = np.concatenate([new_ids[: m // 2], old[: m - m // 2]])
    ivf = ivf.remove_ids(gone)
    back = np.concatenate([
        ivf.search(probe_vecs[i : i + 512], k=TOPK, nprobe=8, refine=32)[1]
        for i in range(0, m // 2, 512)
    ] + [ivf.search(queries, k=TOPK, nprobe=nprobe, refine=REFINE)[1] for nprobe in NPROBES])
    returned = int(np.isin(back, gone).sum())
    log(f"delete {gone.size}: {returned} deleted ids returned, n_live {ivf.n_live}")
    return {
        "recall": recalls, "qps": qps, "build_s": build_s, "pack_s": pack_s,
        "k": ivf.k_clusters, "cap": ivf.cap, "self_top1": self_top1,
        "deleted_returned": returned, "n_live": ivf.n_live,
        "expected_live": n + m - gone.size,
    }


def phase_engine(torch, dev, n_docs=2_000) -> dict:
    """Engine over a temporary SQLite store and snapshot dir."""
    from vectorsearch_tpu_torch.engine import Engine
    from vectorsearch_tpu_torch.host import NoopAI, Store, layout

    out = {}
    with tempfile.TemporaryDirectory(prefix="vs_smoke_") as tmp:
        store = Store(os.path.join(tmp, "store.db"))
        eng = Engine(store, NoopAI(seed=0), snapshot_dir=os.path.join(tmp, "snaps"),
                     device=dev)
        docs = [{"name": f"doc{i}", "document": {"text": f"body {i}"}} for i in range(n_docs)]
        doc_ids = []
        for i in range(0, n_docs, 500):
            doc_ids += eng.upload("o", "c", docs[i : i + 500])
        rebuilt = eng.refresh_centroids(target_cluster_size=200)
        cat = store.get_category(store.get_owner("o").id, "c")
        state = eng._state_for(cat.id, create=False)
        out["clusters"] = state.ivf.k_clusters
        out["live"] = state.ivf.n_live
        hits1 = eng.search("o", "c", "some text", count=10, centroids=1)
        hits_all = eng.search("o", "c", "some text", count=10, centroids=-1)
        pages = eng.search_many("o", "c", [f"text {i}" for i in range(64)], count=10)
        out["hits"] = [len(hits1), len(hits_all), sum(len(p) for p in pages)]
        # delete one document; its stored vectors must not come back
        victim = hits_all[0].document_id
        emb = store.embeddings_for_documents([victim])
        out["deleted_vectors"] = len(emb)
        rows, _ = state.ivf.extract_rows(np.asarray(emb, np.int64))
        vecs = layout.unpack(rows)
        eng.delete_document("o", "c", victim)
        _, got = state.ivf.search(vecs, k=10, nprobe=-1, refine=10)
        after = eng.search_many("o", "c", [f"again {i}" for i in range(64)],
                                count=20, centroids=-1)
        out["delete_ok"] = bool(
            not np.isin(got, emb).any()
            and all(h.document_id != victim for p in after for h in p)
        )
        eng.close()  # saves the snapshot of the mutated category
        eng2 = Engine(store, NoopAI(seed=1), snapshot_dir=os.path.join(tmp, "snaps"),
                      device=dev)
        out["reboot_live"] = eng2._state_for(cat.id, create=False).ivf.n_live
        out["reboot_hits"] = len(eng2.search("o", "c", "x", count=10, centroids=2))
        eng2.close()
        store.close()
    out["rebuilt"] = bool(rebuilt.get(cat.id))
    log(f"engine: {n_docs} docs -> {out['live']} vectors in {out['clusters']} clusters; "
        f"hits {out['hits']}; delete ok {out['delete_ok']}; reboot {out['reboot_live']} "
        f"vectors, {out['reboot_hits']} hits")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from vectorsearch_tpu_torch.kernels import grouped_scan

    dev = torch.device("cuda", 0)
    smi = phase_env(torch)
    phase_build()
    entry = phase_kernel(torch, dev, smi)

    grouped_scan.LAUNCHES = 0  # the main path's own launches from here on
    idx = phase_index(torch, dev)
    eng_launch0 = grouped_scan.LAUNCHES
    eng = phase_engine(torch, dev)
    launches = grouped_scan.LAUNCHES
    log(f"launches: grouped_scores {eng_launch0} in the index phase, "
        f"{launches - eng_launch0} in the engine phase")

    failures = []
    for nprobe, r in idx["recall"].items():
        floor = MIN_RECALL.get(nprobe, MIN_RECALL_WIDE)
        if r < floor:
            failures.append(f"recall@10 {r:.4f} < {floor} at nprobe={nprobe}")
    if eng_launch0 == 0 or launches == eng_launch0:
        failures.append("the grouped scan kernel was not launched in both phases")
    if idx["self_top1"] < 1.0:
        failures.append(f"inserted rows found themselves first in {idx['self_top1']:.4f}")
    if idx["deleted_returned"] or idx["n_live"] != idx["expected_live"]:
        failures.append(f"deletes: {idx['deleted_returned']} returned, "
                        f"n_live {idx['n_live']} != {idx['expected_live']}")
    if not (eng["rebuilt"] and eng["clusters"] > 1 and eng["delete_ok"]
            and min(eng["hits"]) > 0 and eng["reboot_hits"] > 0
            and eng["reboot_live"] == eng["live"] - eng["deleted_vectors"]):
        failures.append(f"engine phase: {eng}")
    if "jax" in sys.modules:
        failures.append("jax was imported")
    if failures:
        for f in failures:
            print("FAIL: " + f, file=sys.stderr)
        return 1

    entry["launches"] = launches
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
