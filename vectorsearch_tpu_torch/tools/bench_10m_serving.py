"""The 10M x 768 index served on one device: recall@10 and QPS of
IVFIndex.search at nprobe 1 / 8 / 64 (k=10, refine=32, B=512), nprobe 1
at large batches, and the flat path on the same rows: FlatIndex.search
(refine=32) and flat_search with the s8 and the bf16 band kernels.
Counterpart of tools/bench_10m_serving.py.

    python -m vectorsearch_tpu_torch.tools.bench_10m_serving            # the card, 10M
    VSTPU_DEVICE=cpu python -m vectorsearch_tpu_torch.tools.bench_10m_serving --n 20000 --k 16

Rows: scale_corpus's recipe from k generating centers, seed 0, made on the
device and moved to host numpy. Centroids: scale_corpus.build, build_centroids
with bench_build.py's arguments (k clusters). The index takes the engine's
device budget (device.hbm_budget), as a served category does, where the
TPU tool took headroom 1.0 to fit in 16 GB. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import hbm_budget, resolve, to_device, upload_packed
from ..index import FlatIndex, IVFIndex
from ..kernels import flat as tf
from . import scale_corpus as sc

N, K = 10_000_000, 4096
NPROBES = (1, 8, 64)
REFINE = 32
# nprobe=1 at the JAX tool's large batches: distinct queries (seed 7), the
# recall taken from the B=512 row (the same program)
BULK_BATCHES = (2048, 4096, 8192)
BULK_SEED = 7
REPS = 10  # timed searches a row
FLAT_KBANDS = 64


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wall_s(fn) -> float:
    """Host seconds a call of fn over REPS calls, after one untimed call
    (fn returns host arrays, so each call has ended when it returns)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    return (time.perf_counter() - t0) / REPS


def index_rows(packed, centroids, assignments, queries, truth, dev):
    """IVFIndex.build under the device budget, then the searches. Returns
    (rows, build facts, the index): rows of {label, nprobe, batch, qps,
    recall, wall_ms}."""
    n = packed.codes.shape[0]
    ids = np.arange(1, n + 1, dtype=np.int64)
    t0 = time.perf_counter()
    ivf = IVFIndex.build(packed, ids, centroids, assignments=assignments,
                         hbm_budget=hbm_budget(dev), device=dev)
    sync(dev)
    facts = {"pack_s": time.perf_counter() - t0, "k": ivf.k_clusters, "cap": ivf.cap,
             "frozen": ivf.frozen, "index_GB": ivf.hbm_bytes / 1e9}
    log(f"serve10m: bucket pack {facts['pack_s']:.1f} s, K={ivf.k_clusters} cap={ivf.cap}, "
        f"{facts['index_GB']:.2f} GB on {dev}, frozen={ivf.frozen}")
    rows = []
    b = queries.shape[0]
    for nprobe in NPROBES:
        _, got = ivf.search(queries, k=sc.TOPK, nprobe=nprobe, refine=REFINE)
        r = sc.recall(got, ids[truth])
        s = wall_s(lambda: ivf.search(queries, k=sc.TOPK, nprobe=nprobe, refine=REFINE))
        rows.append({"label": f"ivf+refine nprobe={nprobe}", "nprobe": nprobe, "batch": b,
                     "qps": b / s, "recall": r, "wall_ms": s * 1e3})
        log(f"serve10m: nprobe={nprobe} B={b}: recall@10 {r:.4f}, {b / s:.0f} QPS, "
            f"{s * 1e3:.3f} ms a search (host clock)")
    pool = sc.make_queries(packed, max(BULK_BATCHES), seed=BULK_SEED)
    r1 = rows[0]["recall"]
    for batch in BULK_BATCHES:
        q = pool[:batch]
        s = wall_s(lambda: ivf.search(q, k=sc.TOPK, nprobe=1, refine=REFINE))
        rows.append({"label": f"ivf+refine nprobe=1 B={batch}", "nprobe": 1, "batch": batch,
                     "qps": batch / s, "recall": r1, "wall_ms": s * 1e3})
        log(f"serve10m: nprobe=1 B={batch}: {batch / s:.0f} QPS, {s * 1e3:.3f} ms a search "
            f"(recall from B={b}: {r1:.4f})")
    return rows, facts, ivf


def flat_rows(corpus, queries, truth, dev):
    """FlatIndex.search(refine=32) and flat_search (s8, bf16) over `corpus`
    (PackedVectors of tensors on dev): rows of {label, batch, recall,
    wall_ms, qps}; ids are row numbers."""
    n = corpus.codes.shape[0]
    b = queries.shape[0]
    rows = []
    q = to_device(queries, dev, torch.float32)
    for use_s8, name in ((True, "s8"), (False, "bf16")):
        def search():
            s, i = tf.flat_search(q, corpus, n, k=sc.TOPK, k_bands=FLAT_KBANDS, use_s8=use_s8)
            return s.cpu().numpy(), i.cpu().numpy()

        got = search()[1]
        s = wall_s(search)
        rows.append({"label": f"flat_search {name}", "batch": b, "recall": sc.recall(got, truth),
                     "wall_ms": s * 1e3, "qps": b / s})
    flat = FlatIndex.from_packed(corpus, np.arange(n, dtype=np.int64), device=dev)
    got = flat.search(queries, k=sc.TOPK, refine=REFINE)[1]
    s = wall_s(lambda: flat.search(queries, k=sc.TOPK, refine=REFINE))
    rows.append({"label": f"FlatIndex.search refine={REFINE}", "batch": b,
                 "recall": sc.recall(got, truth), "wall_ms": s * 1e3, "qps": b / s})
    del flat
    for r in rows[-3:]:
        log(f"serve10m: {r['label']}: recall@10 {r['recall']:.4f}, {r['wall_ms']:.3f} ms a "
            f"B={b} search (host clock)")
    return rows


def summary(n: int, rows: list, device: str, **facts) -> dict:
    """The JSON line: the best QPS among rows at recall >= 0.9, and every row."""
    eligible = [r for r in rows if r["recall"] >= 0.9] or rows
    best = max(eligible, key=lambda r: r["qps"])
    return {
        "metric": f"QPS at recall@10, {n}x{sc.DIM} int8 IVF serving ({best['label']}, "
                  f"recall={best['recall']:.4f})",
        "value": best["qps"], "unit": "qps", "n": n, "device": device, **facts,
        "rows": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N, help="rows (default 10M)")
    ap.add_argument("--k", type=int, default=K,
                    help="generating centers and k-means clusters (default 4096)")
    args = ap.parse_args(argv)
    dev = resolve(None)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    packed = sc.packed_host(dev, args.n, sc.DIM, args.k, seed=0)
    queries = sc.make_queries(packed)
    truth = sc.exact_truth(queries, dev, args.n, sc.DIM, args.k, seed=0)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = sc.build(packed, dev, k=args.k)
    sync(dev)
    build_s = time.perf_counter() - t0
    log(f"serve10m: {args.n}x{sc.DIM} rows, queries and truth {gen_s:.1f} s; build "
        f"{build_s:.1f} s ({result.centroids.shape[0]} centroids) on {name}")
    rows, facts, ivf = index_rows(packed, result.centroids, result.assignments, queries,
                                  truth, dev)
    del ivf
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rows += flat_rows(upload_packed(packed, dev), queries, truth, dev)
    print(json.dumps(summary(args.n, rows, name, gen_s=gen_s, build_s=build_s, **facts)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
