"""Batch-size sweep of the IVF search on distinct queries: QPS of one
search over B at nprobe 1 and 2. Counterpart of tools/r5_batch_sweep.py.

    python -m vectorsearch_tpu_torch.tools.batch_sweep        # the card: bench's 1M x 768
    VSTPU_DEVICE=cpu VSTPU_BENCH_N=20000 VSTPU_BENCH_DIM=64 VSTPU_BENCH_K=16 \\
        python -m vectorsearch_tpu_torch.tools.batch_sweep    # the CPU, small

A search carries per-call work that is constant in B (the probe, the
group build, the epilogue's launches) on top of the scan kernel, so QPS
should rise with B until the kernel's reads of the buckets saturate.

r5_batch_sweep.py took its setup from tools/ivf_perf_probe.py, which is
not carried (ROADMAP); that setup was bench.py's corpus, queries, truth
and build arguments, so this tool takes the port's bench.setup() and
bench.build() (bench's VSTPU_BENCH_* sizes, its device rule and cache).
Then, for each nprobe and each B, through index/ivf._scan_refined as bench
measures it: recall@10 of the queries searched in calls of B rows, the
calls filled up to B with pool rows, so that the recall is that of the
timed shape (r5_batch_sweep.py takes it once per nprobe, at the queries'
own count); then one warm call and ROUNDS timed calls on B distinct
queries (bench.query_pool: sampled rows dequantized plus 0.1 noise, seed
7; tiling the queries would alias repeats into the same clusters and
overstate QPS), ending on a synchronize. sweep() runs this on an index
the caller already has (chip_smoke.py's batchsweep phase).

Env: VSTPU_SWEEP_BATCHES (512,1024,2048,4096), VSTPU_SWEEP_NPROBES (1,2),
VSTPU_SWEEP_ROUNDS (20). Logs r5_batch_sweep.py's lines to stderr and
prints one JSON line with the rows.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from .. import bench
from ..device import to_device, to_host

BATCHES = tuple(int(b) for b in os.environ.get("VSTPU_SWEEP_BATCHES", "512,1024,2048,4096")
                .split(","))
NPROBES = tuple(int(p) for p in os.environ.get("VSTPU_SWEEP_NPROBES", "1,2").split(","))
ROUNDS = int(os.environ.get("VSTPU_SWEEP_ROUNDS", 20))


def log(msg, *args):
    print(msg % args if args else msg, file=sys.stderr, flush=True)


def recall_at(fn, queries, truth_ids, id_map, pool, batch, dev) -> float:
    """Recall@10 of `queries` against `truth_ids` (external ids), searched
    by fn in calls of `batch` rows, the last call filled up with `pool`
    rows."""
    nq = len(queries)
    rows = np.concatenate([queries, pool[: -nq % batch]])
    got = np.concatenate([id_map(to_host(fn(to_device(rows[i : i + batch], dev))[1]))
                          for i in range(0, len(rows), batch)])[:nq]
    return float(np.mean([len(set(got[i][: bench.TOPK]) & set(truth_ids[i])) / bench.TOPK
                          for i in range(nq)]))


def sweep(ivf, packed, queries, truth_ids, dev) -> list:
    """Recall@10 against `truth_ids` (external ids, the index's ids being
    1..n), ms and QPS a search at each (nprobe, B) of NPROBES x BATCHES,
    ROUNDS timed calls a point. Returns rows of {nprobe, batch, recall,
    ms, qps}."""
    pool = bench.query_pool(packed, max(BATCHES))
    id_map = bench.slot_ids(ivf)
    rows = []
    for nprobe in NPROBES:
        fn = bench.ivf_search(ivf, nprobe)
        for batch in BATCHES:
            recall = recall_at(fn, queries, truth_ids, id_map, pool, batch, dev)
            qps = bench.timed_qps(fn, to_device(pool[:batch], dev), ROUNDS, dev)
            ms = 1e3 * batch / qps
            log("batchsweep: nprobe=%d B=%-5d %8.2f ms/batch  %8.0f QPS  recall@10=%.4f",
                nprobe, batch, ms, qps, recall)
            rows.append({"nprobe": nprobe, "batch": batch, "recall": recall, "ms": ms,
                         "qps": qps})
    log("batchsweep: done")
    return rows


def main() -> int:
    dev = bench.bench_device()
    packed, queries, truth = bench.setup(dev)
    n = packed.codes.shape[0]
    ivf, _, _ = bench.build(packed, dev)
    log("batchsweep: index K=%d cap=%d on %s", ivf.k_clusters, ivf.cap, dev)
    rows = sweep(ivf, packed, queries, np.arange(1, n + 1, dtype=np.int64)[truth], dev)
    print(json.dumps({
        "tool": "batch_sweep", "n": n, "dim": packed.codes.shape[1], "k": ivf.k_clusters,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "rows": rows,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
