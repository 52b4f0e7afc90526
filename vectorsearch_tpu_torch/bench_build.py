"""The index build at BASELINE config 4, 10M x 768 -> 4096 centroids, on
one device. Counterpart of bench_build.py.

    python -m vectorsearch_tpu_torch.bench_build             # the card, 10M
    VSTPU_BUILD_N=2000000 python -m vectorsearch_tpu_torch.bench_build
    VSTPU_DEVICE=cpu VSTPU_BUILD_N=20000 VSTPU_BUILD_DIM=64 VSTPU_BUILD_K=16 \\
        python -m vectorsearch_tpu_torch.bench_build         # the CPU, small

Rows: bench_build.py's host numpy recipe (seed 0: K generating centers,
2 * center + unit noise), made and packed 500,000 rows at a time into
preallocated arrays, bit for bit bench_build.py's. They are cached as
torch-build-corpus-<N>x<DIM>-k<K>.npz in bench.CACHE_DIR (the checkout's
.cache/, or VSTPU_BENCH_CACHE; the JAX tool's file, keyed by N alone, is
never read). build() is build_centroids with bench_build.py's arguments;
tools/bench_10m_serving.py and chip_smoke.py's 10M build take them from
here. The k-means seconds are never cached; the kernel library is built
or loaded before they are timed (bench.load_kernels).

Logs the max/mean cluster size and the run's kernel launches to stderr
and prints one JSON line {"metric", "value", "unit": "s"}. Env:
VSTPU_BUILD_N / DIM / K / ITERS. Device: VSTPU_DEVICE, else the card,
else NoDeviceError.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .bench import CACHE_DIR, launches, load_kernels
from .build import build_centroids
from .device import resolve
from .quant import layout
from .quant.layout import PackedVectors

N = int(os.environ.get("VSTPU_BUILD_N", 10_000_000))
DIM = int(os.environ.get("VSTPU_BUILD_DIM", 768))
K = int(os.environ.get("VSTPU_BUILD_K", 4096))
ITERS = int(os.environ.get("VSTPU_BUILD_ITERS", 8))
CHUNK_ROWS = 500_000
CACHE = os.path.join(CACHE_DIR, f"torch-build-corpus-{N}x{DIM}-k{K}.npz")


def log(msg, *args):
    print(msg % args if args else msg, file=sys.stderr, flush=True)


def make_packed(n, dim, k, seed=0) -> PackedVectors:
    """bench_build.py's rows, packed CHUNK_ROWS at a time into preallocated
    arrays (a list of parts and a concatenate would double the peak host
    memory)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim), dtype=np.float32)
    packed = PackedVectors(
        codes=np.empty((n, dim), np.int8),
        scale=np.empty(n, np.float32),
        offset=np.empty(n, np.float32),
        inv_norm=np.empty(n, np.float32),
    )
    for start in range(0, n, CHUNK_ROWS):
        m = min(CHUNK_ROWS, n - start)
        block = centers[rng.integers(0, k, size=m)] * np.float32(2.0)
        block += rng.standard_normal((m, dim), dtype=np.float32)
        for dst, src in zip(packed, layout.pack_float(block)):
            dst[start : start + m] = src
    return packed


def corpus() -> PackedVectors:
    """make_packed(N, DIM, K), from CACHE when it is there."""
    if os.path.exists(CACHE):
        with np.load(CACHE) as z:
            packed = PackedVectors(*(z[f] for f in PackedVectors._fields))
        log("build-bench: loaded cached packed corpus %s", CACHE)
        return packed
    t0 = time.perf_counter()
    packed = make_packed(N, DIM, K)
    os.makedirs(CACHE_DIR, exist_ok=True)
    np.savez(CACHE + ".tmp.npz", **packed._asdict())
    os.replace(CACHE + ".tmp.npz", CACHE)
    log("build-bench: generated+packed %dx%d in %.1fs (cached -> %s)",
        N, DIM, time.perf_counter() - t0, CACHE)
    return packed


def build(packed, device, k=K, max_iters=8):
    """bench_build.py's build_centroids of `packed` into about k clusters
    (max_iters: its default; main passes VSTPU_BUILD_ITERS)."""
    n = packed.codes.shape[0]
    return build_centroids(
        packed,
        k=k,
        min_cluster_size=max(1, (n // k) // 10),
        max_iters=max_iters,
        superset_iters=3,
        chunk=65_536,
        balance_rounds=1,
        device=device,
    )


def main() -> int:
    dev = resolve(None)
    start = launches()
    log("build-bench: device %s (%s)", dev,
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    log("build-bench: kernel library ready in %.1fs", load_kernels(dev))
    packed = corpus()
    t0 = time.perf_counter()
    result = build(packed, dev, max_iters=ITERS)
    build_s = time.perf_counter() - t0
    log(
        "build-bench: %d centroids over %d vectors in %.1fs; "
        "max/mean cluster %d/%d",
        result.centroids.shape[0], N, build_s,
        int(result.counts.max()), int(result.counts.mean()),
    )
    log("build-bench: kernel launches %s",
        json.dumps({k: v - start[k] for k, v in launches().items()}))
    print(json.dumps({
        "metric": f"k-means build {N}x{DIM} -> {result.centroids.shape[0]} centroids",
        "value": round(build_s, 1),
        "unit": "s",
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
