#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases (any failure, a failed check or a phase that raised, prints a
FAIL: line and exits 1 before the last line is printed):
  1. environment: torch/CUDA versions, nvcc, the card's name and power limit;
  2. build: nvcc builds every kernel of the path from vectorsearch_tpu_torch/csrc,
     one nvcc per source, all started together; beside it, ptxas's report
     (`-Xptxas -v`) of the assign, the accumulate, the grouped-scan and the
     flat band kernels (a spill or a warning in the accumulate or the flat
     kernels fails the run);
  3. kernels against plain, with median CUDA-event times of both:
     a. the grouped bucket-scan kernel: its edge cases (a cluster with
        count 0, with count = cap, counts off the 128- and 64-column grid,
        cap 64 and 192, a cluster id out of range, D 16 to 3072, QT 8, 16,
        32), then the search path's shapes (D=768, cap=3072, K=995, B=512
        at nprobe 1, 8 and 64) on a synthetic store whose buckets are half
        to all full; in phase 4 the same on the built index's own store
        with the queries' real probes. Beside each time: torch.bmm of the
        group rows by their buckets' bf16 codes (the product alone), and
        the bound counted on every slot and on the live columns;
     b. the k-means assign and accumulate kernels at the build's shapes
        (1M x 768 clustered packed rows at K=1024 and 4096, and the
        superset phase's 196,608 rows at K=16,384): cid equal except at
        near-ties, counts equal, sums within tolerance, and two accumulate
        launches bit-identical; beside assign, one torch.matmul of the bf16
        codes by cn_bf16^T (the product alone) as the library yardstick.
        accumulate first at the edges of its chunked design (N around a
        chunk's length, K=1, one cluster holding every row, empty clusters,
        clusters ending on chunk boundaries, a cluster over several chunks
        among 12-member ones, ids out of range, D of 16, 100, 768, 3072;
        every case twice, bit-identical); then, in turns with the plain-load
        kernel it replaced: the whole call 10 back to back and one launch a
        timing, its kernels alone, its torch side alone, index_add_ of the
        f32 rows as the library yardstick, and the kernels under other
        chunk lengths and ring depths;
        then assign alone at N=1M over K=256..4096 and at N=196,608 over
        K=2048..16,384, with the line t = a + b K through each N's times;
     c. the s8 and bf16 flat band kernels: their edge cases (N from 1 to
        131,073 off the 1024- and 128-row grids, B from 1 to 512 around the
        query-block sizes, D 16 to 3072 with one that needs padding, a
        wholly dead tile, an all-dead corpus, two launches bit-equal), then
        1M x 768 clustered packed rows with tombstones, B=512, at N=1M and
        at N=1M-300 (a partial last tile): s8 band maxima bit-equal, bf16
        within 1e-4 with the same -inf pattern; the time of 10 launches
        back to back and of one launch with its wrapper, TOP/s and GB/s,
        the bound and which of bytes and operations binds; beside each,
        torch._int_mm / torch.matmul of the queries by the codes (the
        product alone); then each kernel under other schedules (one tile a
        block, 64 queries a block, shallower rings);
  4. index at bench.py's scale: its 1M x 768 clustered corpus and 512
     queries (make_corpus, make_queries below, bit for bit bench.py's),
     exact-f32 ground truth, the k-means build with bench.py's arguments,
     IVFIndex.build, then IVFIndex.search at nprobe 1, 2, 8, 64 and -1
     (recall@10 and QPS; B=512 takes QT 8 at nprobe 1 and 2, 16 at 8 and
     32 at 64 on this index); the searches once more under torch.profiler,
     device time by kind of kernel beside the unprofiled wall (outside the
     phase's launch counts); then bench.py's widest bulk shape (nprobe 2,
     B=65536; bulk_check): the scan kernel on that call's groups against
     its plain version, the call's top-10, and IVFIndex.search's on the
     same rows (its batch-chunked dispatch), against the same rows searched
     512 at a time (sets equal but at ties), and its recall at the floor;
     then 10,000 inserts that must find themselves first and 10,000
     deletes that must never return;
  5. flat: flat_search (k=10, k_bands=64) with the s8 and with the bf16
     band kernel, and FlatIndex.search(refine=32) beside them, on phase
     4's corpus, queries and truth: recall@10, no id twice in a result,
     and the wall time per B=512 search;
  6. sharded (phase 4's corpus, build, queries and truth): ShardedIVF on 4
     shards of the card and on default_mesh() at nprobe 1, 8, 64 and -1
     (k=10, refine=32, B=512): recall@10 at the floors, the top-10 sets of
     IVFIndex.search on the same centroids except at ties within 1e-6, no
     id twice, and the wall per search beside the single-device index's;
     on shard 0 of the 4 at nprobe 8 and 64, the scan kernel against its
     plain version on the groups the search gives it (the pairs of clusters
     other shards own grouped under the out-of-range id K: -inf, no codes
     read), and grouped_scan's top-k with probe_valid against the same
     function over the plain version (outside the phase's launch count);
     ShardedFlat on the 4 shards (recall@10 >= 0.96); lloyd, 5 passes from
     phase 4's centroids on the 4 shards and on one device (assignments
     equal but for at most 1e-4 of the rows, the other clusters' centroids
     within 1e-4), then build_centroids on the 4 shards with phase 4's
     arguments; an Engine with default_mesh() whose rebuild installs the
     replica, a search through it, a delete that drops it (the deleted
     document never returns); and child processes, one a card (one on a
     machine with one card), that join an `nccl` group through
     maybe_initialize and search a ShardedIVF over global_mesh();
  7. graft: the port's graft entry points (vectorsearch_tpu_torch/graft_entry.py):
     entry()'s forward (probe + grouped scan, nprobe=2, k=10) on the card at
     its example shape against the same function on CPU copies of its
     tensors (the scan kernel's plain version), and at full width on phase
     4's index (B=512) against index/ivf._ivf_scan, the plain gather
     formulation, on the card: scores within the scan's tolerance, slot sets
     equal but at ties; then dryrun_multichip over default_mesh() (every
     card) and over 4 shards of the card built as a Mesh (a sharded Lloyd's
     pass, ShardedFlat, ShardedIVF with and without refine held against
     IVFIndex, an Engine whose rebuild installs the replica and serves 6
     concurrent searches through the batcher);
  9. engine: the native codec's build (openmp, serial or numpy; numpy
     where a C++ compiler is present fails); an engine booted from an
     in-memory SQL store of phase 4's 1M x 768 rows (each row's
     centroid_id its assignment, no rebuild), its recall@10 at nprobe 8
     in-process against the truth (>= 0.96); then upload, rebuild
     (Engine.refresh_centroids), search, search_many, delete and a
     snapshot reboot through Engine, with the deterministic noop embedder;
  10. server: the port's entry (vectorsearch_tpu_torch.__main__.run) in
     this process, on a free localhost port over a temporary SQLite store
     and snapshot dir, with a deterministic embedder at D=768 (a text's
     first number names a document; its vector is bench.py's recipe).
     Boot 1 takes 200,000 documents in 200 uploads of 1,000 and stops
     (the engine writes its snapshot); boot 2 restores it, rebuilds at
     startup (both k-means kernels) while one client searches, one request
     at a time (each must answer; the slowest is the wait a search sees
     while the rebuild rewrites the store), and then over HTTP: 1,000 sampled
     documents each find themselves first at centroids 8 and -1; single
     searches at centroids 1 and 8 from one client and from 16 at once
     (p50/p99 ms, requests/s); batched texts searches of 256 (queries/s);
     100 deletes that never come back; a chat stream; /api/stats naming
     the card; then through the port's client SDK (client.Client): an
     upload of 1,000 new documents, searches at centroids 1 and 8 whose
     hits must equal the raw HTTP answer to the same request, a zstd round
     trip, a streamed chat, and an empty upload that must raise ClientError
     with the server's status. Then `python -m vectorsearch_tpu_torch`
     with the noop embedder boots, answers an upload and a search, and
     exits 0 on SIGTERM;
  11. the 10M build: bench_build.py's configuration, 10M x 768 clustered
     packed rows from 4096 generating centers (made on the card from a
     fixed seed, moved to host numpy once) -> tools/scale_corpus.build
     (build_centroids with k=4096 and bench_build.py's arguments): build
     seconds, iterations, final
     churn, cluster sizes and peak device memory; then, outside the phase's
     launch counts, the same build under torch.profiler, its device time
     summed by kernel;
  12. serve10m (vectorsearch_tpu_torch/tools/bench_10m_serving.py on phase
     11's rows and build; no second build): 512 queries (dequantized rows
     plus noise, numpy seed 123) and their exact-f32 truth over the
     ORIGINAL rows, made again slab by slab on the card; IVFIndex.build
     under the engine's device budget (85% of the card: the bucket store is
     not frozen), IVFIndex.search at nprobe 1, 8 and 64 (k=10, refine=32,
     B=512; recall@10 at the 1M cell's floors) and nprobe 1 at B 2048,
     4096, 8192; flat_search (s8, bf16) and FlatIndex.search(refine=32) on
     the same rows. Outside the phase's launch counts: the scan kernel on
     the 10M store at nprobe 8 and 64 against its plain version (the
     search's own groups; blockexact's shapes), and both band kernels at
     N=10M against theirs on 64 and on 512 queries, the flat search's
     batch (s8 bit-equal, bf16 within 1e-4, the same -inf pattern), each
     timed at B=512 with its bound and library yardstick;
  13. engine10m (vectorsearch_tpu_torch/tools/engine_10m_check.py on the
     first ENGINE10M_N = 2M of the same rows: cut from 10M, where the
     phase alone takes longer than the whole script may, to the largest
     size measured to keep the script within half its time limit (see
     ENGINE10M_N); `python -m
     vectorsearch_tpu_torch.tools.engine_10m_check` runs it at 10M. In a
     temporary directory removed afterwards; too little free disk is a
     failure naming the bytes needed): the rows written in bulk into a
     fresh SQLite store with the build's assignments; a cold boot from
     SQL (the engine's split: sql,
     pack, index, snapshot) and a warm boot from its snapshot, whose top-10
     sets at nprobe 8 on the 512 queries must agree but at ties; then the
     port's entry (__main__.run) in this process on that store: seconds to
     listen, the startup rebuild (both k-means kernels) with one client
     searching meanwhile, HTTP recall@10 at nprobe 8 (>= 0.96), sequential
     and 64-thread searches, batched texts with and without documents, 20
     uploads of 10 that must find themselves first, 20 deletes that must
     never return, RSS and device bytes, and a clean stop;
  14. the kernels line, the card line, and the contract line. Each kernel's
     entry has its bound (the larger of its bytes over 3.35 TB/s and its
     operations over the peak of their type, from this run's shapes), its
     share of that bound, and the time of one PyTorch call for the
     product alone (no sidecars, argmax or maxima; for accumulate,
     index_add_ of the f32 dequantized rows).
     The grouped scan's row is its time on the built index's store; the
     rows at the 10M shapes of phase 12 stand beside the 1M ones.

Every kernel launch count is set to 0 just before each of phases 4-13 and
read just after: phases 4, 6, 7, 9, 10 and 13 must launch the grouped
scan and both k-means kernels (phase 6 the scan at least once a shard of
every search on the card's 4 shards), phase 5 both flat band kernels,
phase 11 both k-means kernels, phase 12 the scan and both band kernels.
The script
imports only the port,
vectorsearch_tpu_torch (the codec, store, config schema and noop embedder
through vectorsearch_tpu_torch.host), and checks at the end that neither
jax nor anything of the JAX package vectorsearch_tpu was imported.
"""
from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

# bench.py's corpus and queries (make_corpus, make_queries)
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
# the k-means kernels' shapes: (rows, K, the plain version's chunk), as
# the 1M index build and the 10M build's superset phase run them
KMEANS_SHAPES = ((1_000_000, 1024, 65_536), (1_000_000, 4096, 65_536),
                 (196_608, 16_384, 8_192))
KMEANS_MAIN = (1_000_000, 4096)
# assign timed at a fixed N over K: a line t = a + b K through the times
# splits a cost per row tile (its codes' load, the store) from a cost per
# centroid (every 128-row block reads all of cn from L2)
ASSIGN_SWEEP = ((1_000_000, (256, 512, 1024, 2048, 4096)),
                (196_608, (2048, 4096, 8192, 16_384)))
TIE_ATOL = 1e-5  # a cid may differ only where the plain sims lie this close
# the chunk of the library yardstick of assign (one bf16 matmul a chunk)
LIBRARY_CHUNK = 65_536
SUM_RTOL, SUM_ATOL = 1e-5, 1e-4  # f32 sums of the same values in another order
# accumulate's two kernels, timed in turns in one call: the chunked one the
# build runs at D % 16 == 0, and the plain-load one (the first port's) that
# takes every other D
ACCUMULATE_ROUTES = ("chunks", "loads")
# other schedules of the chunked kernel, timed beside the launch rule's:
# (label, member rows a chunk, ring stages), 0 for the rule's choice
ACCUMULATE_SCHEDULES = (
    ("64 rows a chunk", 64, 0), ("128 rows a chunk", 128, 0),
    ("256 rows a chunk", 256, 0), ("512 rows a chunk", 512, 0),
    ("1024 rows a chunk", 1024, 0), ("2 stages", 0, 2), ("4 stages", 0, 4),
)
# the chunk lengths of accumulate's edge cases: the rule's shortest and its
# longest
ACCUMULATE_EDGE_CHUNKS = (64, 512)
# bench_build.py's configuration (BASELINE config 4)
BUILD_N, BUILD_K = 10_000_000, 4096
# the flat search: bands kept per query, and the band kernels' corpus sizes
# (whole tiles, and a partial last tile)
FLAT_KBANDS = 64
FLAT_SHAPES = (N, N - 300)
# the band kernels' edge cases: every N with every B, the widths cycled
# over them (D=100 is padded to 112 by the wrappers; 1024 and 3072 take 64
# queries a block or stream the query rows where 128 do not fit)
FLAT_EDGE_N = (1, 127, 1023, 1024, 1025, 131_073)
FLAT_EDGE_B = (1, 63, 64, 65, 129, 512)
FLAT_EDGE_D = (16, 100, 128, 768, 1024, 3072)
# other schedules of the band kernels, timed beside the launch rule's:
# (label, tile lanes or None for one tile a block, ring stages, queries a
# block), 0 for the rule's choice
FLAT_SCHEDULES = (
    ("one tile a block", None, 0, 0),
    ("64 queries a block", 0, 0, 64),
    ("4 stages", 0, 4, 0),
    ("2 stages", 0, 2, 0),
)
# the server phase: documents uploaded over HTTP (SERVER_UPLOAD a request),
# documents sampled for the self-searches, single searches timed from one
# client, then SERVER_PER_CLIENT from each of SERVER_CLIENTS at once, batched
# texts requests of SERVER_BATCH_Q, and deletes
SERVER_DOCS, SERVER_UPLOAD = 200_000, 1_000
SERVER_SAMPLE, SERVER_SINGLE = 1_000, 200
SERVER_CLIENTS, SERVER_PER_CLIENT = 16, 100
SERVER_NPROBES = (1, 8)
SERVER_BATCH_Q, SERVER_BATCH_ROUNDS = 256, 5
SERVER_DELETE = 100
# the client SDK's share of the server phase: documents it uploads, and
# searches it makes from the sampled and from its own documents
SERVER_CLIENT_UPLOAD, SERVER_CLIENT_SEARCHES = 1_000, 50
CHAT_REPLY = "chat reply"
# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# the least time a kernel could take is the larger of its bytes over the
# memory rate and its operations over the peak rate of their type
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
# the sharded phase: shards of one card for ShardedIVF, ShardedFlat and
# Lloyd's, the probe widths, the passes of lloyd from phase 4's centroids,
# the share of rows whose assignment may differ from one device's (near-ties
# after passes of f32 sums in another order), the centroid tolerance of the
# clusters none of them touch, and the score gap counted as a tie when a
# top-10 set differs from IVFIndex's
SHARDED_SHARDS = 4
SHARDED_NPROBES = (1, 8, 64, -1)
# the probe widths at which one shard's scan is held against its plain version
SHARDED_CHECK_NPROBES = (8, 64)
SHARDED_LLOYD_ITERS = 5
LLOYD_MOVED_SHARE, LLOYD_CENTROID_ATOL = 1e-4, 1e-4
TIE_SHARDED = 1e-6
# the 10M serving phase: the probe widths at which the scan kernel is held
# against its plain version on the 10M store, and the batches at which the
# band kernels are held against theirs at N=10M: 64 queries (one block of
# 64 over every SM's tile lane) and the flat search's own 512 (blocks of
# 128 for s8, 4 query blocks; band offsets past 2^31 bytes)
SERVE10M_CHECK_NPROBES = (8, 64)
SERVE10M_BAND_BS = (64, N_QUERIES)
# the 10M engine phase's documents: the first ENGINE10M_N of phase 11's rows,
# a multiple of the 500,000-row slab. Cut from 10M to the largest size
# measured to keep the whole script within 600 s, half its time limit, and
# never below 2M (engine_scale_check's size). On H100 80GB HBM3 hosts at
# 700 W the phase took 1340 s alone at 10M, 445.7 s at 3M (the script
# 799 s) and 212-250 s at 2M (the script 472-529 s)
ENGINE10M_N = 2_000_000
# bench.py's widest bulk batch (bulk_check), and its reference: the same
# rows searched this many a call
BULK_BATCH = 65_536
BULK_CHECK_SPLIT = 512
# the kernels each phase run through run() must launch
PHASE_KERNELS = {
    "index": ("grouped_scores", "kmeans_assign", "kmeans_accumulate"),
    "flat": ("flat_bands_s8", "flat_bands_bf16"),
    "sharded": ("grouped_scores", "kmeans_assign", "kmeans_accumulate"),
    "graft": ("grouped_scores", "kmeans_assign", "kmeans_accumulate"),
    "engine": ("grouped_scores", "kmeans_assign", "kmeans_accumulate"),
    "server": ("grouped_scores", "kmeans_assign", "kmeans_accumulate"),
    "build10m": ("kmeans_assign", "kmeans_accumulate"),
    "serve10m": ("grouped_scores", "flat_bands_s8", "flat_bands_bf16"),
    "engine10m": ("grouped_scores", "kmeans_assign", "kmeans_accumulate"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(bytes_moved, ops, peak_ops) -> dict:
    """The least time the card could take: bytes (each input read once,
    each output written once) over the memory rate, or operations over the
    peak rate of their type, whichever is larger."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / peak_ops * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


def median_ms(torch, fn, runs=20, launches=1):
    """Median CUDA-event time of fn() over `runs` timings, after a warm-up.
    A timing brackets `launches` calls and is divided by them: with one,
    it holds the call's host side (a wrapper's checks and allocations run
    while the card waits) as well as the kernel; with several, the host
    runs ahead and the time is the kernel's own."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(launches):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / launches)
    return float(np.median(times))


# ------------------------------------------ bench.py's 1M corpus and search
# MIN_RECALL's floors were measured on this corpus: its recipe stays bit for
# bit bench.py's (tests/test_torch_scale.py holds make_corpus to it)


def make_corpus(n, dim, k, seed=0):
    """Clustered synthetic corpus (vectorpedia-style locality)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim), dtype=np.float32)
    assign = rng.integers(0, k, size=n)
    out = centers[assign] * np.float32(2.0)
    # chunked f32 noise: ~4x faster than normal() (no f64 intermediate)
    for start in range(0, n, 100_000):
        end = min(start + 100_000, n)
        out[start:end] += rng.standard_normal((end - start, dim), dtype=np.float32)
    return out


def make_queries(data, n_queries, seed=123):
    """bench.py's queries: distinct corpus rows plus 0.1 gaussian noise."""
    rng = np.random.default_rng(seed)
    q_idx = rng.choice(data.shape[0], size=n_queries, replace=False)
    return (
        data[q_idx] + rng.normal(size=(n_queries, data.shape[1])).astype(np.float32) * 0.1
    ).astype(np.float32)


def exact_truth(data, queries, dev) -> np.ndarray:
    """Row numbers [Q, TOPK] of each query's exact-f32 cosine top-10 over
    the rows `data`, on `dev` 64 queries at a time, TF32 off."""
    import torch

    from vectorsearch_tpu_torch.device import check_exact_f32, to_device, to_host
    from vectorsearch_tpu_torch.kernels import cosine

    corpus = cosine.l2_normalize(to_device(data, dev))
    qn = cosine.l2_normalize(to_device(queries, dev))
    check_exact_f32(qn)
    truth = np.concatenate([
        to_host(torch.topk(qn[i : i + 64] @ corpus.T, TOPK, dim=-1).indices)
        for i in range(0, qn.shape[0], 64)
    ]).astype(np.int64)
    del corpus
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return truth


def build_kmeans(packed, k, dev):
    """build_centroids with bench.py's arguments."""
    from vectorsearch_tpu_torch.build import build_centroids

    n = packed.codes.shape[0]
    return build_centroids(
        packed,
        k=k,
        min_cluster_size=max(1, (n // k) // 10),
        max_iters=10,
        superset_iters=4,
        chunk=65_536,
        device=dev,
    )


def query_pool(packed, size, seed=7):
    """`size` distinct queries: rows drawn with numpy `seed`, dequantized,
    plus 0.1 gaussian noise, so their cluster density matches the queries'.
    Distinct, because tiling a few queries would alias repeats into the
    same clusters, shrink the buckets read and overstate QPS."""
    rng = np.random.default_rng(seed)
    pool_idx = rng.choice(packed.codes.shape[0], size=size, replace=False)
    base = (
        np.asarray(packed.offset)[pool_idx, None]
        + np.asarray(packed.scale)[pool_idx, None]
        * np.asarray(packed.codes)[pool_idx].astype(np.float32)
    )
    return (base + rng.normal(size=base.shape).astype(np.float32) * 0.1).astype(np.float32)


def ivf_search(ivf, nprobe):
    """fn(q) -> (scores, global slots) of the search IVFIndex.search(k=10,
    refine=32) dispatches at `nprobe`, on queries already on the device."""
    from vectorsearch_tpu_torch.index.ivf import _scan_refined

    return lambda q: _scan_refined(
        q, ivf.centroids_n, ivf.buckets, ivf.counts_dev, ivf.bucket_mask,
        nprobe=nprobe, k_coarse=REFINE, k=TOPK, folded=ivf.folded,
    )


def slot_ids(ivf):
    """Global bucket slots -> external ids (the host id map)."""
    flat_ids = ivf.ids.reshape(-1)
    return lambda idx: flat_ids[np.clip(idx, 0, flat_ids.size - 1)]


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


# the sources whose ptxas report is printed, each with the kernel named in it
PTXAS_REPORTS = (("kmeans.cu", "kmeans_assign"), ("kmeans.cu", "accumulate"),
                 ("grouped_scan.cu", "grouped_scores"), ("flat.cu", "flat_bands"))
# the kernels of these reports must show no spill and no warning
PTXAS_CLEAN = ("accumulate", "flat_bands")


def phase_build() -> dict:
    """The kernel library, built as the wrappers build it; beside it, one
    more compile of each source of PTXAS_REPORTS with `-Xptxas -v` for
    ptxas's report of its kernel (registers, shared memory, spills) and any
    warning that wgmma was serialized (C7510-C7520). The kernels of
    PTXAS_CLEAN must show no spill and no warning."""
    from vectorsearch_tpu_torch.kernels import _build

    reports = {}
    with tempfile.TemporaryDirectory(prefix="vs_ptxas_") as tmp:
        procs = {
            src: subprocess.Popen(
                [_build._nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-c",
                 os.path.join(_build._CSRC, src), "-o", os.path.join(tmp, src + ".o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in sorted({src for src, _ in PTXAS_REPORTS})
        }
        t0 = time.perf_counter()
        path = _build.load()._name
        secs = time.perf_counter() - t0
        for src, proc in procs.items():
            reports[src] = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc -Xptxas -v {src} failed:\n{reports[src]}")
    log(f"build: {os.path.relpath(path)} in {secs:.2f} s")
    out = {"build_s": secs}
    for src, kernel in PTXAS_REPORTS:
        lines = reports[src].splitlines()
        out[kernel] = []
        for i, line in enumerate(lines):
            if "Function properties for" in line and kernel in line:
                out[kernel].append(" | ".join(ln.strip() for ln in lines[i : i + 3]))
                log(f"ptxas {kernel}: " + out[kernel][-1])
        warned = [ln.strip() for ln in lines if "C75" in ln or "warning" in ln.lower()]
        if sum(src == other for other, _ in PTXAS_REPORTS) > 1:
            warned = [w for w in warned if kernel in w]  # a source of several reports
        out[kernel + "_warnings"] = warned
        log(f"ptxas {src}: {len(warned)} warnings" + "".join("\n  " + w for w in warned[:20]))
    for kernel in PTXAS_CLEAN:
        spilled = [r for r in out[kernel] if "0 bytes spill stores, 0 bytes spill loads" not in r]
        if spilled or out[kernel + "_warnings"] or not out[kernel]:
            raise AssertionError(f"{kernel}: ptxas reports spills or warnings: "
                                 f"{spilled} {out[kernel + '_warnings']}")
    return out


def check_scan(torch, gs, args, gcount, bs, label):
    """grouped_scores against grouped_scores_ref on `args` and the group
    count on the card `gcount`, launched as the search launches it (the
    grid sized by the groups of `args`, build_groups' bound): on the groups
    below the count, the same -inf pattern and no NaN, scores within
    KERNEL_ATOL, and block maxima equal to the maxima of the kernel's own
    scores. Returns (max |err|, out, bmax), out and bmax cut to the groups
    below the count (read after the launch: the check's read, not the
    search's)."""
    out, bmax = gs.grouped_scores(*args, bs, True, gcount)
    torch.cuda.synchronize()
    n = int(gcount)
    out, bmax = out[:n], bmax[:n]
    ref = gs.grouped_scores_ref(*args, bs, False, gcount)[0][:n]
    finite = torch.isfinite(ref)
    if not (torch.equal(torch.isfinite(out), finite)
            and torch.equal(torch.isneginf(out), torch.isneginf(ref))):
        raise AssertionError(f"{label}: -inf pattern differs from plain")
    err = float((out[finite] - ref[finite]).abs().max()) if bool(finite.any()) else 0.0
    if err > KERNEL_ATOL:
        raise AssertionError(f"{label}: max |kernel - plain| {err} > {KERNEL_ATOL}")
    g, qt, cap = out.shape
    if not torch.equal(bmax, out.view(g, qt, cap // bs, bs).amax(-1)):
        raise AssertionError(f"{label}: block maxima differ from the scores' own")
    return err, out, bmax


def scan_timing(torch, dev, smi, label, store, qn, probed_by_nprobe) -> dict:
    """The scan kernel on one bucket store (codes, a, bv, bias, counts) for
    the normalized queries `qn` and each nprobe's probe list: checked
    against plain, then its time, the plain version's, the library
    yardstick's, and its bound on both counts of the bytes."""
    from vectorsearch_tpu_torch.kernels import grouped_scan as gs

    codes, a, bv, bias, counts = store
    kk, cap, d = codes.shape
    b = qn.shape[0]
    live_cols = torch.clamp((counts.long() + 127) // 128 * 128, max=cap)
    by_nprobe = {}
    for nprobe, probed in probed_by_nprobe.items():
        qt, gcl, qidx, _, gcount = gs.build_groups(probed, kk)
        qg, qsum = qn.bfloat16()[qidx], qn.sum(-1)[qidx]
        args = (qg, qsum, gcl, counts, codes, a, bv, bias)
        err, out, bmax = check_scan(torch, gs, args, gcount, 128, f"{label} nprobe={nprobe}")
        ms = median_ms(torch, lambda: gs.grouped_scores(*args, 128, True, gcount), launches=10)
        single_ms = median_ms(torch, lambda: gs.grouped_scores(*args, 128, True, gcount))
        plain_ms = median_ms(torch, lambda: gs.grouped_scores_ref(*args, 128, True, gcount), 5)
        # the groups that count, and the grid's (the bound the search
        # launches with); the yardstick and the bound take the former
        g, g_grid = out.shape[0], int(gcl.numel())
        qg, gcl = qg[:g], gcl[:g]
        # the library yardstick, product only (no sidecars, no maxima, every
        # column of the bucket): torch.bmm of the group rows by their
        # buckets' codes, gathered and widened to bf16 outside the timing,
        # one bmm a 2 GB chunk of gathered codes, all timed together. Where
        # the whole gather does not fit beside the store (the 10M store),
        # each chunk is gathered and timed alone and the times summed
        library_ms, library_note, library_timing = None, None, "all chunks in one timing"
        step = max(1, (2 << 30) // (cap * d * 2))
        try:
            try:
                ops = [(qg[i : i + step],
                        codes[gcl[i : i + step].long()].bfloat16().transpose(1, 2))
                       for i in range(0, g, step)]
                library_ms = median_ms(torch, lambda: [torch.bmm(q, c) for q, c in ops], 5)
            except torch.cuda.OutOfMemoryError:
                ops = None
                torch.cuda.empty_cache()
                library_timing = "each chunk gathered and timed alone, the times summed"
                library_ms = 0.0
                for i in range(0, g, step):
                    q_i = qg[i : i + step]
                    c_i = codes[gcl[i : i + step].long()].bfloat16().transpose(1, 2)
                    library_ms += median_ms(torch, lambda: torch.bmm(q_i, c_i), 5)
                    del c_i
            ops = None
        except RuntimeError as e:  # out of memory, or a shape bmm refuses
            ops, library_ms, library_note = None, None, str(e)[:200]
        torch.cuda.empty_cache()
        # this run's data. The codes and sidecars of the probed clusters read
        # once, the group queries, gcl and counts read, the scores and
        # maxima written. Counted on every slot of a probed bucket (as the
        # runs before the kernel took `counts`), and on the live columns
        # alone: a bucket's slots up to its count rounded up to a whole
        # 128-column tile, which is all that the inputs make anyone read
        pairs = torch.bincount(probed.reshape(-1).long(), minlength=kk)
        hit = pairs > 0
        fixed = (g * qt * (2 * d + 4) + 4 * g + 4 * int(hit.sum())
                 + out.numel() * 4 + bmax.numel() * 4)
        full = bound(int(hit.sum()) * cap * (d + 12) + fixed,
                     2 * b * nprobe * cap * d, PEAK_BF16_FLOPS)
        bnd = bound(int(live_cols[hit].sum()) * (d + 12) + fixed,
                    2 * d * int((pairs * live_cols).sum()), PEAK_BF16_FLOPS)
        r = by_nprobe[nprobe] = {
            "G": g, "G_grid": g_grid, "QT": qt, "max_abs_err": err, "ms": ms,
            "single_launch_ms": single_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_timing": library_timing,
            **bnd, "share": bnd["bound_ms"] / ms,
            "bound_all_slots_ms": full["bound_ms"],
            "share_all_slots": full["bound_ms"] / ms,
            "live_code_GB_per_s": int(live_cols[hit].sum()) * d / ms / 1e6,
        }
        if library_note:
            r["library_note"] = library_note
        lib = f"{library_ms:.3f} ms" if library_ms is not None else f"none ({library_note})"
        log(f"kernel {label} nprobe={nprobe}: G={g} (grid {g_grid}) QT={qt} max_abs_err={err:.3g} "
            f"bmax exact; kernel {ms:.3f} ms (10 launches back to back; one launch "
            f"with the wrapper's host side {single_ms:.3f} ms) vs plain {plain_ms:.3f} ms, "
            f"library {lib} "
            f"(torch.bmm of the bf16 group rows by their buckets' codes widened to bf16: "
            f"product only; {library_timing}); bound on the live columns {bnd['bound_ms']:.3f} ms "
            f"({bnd['bound_by']}), share {r['share']:.3f}; bound on every slot "
            f"{full['bound_ms']:.3f} ms, share {r['share_all_slots']:.3f} "
            f"(medians of 20 / 20 / 5 / 5, {smi})")
        del out, bmax
    return by_nprobe


# the scan kernel's edge cases: (label, K, cap, D, QT, counts per cluster
# (cycled), cluster ids of the groups or None for random ones)
SCAN_EDGES = (
    ("counts 0 / cap / ragged", 6, 512, 128, 8, (0, 512, 100, 129, 70, 448), None),
    ("QT=16", 5, 384, 128, 16, (384, 1, 200, 0, 383), None),
    ("QT=32", 5, 384, 128, 32, (127, 128, 129, 384, 64), None),
    ("cap=64", 4, 64, 128, 8, (64, 0, 33, 1), None),
    ("cap=192", 4, 192, 80, 16, (192, 100, 128, 65), None),
    ("gcl out of range", 3, 256, 128, 8, (256, 200, 10), (-1, 0, 3, 2, 1, 1 << 20)),
    ("D=80", 3, 256, 80, 32, (256, 130, 5), None),
    ("D=16", 3, 128, 16, 8, (128, 64, 0), None),
    ("D=768 QT=32", 4, 1024, 768, 32, (1000, 300, 1024, 0), None),
    ("D=3072 QT=32 (query rows streamed)", 3, 256, 3072, 32, (256, 100, 0), None),
    ("D=3072 QT=8", 3, 256, 3072, 8, (200, 256, 129), None),
)


def scan_edge_cases(torch, dev) -> float:
    """grouped_scores against plain over SCAN_EDGES, with a tenth of the
    live slots tombstoned; returns the worst |err|."""
    from vectorsearch_tpu_torch.kernels import grouped_scan as gs

    worst = 0.0
    for label, kk, cap, d, qt, cnts, ids in SCAN_EDGES:
        gen = torch.Generator(device=dev).manual_seed(kk * cap + d + qt)
        codes = torch.randint(-128, 128, (kk, cap, d), generator=gen, device=dev,
                              dtype=torch.int8)
        a, bv = (torch.rand((kk, cap), generator=gen, device=dev) * 0.01 for _ in range(2))
        counts = torch.tensor([cnts[i % len(cnts)] for i in range(kk)],
                              dtype=torch.int32, device=dev)
        live = torch.rand((kk, cap), generator=gen, device=dev) > 0.1
        col = torch.arange(cap, device=dev)
        bias = torch.where((col[None] < counts[:, None]) & live, 0.0, float("-inf")).float()
        g = 11 if ids is None else len(ids)
        gcl = (torch.randint(0, kk, (g,), generator=gen, device=dev, dtype=torch.int32)
               if ids is None else torch.tensor(ids, dtype=torch.int32, device=dev))
        q = torch.randn((g, qt, d), generator=gen, device=dev)
        q = q / q.norm(dim=-1, keepdim=True)
        qg, qsum = q.bfloat16(), q.sum(-1)
        bs = 128 if cap % 128 == 0 else 64
        inside = (gcl >= 0) & (gcl < kk)
        args = (qg, qsum, gcl, counts, codes, a, bv, bias)
        every = torch.tensor([g], dtype=torch.int32, device=dev)
        err, out, bmax = check_scan(torch, gs, args, every, bs, f"scan edge {label}")
        if not (torch.isneginf(out[~inside]).all() and torch.isneginf(bmax[~inside]).all()):
            raise AssertionError(f"scan edge {label}: a group without a cluster scored")
        again, bmax_again = gs.grouped_scores(*args, bs, True, every)
        torch.cuda.synchronize()
        if not (torch.equal(again, out) and torch.equal(bmax_again, bmax)):
            raise AssertionError(f"scan edge {label}: two launches differ")
        worst = max(worst, err)
        log(f"scan edge {label}: K={kk} cap={cap} D={d} QT={qt} bs={bs} G={g}: "
            f"max_abs_err={err:.3g}, -inf pattern and maxima equal")
    return worst


def phase_kernel(torch, dev, smi: str) -> dict:
    """grouped_scores against grouped_scores_ref: the edge cases, then seeded
    data at the main path's shapes (a synthetic store, its buckets a half to
    all full), the groups from the port's own group build."""
    worst = scan_edge_cases(torch, dev)
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
    probed, q = {}, None
    for nprobe in KERNEL_NPROBES:
        sims = torch.rand((b, kk), generator=gen, device=dev)
        probed[nprobe] = torch.topk(sims, nprobe, dim=-1).indices.to(torch.int32)
        # one query set serves every nprobe (the draw keeps the generator's
        # sequence of the runs before this kernel took `counts`)
        qd = torch.randn((b, d), generator=gen, device=dev)
        q = qd if q is None else q
    q = q / q.norm(dim=-1, keepdim=True)
    by_nprobe = scan_timing(torch, dev, smi, "synthetic store",
                            (codes, a, bv, bias, counts.to(torch.int32)), q, probed)
    del codes, a, bv, bias
    torch.cuda.empty_cache()
    main = by_nprobe[8]
    return {
        "name": "grouped_scores",
        "route": "cuda",
        "source": "vectorsearch_tpu_torch/csrc/grouped_scan.cu",
        "replaces": "vectorsearch_tpu/kernels/pallas_scan.py:131",
        "max_abs_err": max(worst, *(r["max_abs_err"] for r in by_nprobe.values())),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "share": main["share"],
        "library_ms": main["library_ms"],
        "library_call": "torch.bmm of the bf16 group rows by their buckets' codes "
                        "widened to bf16, product only",
        "ms_at": f"nprobe=8, B={b}, K={kk}, cap={cap}, D={d}, synthetic store",
        "by_nprobe": by_nprobe,
    }


def check_accumulate(torch, km, rows, cid, kk, chunk, label):
    """accumulate against accumulate_ref on the same cid: counts equal, sums
    within SUM_RTOL / SUM_ATOL, and a second launch bit-identical. Returns
    (max |sum err|, sums)."""
    sums, counts = km.accumulate(rows, cid, kk)
    again, counts2 = km.accumulate(rows, cid, kk)
    ref_sums, ref_counts = km.accumulate_ref(rows, cid, kk, chunk)
    torch.cuda.synchronize()
    if sums.shape != ref_sums.shape or not torch.equal(counts, ref_counts):
        raise AssertionError(f"accumulate {label}: counts differ from plain")
    err = (sums - ref_sums).abs()
    excess = float((err - SUM_RTOL * ref_sums.abs()).max()) if err.numel() else 0.0
    if not excess <= SUM_ATOL:
        raise AssertionError(f"accumulate {label}: sums beyond rtol {SUM_RTOL} by "
                             f"{excess} > atol {SUM_ATOL}")
    if not (torch.equal(again, sums) and torch.equal(counts2, counts)):
        raise AssertionError(f"accumulate {label}: two launches differ")
    return (float(err.max()) if err.numel() else 0.0), sums


def accumulate_edge_cases(torch, dev) -> float:
    """The accumulate kernels against plain at the edges of the chunked
    design, every case twice: N around a chunk's length, K=1, one cluster
    holding every row, every cluster empty but the last, clusters that end
    on chunk boundaries, a cluster over several chunks among 12-member
    ones, ids outside [0, K) at both ends of the sort, and D of 16, 100
    (the plain-load kernel), 768 and 3072. Returns the worst |sum err|."""
    from vectorsearch_tpu_torch.host import layout
    from vectorsearch_tpu_torch.kernels import kmeans as km

    def ids(*runs):
        """cids of (cluster, members) runs, the rows shuffled."""
        return [c for c, m in runs for _ in range(m)]

    worst, cases = 0.0, []
    for c in ACCUMULATE_EDGE_CHUNKS:
        twelves = [(k, 12) for k in range(20)]
        cases += [(c, f"N={n}", n, 5, 768, None) for n in (0, 1, c - 1, c, c + 1)]
        cases += [
            (c, "K=1", 10 * c + 3, 1, 768, ids((0, 10 * c + 3))),
            (c, "one cluster holds every row", 20 * c + 5, 7, 768, ids((3, 20 * c + 5))),
            (c, "every cluster empty but the last", 3 * c + 7, 9, 3072, ids((8, 3 * c + 7))),
            (c, "clusters end on chunk boundaries", 9 * c, 7, 16,
             ids((0, c), (1, 2 * c), (3, c), (4, 3 * c), (6, 2 * c))),
            (c, "a cluster over 4 chunks among 12-member ones", 480 + 3 * c + 40, 41, 768,
             ids(*twelves, (20, 3 * c + 40), *[(k, 12) for k in range(21, 41)])),
            (c, "ids out of range at both ends", 6 * c + 11, 6, 768, "out of range"),
            (c, "D=100 (plain loads)", 5 * c + 1, 4, 100, None),
            (c, "D=3072", 5 * c + 1, 300, 3072, None),
            (c, "D=16", 5 * c + 1, 3, 16, None),
        ]
    for c, label, n, kk, d, cid_list in cases:
        gen = torch.Generator(device=dev).manual_seed(n + 31 * kk + d)
        rows = layout.PackedVectors(
            torch.randint(-128, 128, (n, d), generator=gen, device=dev, dtype=torch.int8),
            torch.rand((n,), generator=gen, device=dev) * 0.05,
            torch.rand((n,), generator=gen, device=dev) + 0.5,  # sums grow with N
            torch.ones((n,), device=dev))
        if cid_list is None:
            cid = torch.randint(0, kk, (n,), generator=gen, device=dev, dtype=torch.int32)
        elif cid_list == "out of range":
            cid = torch.randint(-3, kk + 3, (n,), generator=gen, device=dev, dtype=torch.int32)
            cid[:2] = torch.tensor([-(2 ** 31), 2 ** 31 - 1], dtype=torch.int32, device=dev)
        else:
            cid = torch.tensor(cid_list, dtype=torch.int32, device=dev)[
                torch.randperm(n, generator=gen, device=dev)]
        km.ACCUMULATE_SCHEDULE = ("", c, 0)
        try:
            err, _ = check_accumulate(torch, km, rows, cid, kk, 4096,
                                      f"edge {label}, {c} rows a chunk")
        finally:
            km.ACCUMULATE_SCHEDULE = ("", 0, 0)
        worst = max(worst, err)
        log(f"accumulate edge {label}: N={n} K={kk} D={d}, {c} rows a chunk "
            f"({km.accumulate_plan(n, d)[0]}): counts equal, max |sum err| {err:.3g}, "
            f"two launches bit-identical")
    return worst


def accumulate_timing(torch, km, rows, cid, kk, smi: str) -> dict:
    """accumulate at one shape under each of ACCUMULATE_ROUTES, in turns
    (chunks, loads, loads, chunks): the whole call, 10 back to back and one
    launch a timing; the kernels alone on tensors sorted outside the timing;
    the torch side (sort, and for "loads" the segments and gathers) alone.
    Then torch's index_add_ of the f32 dequantized rows as the library
    yardstick, and the chunked kernels alone under ACCUMULATE_SCHEDULES."""
    n, d = rows.codes.shape
    turns = {route: [] for route in ACCUMULATE_ROUTES}
    for route in (*ACCUMULATE_ROUTES, *reversed(ACCUMULATE_ROUTES)):
        km.ACCUMULATE_SCHEDULE = (route, 0, 0)
        try:
            plan = km.accumulate_plan(n, d)
            glue = km.accumulate_sort(rows, cid, kk, route)
            turns[route].append({
                "ms": median_ms(torch, lambda: km.accumulate(rows, cid, kk), launches=10),
                "single_launch_ms": median_ms(torch, lambda: km.accumulate(rows, cid, kk)),
                "kernel_ms": median_ms(
                    torch, lambda: km.accumulate_launch(rows, kk, plan, glue), launches=10),
                "glue_ms": median_ms(
                    torch, lambda: km.accumulate_sort(rows, cid, kk, route), launches=10),
            })
            del glue
        finally:
            km.ACCUMULATE_SCHEDULE = ("", 0, 0)
    out = {route: {f: float(np.mean([t[f] for t in ts])) for f in ts[0]}
           for route, ts in turns.items()}
    for route, ts in turns.items():
        out[route]["turns"] = ts
    # the library yardstick: one index_add_ of the dequantized f32 rows, made
    # outside the timing (4 bytes a value where the kernel reads 1; atomics)
    try:
        v = rows.offset[:, None] + rows.scale[:, None] * rows.codes.float()
        idx = cid.long()
        out["library_ms"] = median_ms(torch, lambda: torch.zeros(
            (kk, d), dtype=torch.float32, device=v.device).index_add_(0, idx, v), 5)
        del v, idx
    except RuntimeError as e:  # out of memory
        out["library_ms"], out["library_note"] = None, str(e)[:200]
    torch.cuda.empty_cache()
    # what the torch side does not do, timed: 16-bit sort keys (the cast,
    # then the sort) and an int32 copy of the order for the kernel to read
    glue = km.accumulate_sort(rows, cid, kk, "chunks")
    cid16 = cid.to(torch.int16)
    out["torch_side_variants"] = {
        "ids to int16": median_ms(torch, lambda: cid.to(torch.int16), launches=10),
        "sort of int16 ids": median_ms(
            torch, lambda: torch.sort(cid16, stable=True), launches=10),
        "order to int32": median_ms(torch, lambda: glue[1].to(torch.int32), launches=10),
    }
    out["schedules"] = {}
    for label, chunk_rows, stages in ACCUMULATE_SCHEDULES:
        km.ACCUMULATE_SCHEDULE = ("chunks", chunk_rows, stages)
        try:
            plan = km.accumulate_plan(n, d)
            out["schedules"][label] = median_ms(
                torch, lambda: km.accumulate_launch(rows, kk, plan, glue), launches=10)
        finally:
            km.ACCUMULATE_SCHEDULE = ("", 0, 0)
    out["chunk_rows"] = km.accumulate_plan(n, d)[1]
    for route in ACCUMULATE_ROUTES:
        r = out[route]
        log(f"accumulate N={n} D={d} K={kk} route {route}: whole call {r['ms']:.3f} ms (10 back "
            f"to back), {r['single_launch_ms']:.3f} ms one launch; kernels alone "
            f"{r['kernel_ms']:.3f} ms; torch side alone {r['glue_ms']:.3f} ms (means of two "
            f"turns' medians of 20; turns {[round(t['ms'], 3) for t in r['turns']]}; {smi})")
    lib = (f"{out['library_ms']:.3f} ms" if out["library_ms"] is not None
           else f"none ({out['library_note']})")
    log(f"accumulate N={n} D={d} K={kk}: library {lib} (zeros(K, D).index_add_(0, cid, v), v "
        f"the f32 dequantized rows made outside the timing; {smi}); the chunked kernels "
        f"alone under other schedules (the rule: {out['chunk_rows']} rows a chunk, "
        f"{out['chunks']['kernel_ms']:.3f} ms): " + "; ".join(
            f"{label} {ms:.3f}" for label, ms in out["schedules"].items())
        + "; not done on the torch side (ms): " + "; ".join(
            f"{label} {ms:.3f}" for label, ms in out["torch_side_variants"].items()))
    return out


def phase_kmeans_kernels(torch, dev, smi: str) -> list:
    """assign and accumulate against their plain versions on clustered
    packed rows, with centroids drawn from the rows (sample_init's way)."""
    from vectorsearch_tpu_torch.tools.scale_corpus import packed_on_card
    from vectorsearch_tpu_torch.host import layout
    from vectorsearch_tpu_torch.kernels import kmeans as km

    worst_edge = accumulate_edge_cases(torch, dev)
    n_max = max(n for n, _, _ in KMEANS_SHAPES)
    parts = [p for _, p in packed_on_card(dev, n_max, DIM, K_GEN, seed=1)]
    full = layout.PackedVectors(*[torch.cat(a) for a in zip(*parts)])
    del parts
    by_shape, worst_gap, worst_sum = {}, 0.0, 0.0
    for n, kk, chunk in KMEANS_SHAPES:
        rows = layout.PackedVectors(*[a[:n] for a in full])
        gen = torch.Generator(device=dev).manual_seed(kk)
        pick = torch.randperm(n, generator=gen, device=dev)[:kk]
        cents = rows.offset[pick, None] + rows.scale[pick, None] * rows.codes[pick].float()
        _, csum, cn_bf16 = km._normalize(cents)
        cn_bf16 = cn_bf16.contiguous()
        cid = km.assign(rows, cn_bf16, csum)
        want = km.assign_ref(rows, cn_bf16, csum, chunk)
        torch.cuda.synchronize()
        moved = torch.nonzero(cid != want).flatten()
        gap = 0.0
        if moved.numel():
            sims = km.assign_scores_ref(
                layout.PackedVectors(*[a[moved] for a in rows]), cn_bf16, csum)
            gap = float((sims.gather(1, want[moved, None].long())
                         - sims.gather(1, cid[moved, None].long())).abs().max())
        if gap > TIE_ATOL:
            raise AssertionError(f"assign N={n} K={kk}: {moved.numel()} rows differ "
                                 f"from plain, widest sim gap {gap} > {TIE_ATOL}")
        sum_err, sums = check_accumulate(torch, km, rows, cid, kk, chunk, f"N={n} K={kk}")
        # the plain-load kernel on the same input, and the two against each other
        km.ACCUMULATE_SCHEDULE = ("loads", 0, 0)
        try:
            loads_err, loads_sums = check_accumulate(torch, km, rows, cid, kk, chunk,
                                                     f"N={n} K={kk} (plain loads)")
        finally:
            km.ACCUMULATE_SCHEDULE = ("", 0, 0)
        routes_gap = float((sums - loads_sums).abs().max())
        del sums, loads_sums
        plain_runs = 5
        acc = accumulate_timing(torch, km, rows, cid, kk, smi)
        r = {
            "N": n, "K": kk, "cid_moved": int(moved.numel()), "max_tie_gap": gap,
            "max_abs_sum_err": sum_err, "max_abs_sum_err_plain_loads": loads_err,
            "max_abs_gap_between_routes": routes_gap,
            "assign_ms": median_ms(torch, lambda: km.assign(rows, cn_bf16, csum)),
            "assign_plain_ms": median_ms(
                torch, lambda: km.assign_ref(rows, cn_bf16, csum, chunk), plain_runs),
            "accumulate_ms": acc["chunks"]["ms"],
            "accumulate_plain_ms": median_ms(
                torch, lambda: km.accumulate_ref(rows, cid, kk, chunk), plain_runs),
            "accumulate_library_ms": acc["library_ms"],
            "accumulate_timing": acc,
        }
        # assign: 2 N K D bf16 flops; the codes, sidecars and centroids read
        # once, cid written. accumulate: the codes, scale, offset and cid
        # read once, sums and counts written (f32 adds on the CUDA cores)
        r["assign_bound"] = bound(n * DIM + 16 * n + kk * (2 * DIM + 4),
                                  2 * n * kk * DIM, PEAK_BF16_FLOPS)
        r["accumulate_bound"] = bound(n * DIM + 12 * n + kk * (4 * DIM + 4),
                                      2 * n * DIM, PEAK_F32_FLOPS)
        r["assign_share"] = r["assign_bound"]["bound_ms"] / r["assign_ms"]
        r["accumulate_share"] = r["accumulate_bound"]["bound_ms"] / r["accumulate_ms"]
        r["accumulate_kernel_share"] = (r["accumulate_bound"]["bound_ms"]
                                        / acc["chunks"]["kernel_ms"])
        # the library yardstick, product only (no sidecars, no argmax): one
        # torch.matmul of the bf16 codes, widened outside the timing, by
        # cn_bf16^T per LIBRARY_CHUNK rows
        codes_bf16 = rows.codes.to(torch.bfloat16)
        r["assign_library_ms"] = median_ms(torch, lambda: [
            codes_bf16[lo : lo + LIBRARY_CHUNK] @ cn_bf16.T
            for lo in range(0, n, LIBRARY_CHUNK)], plain_runs)
        del codes_bf16
        by_shape[f"{n}x{kk}"] = r
        worst_gap = max(worst_gap, gap)
        worst_sum = max(worst_sum, r["max_abs_sum_err"])
        log(f"kmeans kernels N={n} D={DIM} K={kk}: assign {r['assign_ms']:.3f} ms vs plain "
            f"{r['assign_plain_ms']:.3f} ms, bound {r['assign_bound']['bound_ms']:.3f} ms "
            f"({r['assign_bound']['bound_by']}), share {r['assign_share']:.3f}, library "
            f"{r['assign_library_ms']:.3f} ms (torch.matmul of bf16 codes by cn_bf16^T in "
            f"{LIBRARY_CHUNK}-row chunks: product only, no sidecars or argmax), "
            f"{r['cid_moved']} cids differ (widest sim gap "
            f"{gap:.3g}); accumulate {r['accumulate_ms']:.3f} ms (the whole call, 10 back to "
            f"back) vs plain "
            f"{r['accumulate_plain_ms']:.3f} ms, bound {r['accumulate_bound']['bound_ms']:.3f} "
            f"ms ({r['accumulate_bound']['bound_by']}), share {r['accumulate_share']:.3f} "
            f"(its kernels alone {r['accumulate_kernel_share']:.3f}), "
            f"counts equal, max |sum err| "
            f"{r['max_abs_sum_err']:.3g} (the plain-load kernel {loads_err:.3g}; between the "
            f"two {routes_gap:.3g}), bit-identical relaunch (median of 20 / "
            f"{plain_runs}, {smi})")
        del want, cid
    sweep = assign_sweep(torch, dev, full, smi)
    del full
    torch.cuda.empty_cache()
    main = by_shape[f"{KMEANS_MAIN[0]}x{KMEANS_MAIN[1]}"]
    at = f"N={KMEANS_MAIN[0]}, K={KMEANS_MAIN[1]}, D={DIM}"
    src = "vectorsearch_tpu_torch/csrc/kmeans.cu"
    return [
        {"name": "kmeans_assign", "route": "cuda", "source": src,
         "replaces": "vectorsearch_tpu/kernels/pallas_kmeans.py:58",
         "max_abs_err": worst_gap, "ms": main["assign_ms"],
         "plain_ms": main["assign_plain_ms"], **main["assign_bound"],
         "share": main["assign_share"], "library_ms": main["assign_library_ms"],
         "library_call": "torch.matmul of bf16 codes by cn_bf16^T, product only",
         "ms_at": at,
         "by_shape": {k: {f: v[f] for f in ("cid_moved", "max_tie_gap", "assign_ms",
                                              "assign_plain_ms", "assign_bound",
                                              "assign_share", "assign_library_ms")}
                      for k, v in by_shape.items()},
         "k_sweep": sweep},
        {"name": "kmeans_accumulate", "route": "cuda", "source": src,
         "replaces": "vectorsearch_tpu/kernels/pallas_kmeans.py:100",
         "max_abs_err": max(worst_sum, worst_edge), "ms": main["accumulate_ms"],
         "plain_ms": main["accumulate_plain_ms"], **main["accumulate_bound"],
         "share": main["accumulate_share"],
         "library_ms": main["accumulate_library_ms"],
         "library_call": "torch.zeros(K, D).index_add_(0, cid, v) with v the f32 "
                         "dequantized rows made outside the timing (atomics)",
         "ms_at": at + ", the whole call with its sort, 10 back to back",
         "by_shape": {k: {f: v[f] for f in ("max_abs_sum_err", "accumulate_ms",
                                              "accumulate_plain_ms", "accumulate_bound",
                                              "accumulate_share", "accumulate_kernel_share",
                                              "accumulate_library_ms", "accumulate_timing",
                                              "max_abs_sum_err_plain_loads",
                                              "max_abs_gap_between_routes")}
                      for k, v in by_shape.items()}},
    ]


def assign_sweep(torch, dev, full, smi: str) -> dict:
    """assign's time at each ASSIGN_SWEEP shape, with its bf16 rate and the
    rate at which its blocks read cn (ceil(N / 128) blocks, each reading all
    K x D bf16 of it), and per N the least-squares line t = a + b K."""
    from vectorsearch_tpu_torch.host import layout
    from vectorsearch_tpu_torch.kernels import kmeans as km

    out = {}
    for n, ks in ASSIGN_SWEEP:
        rows = layout.PackedVectors(*[a[:n] for a in full])
        times = []
        for kk in ks:
            gen = torch.Generator(device=dev).manual_seed(kk)
            pick = torch.randperm(n, generator=gen, device=dev)[:kk]
            cents = rows.offset[pick, None] + rows.scale[pick, None] * rows.codes[pick].float()
            _, csum, cn_bf16 = km._normalize(cents)
            cn_bf16 = cn_bf16.contiguous()
            ms = median_ms(torch, lambda: km.assign(rows, cn_bf16, csum))
            times.append(ms)
            out[f"{n}x{kk}"] = {
                "ms": ms, "TFLOP_per_s": 2 * n * kk * DIM / ms / 1e9,
                "cn_read_TB_per_s": -(-n // 128) * kk * DIM * 2 / ms / 1e9,
            }
        b, a = np.polyfit(np.array(ks, float), np.array(times), 1)
        out[f"{n}_line"] = {"a_ms": float(a), "b_us_per_centroid": float(b) * 1e3}
        log(f"assign sweep N={n} D={DIM}: " + "; ".join(
            f"K={kk} {out[f'{n}x{kk}']['ms']:.3f} ms "
            f"({out[f'{n}x{kk}']['TFLOP_per_s']:.0f} TFLOP/s, cn read "
            f"{out[f'{n}x{kk}']['cn_read_TB_per_s']:.2f} TB/s)" for kk in ks)
            + f"; line t = {a:.4f} ms + {b * 1e3:.4f} us x K (median of 20, {smi})")
    return out


def band_row(torch, name, fn, ref, args, runs=20, plain_runs=5) -> dict:
    """One band kernel's time on `args` (queries, their sidecars, then the
    corpus's codes, a, bv, bias): 10 launches back to back and one launch
    with its wrapper, the plain version's, rates, the bound and its share,
    and the library yardstick, product only (torch._int_mm of the s8
    queries by the codes^T, or the bf16 queries by the codes widened to
    bf16), on operands made ready outside the timing."""
    from vectorsearch_tpu_torch.kernels import flat as tf

    q, codes = args[0], args[-4]
    b, (n, d) = q.shape[0], codes.shape
    r = {"ms": median_ms(torch, lambda: fn(*args), runs, launches=10),
         "single_launch_ms": median_ms(torch, lambda: fn(*args), runs),
         "plain_ms": median_ms(torch, lambda: ref(*args), plain_runs)}
    r["TOP_per_s"] = 2 * b * n * d / r["ms"] / 1e9
    # the codes and sidecars read once, the query rows and their sidecars
    # read once, every band written once
    moved = n * d + 12 * n + b * -(-n // tf.TILE_N) * tf.BAND_LANES * 4
    r["GB_per_s"] = moved / r["ms"] / 1e6
    q_bytes = b * (d + 8 if name == "flat_bands_s8" else 2 * d + 4)
    r.update(bound(moved + q_bytes, 2 * b * n * d,
                   PEAK_INT8_OPS if name == "flat_bands_s8" else PEAK_BF16_FLOPS))
    r["bound_by_bytes_ms"] = (moved + q_bytes) / PEAK_BYTES_PER_S * 1e3
    r["share"] = r["bound_ms"] / r["ms"]
    try:
        if name == "flat_bands_s8":
            r["library_call"] = "torch._int_mm of the s8 queries by the codes^T, product only"
            codes_t = codes.T
            r["library_ms"] = median_ms(torch, lambda: torch._int_mm(q, codes_t), plain_runs)
        else:
            r["library_call"] = ("torch.matmul of the bf16 queries by the codes widened to "
                                 "bf16, transposed, product only")
            codes_t = codes.bfloat16().T
            r["library_ms"] = median_ms(torch, lambda: q @ codes_t, plain_runs)
    except RuntimeError as e:  # out of memory, or a shape the call refuses
        r["library_ms"], r["library_note"] = None, str(e)[:200]
    codes_t = None
    torch.cuda.empty_cache()
    return r


def check_bands(torch, name, fn, ref, args, label):
    """One band kernel against its plain version on `args`: the same -inf
    pattern, s8 bit-equal, bf16 within KERNEL_ATOL, and a second launch
    bit-equal to the first. Returns max |err| over the finite bands."""
    out = fn(*args)
    again = fn(*args)
    want = ref(*args)
    torch.cuda.synchronize()
    if not torch.equal(torch.isneginf(out), torch.isneginf(want)):
        raise AssertionError(f"{name} {label}: -inf pattern differs from plain")
    if torch.isnan(out).any():
        raise AssertionError(f"{name} {label}: NaN bands")
    fin = torch.isfinite(want)
    err = float((out[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    if name == "flat_bands_s8" and not torch.equal(out, want):
        raise AssertionError(f"{name} {label}: not bit-equal to plain (max err {err})")
    if err > KERNEL_ATOL:
        raise AssertionError(f"{name} {label}: max |kernel - plain| {err} > {KERNEL_ATOL}")
    if not torch.equal(out, again):
        raise AssertionError(f"{name} {label}: two launches differ")
    return err


def flat_edge_cases(torch, dev) -> dict:
    """Both band kernels against plain over FLAT_EDGE_N x FLAT_EDGE_B with
    the widths of FLAT_EDGE_D cycled over them, a tenth of the rows dead;
    then a wholly dead tile and an all-dead corpus. Returns the worst |err|
    per kernel."""
    from vectorsearch_tpu_torch.kernels import cosine
    from vectorsearch_tpu_torch.kernels import flat as tf

    cases = [(n, b, FLAT_EDGE_D[(i + k) % len(FLAT_EDGE_D)], None)
             for i, n in enumerate(FLAT_EDGE_N) for k, b in enumerate(FLAT_EDGE_B)]
    cases += [(3100, 70, 768, (1024, 2048)), (1500, 130, 128, (0, 1500))]
    worst = {"flat_bands_s8": 0.0, "flat_bands_bf16": 0.0}
    for n, b, d, dead in cases:
        gen = torch.Generator(device=dev).manual_seed(n + 7 * b + d)
        codes = torch.randint(-128, 128, (n, d), generator=gen, device=dev, dtype=torch.int8)
        a = torch.rand((n,), generator=gen, device=dev) * 0.01
        bv = torch.rand((n,), generator=gen, device=dev) * 0.01 - 0.005
        gone = torch.rand((n,), generator=gen, device=dev) < 0.1
        if dead is not None:
            row = torch.arange(n, device=dev)
            gone = (row >= dead[0]) & (row < dead[1])
        bias = torch.where(gone, float("-inf"), 0.0)
        qn = cosine.l2_normalize(torch.randn((b, d), generator=gen, device=dev))
        qc, sq, qsum = cosine.quantize_queries(qn)
        corpus = (codes, a, bv, bias)
        errs = {}
        for name, fn, ref, args in (
            ("flat_bands_s8", tf.flat_bands_s8, tf.flat_bands_s8_ref, (qc, sq, qsum, *corpus)),
            ("flat_bands_bf16", tf.flat_bands_bf16, tf.flat_bands_bf16_ref,
             (qn.bfloat16(), qsum, *corpus)),
        ):
            errs[name] = check_bands(torch, name, fn, ref, args, f"edge N={n} B={b} D={d}")
            worst[name] = max(worst[name], errs[name])
        if dead is not None:
            lo, hi = dead[0] // tf.TILE_N * tf.BAND_LANES, dead[1] // tf.TILE_N * tf.BAND_LANES
            if not torch.isneginf(tf.flat_bands_s8(qc, sq, qsum, *corpus)[:, lo:hi]).all():
                raise AssertionError(f"flat edge N={n}: a dead tile scored")
        log(f"flat edge N={n} B={b} D={d}" + (f" rows {dead} dead" if dead else "")
            + f": s8 bit-equal, bf16 max_abs_err={errs['flat_bands_bf16']:.3g}, -inf "
              f"pattern equal, two launches bit-equal")
    return worst


def phase_flat_kernels(torch, dev, smi: str, ptxas: dict) -> list:
    """flat_bands_s8 and flat_bands_bf16 against their plain versions: the
    edge cases, then clustered packed rows made on the card, a hundredth of
    them dead, with B queries near corpus rows, at each of FLAT_SHAPES;
    timed at the first, under the launch rule and under FLAT_SCHEDULES."""
    from vectorsearch_tpu_torch.tools.scale_corpus import packed_on_card
    from vectorsearch_tpu_torch.host import layout
    from vectorsearch_tpu_torch.kernels import cosine
    from vectorsearch_tpu_torch.kernels import flat as tf

    worst = flat_edge_cases(torch, dev)
    n_max = max(FLAT_SHAPES)
    parts = [p for _, p in packed_on_card(dev, n_max, DIM, K_GEN, seed=2)]
    full = layout.PackedVectors(*[torch.cat(a) for a in zip(*parts)])
    del parts
    gen = torch.Generator(device=dev).manual_seed(3)
    pick = torch.randint(0, n_max, (N_QUERIES,), generator=gen, device=dev)
    q = full.offset[pick, None] + full.scale[pick, None] * full.codes[pick].float()
    qn = cosine.l2_normalize(q + 0.1 * torch.randn(q.shape, generator=gen, device=dev))
    qc, sq, qsum = cosine.quantize_queries(qn)
    q_bf16 = qn.bfloat16()
    live = torch.rand((n_max,), generator=gen, device=dev) > 0.01
    a = full.scale * full.inv_norm
    bv = full.offset * full.inv_norm
    bias = torch.where(live, 0.0, float("-inf"))
    res = {"flat_bands_s8": {}, "flat_bands_bf16": {}}
    for n in FLAT_SHAPES:
        corpus = (full.codes[:n], a[:n], bv[:n], bias[:n])
        for name, fn, ref, args in (
            ("flat_bands_s8", tf.flat_bands_s8, tf.flat_bands_s8_ref, (qc, sq, qsum, *corpus)),
            ("flat_bands_bf16", tf.flat_bands_bf16, tf.flat_bands_bf16_ref,
             (q_bf16, qsum, *corpus)),
        ):
            err = check_bands(torch, name, fn, ref, args, f"N={n}")
            r = {"max_abs_err": err}
            if n == FLAT_SHAPES[0]:
                r.update(band_row(torch, name, fn, ref, args))
                tiles = -(-n // tf.TILE_N)
                # the same launch under other schedules (the kernel's own
                # time, 10 launches back to back)
                r["schedules"] = {}
                for label, lanes, stages, qblock in FLAT_SCHEDULES:
                    tf.SCHEDULE = (tiles if lanes is None else lanes, stages, qblock)
                    try:
                        r["schedules"][label] = median_ms(torch, lambda: fn(*args), launches=10)
                    except RuntimeError:  # a ring deeper than this kernel's room
                        r["schedules"][label] = None
                    finally:
                        tf.SCHEDULE = (0, 0, 0)
                lib = (f"{r['library_ms']:.3f} ms" if r["library_ms"] is not None
                       else f"none ({r['library_note']})")
                log(f"{name} N={n} D={DIM} B={N_QUERIES}: library {lib} ({r['library_call']})")
                log(f"{name} N={n} D={DIM} B={N_QUERIES}: kernel {r['ms']:.3f} ms (10 launches "
                    f"back to back; one launch with the wrapper's host side "
                    f"{r['single_launch_ms']:.3f} ms) vs plain {r['plain_ms']:.3f} ms (medians "
                    f"of 20 / 20 / 5, {smi}), {r['TOP_per_s']:.1f} TOP/s, "
                    f"{r['GB_per_s']:.1f} GB/s, bound {r['bound_ms']:.3f} ms "
                    f"({r['bound_by']} bind; by bytes {r['bound_by_bytes_ms']:.3f} ms), share "
                    f"{r['share']:.3f}, max |err| {err:.3g}")
                log(f"{name} N={n} under other schedules (ms, 10 launches back to back; the "
                    f"launch rule {r['ms']:.3f}): " + "; ".join(
                        f"{label} " + ("refused" if ms is None else f"{ms:.3f}")
                        for label, ms in r["schedules"].items()))
            else:
                log(f"{name} N={n}: max |kernel - plain| {err:.3g}, -inf pattern equal, "
                    f"two launches bit-equal")
            res[name][n] = r
    del full, a, bv, bias
    torch.cuda.empty_cache()
    at = f"B={N_QUERIES}, N={FLAT_SHAPES[0]}, D={DIM}"
    return [
        {"name": name, "route": "cuda", "source": "vectorsearch_tpu_torch/csrc/flat.cu",
         "replaces": f"vectorsearch_tpu/kernels/pallas_flat.py:{line}",
         "max_abs_err": max(worst[name], *(r["max_abs_err"] for r in res[name].values())),
         "ms": res[name][FLAT_SHAPES[0]]["ms"], "plain_ms": res[name][FLAT_SHAPES[0]]["plain_ms"],
         **{f: res[name][FLAT_SHAPES[0]][f]
            for f in ("single_launch_ms", "bound_ms", "bound_by", "share", "library_ms",
                      "library_call", "schedules")},
         "ms_at": at + ", 10 launches back to back", "by_n": res[name],
         "ptxas": [r for r in ptxas["flat_bands"] if f"ILb{int(name == 'flat_bands_s8')}E" in r],
         "ptxas_warnings": ptxas["flat_bands_warnings"]}
        for name, line in (("flat_bands_s8", 85), ("flat_bands_bf16", 54))
    ]


def phase_index(torch, dev, smi="", n=N, dim=DIM, k_gen=K_GEN, n_queries=N_QUERIES) -> dict:
    """bench.py's corpus through the port's build and search. The packed
    corpus, the queries and the truth go on to phase_flat, the build and
    the index before any write to phase_sharded; the scan kernel is timed
    on the built index's own store under "scan" (those launches are taken
    out of the phase's count), and bulk_check runs before the writes."""
    from vectorsearch_tpu_torch.host import layout
    from vectorsearch_tpu_torch.index import IVFIndex
    from vectorsearch_tpu_torch.kernels import cosine
    from vectorsearch_tpu_torch.kernels import grouped_scan as gs

    t0 = time.perf_counter()
    data = make_corpus(n, dim, k_gen)
    packed = layout.pack_float(data)
    queries = make_queries(data, n_queries)
    ids = np.arange(1, n + 1, dtype=np.int64)
    truth = exact_truth(data, queries, dev)  # on the card, TF32 off
    del data
    truth_ids = ids[truth]
    log(f"index: corpus {n}x{dim}, queries and f32 truth in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    result = build_kmeans(packed, k_gen, dev)
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

    # the scan kernel on this index's store, the groups from the real probe
    # of the queries: what the searches above launched
    launches_before = gs.LAUNCHES
    qn_dev = cosine.l2_normalize(torch.from_numpy(queries).to(dev))
    scan = scan_timing(
        torch, dev, smi, f"index store K={ivf.k_clusters} cap={ivf.cap}",
        (ivf.buckets.codes, *ivf.folded, ivf.counts_dev), qn_dev,
        {p: gs.probe(qn_dev, ivf.centroids_n, p) for p in KERNEL_NPROBES
         if p <= ivf.k_clusters})
    wall_ms = {p: n_queries / q * 1e3 for p, q in qps.items()}
    profile = profile_search(torch, ivf, queries, wall_ms, smi) if dev.type == "cuda" else {}
    gs.LAUNCHES = launches_before
    fill = float(ivf.counts.sum()) / (ivf.k_clusters * ivf.cap)
    log(f"index store: {ivf.k_clusters} x {ivf.cap} slots, {fill:.3f} of them below their "
        f"cluster's count; folded sidecar rows "
        f"{sum(t.numel() * 4 for t in ivf.folded) / 2**20:.1f} MiB on {smi}")
    bulk = bulk_check(torch, dev, packed, queries, truth_ids, ivf)

    # the sharded phase's inputs: this build, and the index before any write
    sharded_inputs = (packed, ids, result.centroids, result.assignments, queries,
                      truth_ids, ivf)
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
        "expected_live": n + m - gone.size, "flat_inputs": (packed, queries, truth),
        "sharded_inputs": sharded_inputs, "scan": scan, "search_profile": profile,
        "bulk": bulk,
    }


# device time of a search by kind of kernel: the first name part that
# matches, in this order (torch.profiler's kernel names)
SEARCH_KERNEL_KINDS = (
    ("scan kernel", ("grouped_scores",)),
    ("memcpy", ("Memcpy", "Memset")),
    ("gemm", ("gemm", "cutlass", "xmma", "cublas")),
    ("top-k/sort", ("topk", "TopK", "sort", "Sort", "radix", "bitonic")),
    ("gather", ("gather", "index", "Index", "scatter")),
)


def profile_search(torch, ivf, queries, wall_ms, smi, reps=5) -> dict:
    """`reps` B=512 searches per nprobe under torch.profiler: device time a
    search summed by kind of kernel (CUDA rows only) and, against the
    unprofiled wall `wall_ms[nprobe]` (the profiler slows the host), the
    share of a search during which the card is busy."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for nprobe in NPROBES:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                ivf.search(queries, k=TOPK, nprobe=nprobe, refine=REFINE)
            torch.cuda.synchronize()
        kinds = {kind: 0.0 for kind, _ in SEARCH_KERNEL_KINDS}
        kinds["elementwise and other"] = 0.0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            kind = next((kind for kind, parts in SEARCH_KERNEL_KINDS
                         if any(p in e.key for p in parts)), "elementwise and other")
            kinds[kind] += e.self_device_time_total / 1e3 / reps
        device = sum(kinds.values())
        out[nprobe] = {"wall_ms": wall_ms[nprobe], "device_ms": device,
                       "busy_share": device / wall_ms[nprobe], "by_kind_ms": kinds}
        log(f"search profile nprobe={nprobe}: wall {wall_ms[nprobe]:.4f} ms a B={queries.shape[0]} "
            f"search (unprofiled, host clock), device {device:.4f} ms, busy share "
            f"{device / wall_ms[nprobe]:.2f}; " + "; ".join(
                f"{kind} {ms:.4f}" for kind, ms in kinds.items()) + f" ({smi})")
    return out


def phase_flat(torch, dev, packed, queries, truth) -> dict:
    """flat_search with each band kernel, and the streamed scan
    FlatIndex.search(refine=32) that serves today, on phase_index's corpus
    and queries against its exact-f32 truth (row numbers)."""
    from vectorsearch_tpu_torch.host import layout
    from vectorsearch_tpu_torch.index import FlatIndex
    from vectorsearch_tpu_torch.kernels import flat as tf

    n, b = packed.codes.shape[0], queries.shape[0]

    def judge(s, i):
        """recall@10 against the truth, results with an id twice, and
        whether every score is a finite cosine of the expected shape."""
        return {
            "recall": float(np.mean([len(set(i[r]) & set(truth[r])) / TOPK for r in range(b)])),
            "repeats": int(sum(len(set(row)) < TOPK for row in i)),
            "finite": bool(s.shape == (b, TOPK) and np.isfinite(s).all()
                           and (np.abs(s) <= 1 + 1e-5).all()),
        }

    def wall_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    out = {}
    corpus = layout.PackedVectors(*[torch.from_numpy(a).to(dev) for a in packed])
    q = torch.from_numpy(queries).to(dev)
    for use_s8, name in ((True, "s8"), (False, "bf16")):
        def search():
            return tf.flat_search(q, corpus, n, k=TOPK, k_bands=FLAT_KBANDS, use_s8=use_s8)

        out[name] = judge(*(t.cpu().numpy() for t in search()))
        out[name]["wall_ms"] = wall_ms(search)
        log(f"flat_search {name} (k={TOPK}, k_bands={FLAT_KBANDS}): recall@10 "
            f"{out[name]['recall']:.4f}, {out[name]['wall_ms']:.3f} ms per B={b} search "
            f"(host clock, synchronized), {out[name]['repeats']} results with a repeated id")
    del corpus
    torch.cuda.empty_cache()
    flat = FlatIndex.from_packed(packed, np.arange(n, dtype=np.int64), device=dev)
    out["flatindex"] = judge(*flat.search(queries, k=TOPK, refine=REFINE))
    out["flatindex"]["wall_ms"] = wall_ms(lambda: flat.search(queries, k=TOPK, refine=REFINE))
    log(f"FlatIndex.search refine={REFINE}: recall@10 {out['flatindex']['recall']:.4f}, "
        f"{out['flatindex']['wall_ms']:.3f} ms per B={b} search")
    return out


def sharded_ivf_checks(got_s, got_i, want_s, want_i, truth_ids) -> dict:
    """A sharded search's (scores, ids) against the single-device index's
    on the same centroids and the truth: recall@10, rows with an id twice,
    rows whose top-10 set differs other than at a tie (within TIE_SHARDED),
    the largest score difference, and whether every score is a finite
    cosine."""
    from vectorsearch_tpu_torch.tools.scale_corpus import sets_differ

    rows = range(got_i.shape[0])
    return {
        "recall": float(np.mean([len(set(got_i[r]) & set(truth_ids[r])) / TOPK for r in rows])),
        "repeats": int(sum(len(set(got_i[r])) < TOPK for r in rows)),
        "sets_differ": sets_differ(got_s, got_i, want_s, want_i, TIE_SHARDED),
        "max_score_diff": float(np.abs(got_s - want_s).max()),
        "finite": bool(np.isfinite(got_s).all() and (np.abs(got_s) <= 1 + 1e-5).all()),
    }


def sharded_entry_check(world: int) -> dict:
    """`world` child processes that join one process group through
    maybe_initialize (`nccl` on cards), each driving one card (VSTPU_DEVICE
    = cuda:rank; one process keeps the default), build a ShardedIVF over
    global_mesh() and search it in lockstep against IVFIndex on the same
    centroids on their own card: the collective path, at world size 1 on a
    machine with one card."""
    from vectorsearch_tpu_torch.tools.http_driver import free_port

    code = r"""
import json, sys
import numpy as np
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from vectorsearch_tpu_torch.host import layout
from vectorsearch_tpu_torch.index import IVFIndex, assign_clusters
from vectorsearch_tpu_torch.parallel import ShardedIVF
from vectorsearch_tpu_torch.parallel.distributed import global_mesh, maybe_initialize

world, rank = int(sys.argv[3]), int(sys.argv[4])
assert maybe_initialize(sys.argv[2], world, rank)
mesh = global_mesh(1 if world > 1 else None)
data = cs.make_corpus(50_000, cs.DIM, 64, seed=3)
packed, q = layout.pack_float(data), cs.make_queries(data, 256)
ids = np.arange(1, 50_001, dtype=np.int64)
cents = data[np.random.default_rng(4).choice(50_000, 64, replace=False)]
assign = assign_clusters(packed, cents, device=mesh.devices[0])
sh = ShardedIVF.build(mesh, packed, ids, cents, assignments=assign)
one = IVFIndex.build(packed, ids, cents, assignments=assign, device=mesh.devices[0])
same = []
for nprobe in (1, 8, -1):
    s1, i1 = sh.search(q, k=10, nprobe=nprobe, refine=32)
    s2, i2 = one.search(q, k=10, nprobe=nprobe, refine=32)
    same.append(float(np.mean([set(a) == set(b) for a, b in zip(i1, i2)])))
print(json.dumps({"rank": rank, "backend": dist.get_backend(), "world": dist.get_world_size(),
                  "shards": mesh.size, "device": str(mesh.devices[0]), "same_sets": same}))
dist.destroy_process_group()
"""
    t0 = time.perf_counter()
    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(world):
        env = dict(os.environ)
        if world > 1 and "VSTPU_DEVICE" not in env:
            env["VSTPU_DEVICE"] = f"cuda:{rank}"
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, os.path.dirname(os.path.abspath(__file__)), coord,
             str(world), str(rank)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        ))
    ranks = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            ranks.append(json.loads(out.strip().splitlines()[-1]) if p.returncode == 0
                         else {"rc": p.returncode, "stderr": err[-3000:]})
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {"world": world, "s": time.perf_counter() - t0, "ranks": ranks}


def sharded_scan_checks(torch, sh, queries, shard=0) -> dict:
    """The grouped scan on one shard's store of `sh` (its cap from
    headroom 1.0), at the probe lists ShardedIVF.search gives that shard at
    each SHARDED_CHECK_NPROBES: the kernel against grouped_scores_ref on
    the groups grouped_scan builds with probe_valid (check_scan; every group
    of the out-of-range id K, the pairs of clusters other shards own, all
    -inf), and grouped_scan's top-k scores against the same function with
    the plain version in the kernel's place. Its launches are a check's,
    not the main path's: the launch count is put back after. Returns each
    nprobe's numbers; raises AssertionError on a disagreement."""
    from vectorsearch_tpu_torch.kernels import cosine
    from vectorsearch_tpu_torch.kernels import grouped_scan as gs

    launches_before = gs.LAUNCHES
    mesh, kk, cap = sh.mesh, sh.clusters_per_shard, sh.cap
    q = torch.from_numpy(queries)
    qn = [cosine.l2_normalize(q.to(d)) for d in mesh.devices]
    x = qn[shard]
    a, bv, bias = sh.folded[shard]
    store = (sh.buckets[shard], sh.counts[shard], sh.bucket_mask[shard])
    bs = 128 if cap % 128 == 0 else 64
    out = {}
    for nprobe in SHARDED_CHECK_NPROBES:
        label = f"sharded scan, shard {shard} of {mesh.size}, nprobe={nprobe}"
        local, valid = sh.probes(qn, min(nprobe, sh.k_clusters))[shard]
        _, gcl, qidx, _, gcount = gs.build_groups(torch.where(valid, local, kk), kk, masked=True)
        args = (x.bfloat16()[qidx], x.sum(-1)[qidx], gcl, sh.counts[shard],
                sh.buckets[shard].codes, a, bv, bias)
        err, scores, _ = check_scan(torch, gs, args, gcount, bs, label)
        sentinel = gcl[: scores.shape[0]] == kk
        if not torch.isneginf(scores[sentinel]).all():
            raise AssertionError(f"{label}: a group of another shard's clusters scored")
        del scores

        def scan():
            return gs.grouped_scan(x, x.sum(-1), *store, local, max(TOPK, REFINE),
                                   folded=sh.folded[shard], probe_valid=valid)[0]

        got = scan()
        kernel = gs.grouped_scores
        gs.grouped_scores = gs.grouped_scores_ref
        try:
            want = scan()
        finally:
            gs.grouped_scores = kernel
        live = torch.isfinite(want)
        if not torch.equal(torch.isfinite(got), live):
            raise AssertionError(f"{label}: grouped_scan's -inf pattern differs from plain")
        topk_err = float((got[live] - want[live]).abs().max()) if bool(live.any()) else 0.0
        if topk_err > KERNEL_ATOL:
            raise AssertionError(f"{label}: grouped_scan top-k |kernel - plain| {topk_err} "
                                 f"> {KERNEL_ATOL}")
        out[nprobe] = {"K": kk, "cap": cap, "invalid_pairs": float(1 - valid.float().mean()),
                       "G": int(sentinel.numel()), "G_grid": int(gcl.numel()),
                       "G_sentinel": int(sentinel.sum()),
                       "max_abs_err": err, "topk_max_abs_err": topk_err}
        log(f"{label}: K={kk} cap={cap}, {out[nprobe]['invalid_pairs']:.3f} of the pairs "
            f"not this shard's, {out[nprobe]['G_sentinel']} of {out[nprobe]['G']} groups "
            f"under id K all -inf; kernel vs plain max_abs_err={err:.3g}, grouped_scan "
            f"top-{max(TOPK, REFINE)} {topk_err:.3g} (atol {KERNEL_ATOL})")
    gs.LAUNCHES = launches_before
    return out


def phase_sharded(torch, dev, smi, packed, ids, centroids, assignments, queries,
                  truth_ids, single) -> dict:
    """phase_index's corpus, build, queries and truth through the sharded
    path: ShardedIVF on SHARDED_SHARDS shards of this card and on
    default_mesh(), against the single-device index `single` on the same
    centroids; ShardedFlat on the shards of this card; lloyd from one init
    on those shards and on one device, then build_centroids on them; an
    Engine with default_mesh() installing, using and dropping its replica;
    and a child process on the collective path (sharded_entry_check). On
    the shards of this card, one shard's scan is held against its plain
    version (sharded_scan_checks)."""
    from vectorsearch_tpu_torch.build import build_centroids, lloyd
    from vectorsearch_tpu_torch.engine import Engine
    from vectorsearch_tpu_torch.host import NoopAI, Store, layout
    from vectorsearch_tpu_torch.parallel import Mesh, ShardedFlat, ShardedIVF, default_mesh

    out = {"ivf": {}, "failures": [], "virtual_searches": 0, "scan_checks": {}}
    fail = out["failures"].append
    n = packed.codes.shape[0]
    virtual = Mesh((dev,) * SHARDED_SHARDS)

    def wall_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    want = {p: single.search(queries, k=TOPK, nprobe=p, refine=REFINE) for p in SHARDED_NPROBES}
    single_ms = {p: wall_ms(lambda p=p: single.search(queries, k=TOPK, nprobe=p, refine=REFINE))
                 for p in SHARDED_NPROBES}
    b = queries.shape[0]
    for label, mesh in ((f"{SHARDED_SHARDS} shards on {dev}", virtual),
                        ("default_mesh()", default_mesh())):
        t0 = time.perf_counter()
        sh = ShardedIVF.build(mesh, packed, ids, centroids, assignments=assignments)
        torch.cuda.synchronize()
        r = {"shards": mesh.size, "cap": sh.cap, "build_s": time.perf_counter() - t0,
             "by_nprobe": {}}
        for p in SHARDED_NPROBES:
            def search(p=p):
                return sh.search(queries, k=TOPK, nprobe=p, refine=REFINE)

            c = sharded_ivf_checks(*search(), *want[p], truth_ids)
            c["ms"] = wall_ms(search)
            c["qps"], c["single_ms"] = b / c["ms"] * 1e3, single_ms[p]
            c["single_qps"] = b / single_ms[p] * 1e3
            if mesh is virtual:
                out["virtual_searches"] += 5  # the checked one, the warm-up, 3 timed
            r["by_nprobe"][p] = c
            floor = MIN_RECALL.get(p, MIN_RECALL_WIDE)
            if c["recall"] < floor or c["repeats"] or c["sets_differ"] or not c["finite"]:
                fail(f"ShardedIVF {label} nprobe={p}: {c}")
            log(f"sharded ivf, {label}, nprobe={p}: recall@10 {c['recall']:.4f}, "
                f"{c['sets_differ']} rows whose top-10 set differs from IVFIndex's past a "
                f"tie, max |score diff| {c['max_score_diff']:.3g}; {c['ms']:.3f} ms a B={b} "
                f"search ({c['qps']:.0f} QPS) beside the single-device index's "
                f"{single_ms[p]:.3f} ms ({c['single_qps']:.0f} QPS) (host clock, "
                f"synchronized, {smi})")
        log(f"sharded ivf, {label}: {mesh.size} shards, cap {sh.cap}, built in "
            f"{r['build_s']:.1f} s")
        if mesh is virtual:
            try:
                out["scan_checks"] = sharded_scan_checks(torch, sh, queries)
            except AssertionError as e:
                fail(str(e))
        out["ivf"][label] = r
        del sh
        torch.cuda.empty_cache()

    flat = ShardedFlat.build(virtual, packed, ids)
    s, got = flat.search(queries, k=TOPK)
    out["flat"] = {
        "recall": float(np.mean([len(set(got[r]) & set(truth_ids[r])) / TOPK
                                 for r in range(b)])),
        "repeats": int(sum(len(set(row)) < TOPK for row in got)),
        "ms": wall_ms(lambda: flat.search(queries, k=TOPK)),
    }
    if out["flat"]["recall"] < MIN_RECALL_WIDE or out["flat"]["repeats"]:
        fail(f"ShardedFlat: {out['flat']}")
    log(f"sharded flat, {SHARDED_SHARDS} shards on {dev}: recall@10 "
        f"{out['flat']['recall']:.4f}, {out['flat']['ms']:.3f} ms a B={b} search ({smi})")
    del flat
    torch.cuda.empty_cache()

    # Lloyd's from one init (phase 4's centroids), SHARDED_LLOYD_ITERS
    # passes, on the shards and on one device: the first pass assigns alike
    # and the sums differ only in their order, so a later assignment may
    # differ only where a row lies within that difference of a tie
    t0 = time.perf_counter()
    one = lloyd(packed, centroids, max_iters=SHARDED_LLOYD_ITERS, chunk=65_536,
                tol_changes=-1, device=dev)
    t1 = time.perf_counter()
    got = lloyd(packed, centroids, max_iters=SHARDED_LLOYD_ITERS, chunk=65_536,
                tol_changes=-1, mesh=virtual)
    t2 = time.perf_counter()
    moved = np.nonzero(got.assignments != one.assignments)[0]
    touched = np.zeros(one.centroids.shape[0], bool)
    touched[got.assignments[moved]] = touched[one.assignments[moved]] = True
    err = float(np.abs(got.centroids - one.centroids)[~touched].max())
    out["lloyd"] = {"one_s": t1 - t0, "sharded_s": t2 - t1, "moved": int(moved.size),
                    "clusters_touched": int(touched.sum()), "max_centroid_err": err,
                    "iterations": (one.iterations, got.iterations)}
    if (moved.size > n * LLOYD_MOVED_SHARE or err > LLOYD_CENTROID_ATOL
            or got.counts.sum() != n or got.iterations != SHARDED_LLOYD_ITERS):
        fail(f"sharded lloyd: {out['lloyd']}")
    log(f"sharded lloyd, {SHARDED_LLOYD_ITERS} passes from phase 4's centroids on "
        f"{SHARDED_SHARDS} shards against one device: {moved.size} of {n} assignments "
        f"differ (at most {LLOYD_MOVED_SHARE} of the rows); the centroids of the "
        f"{int((~touched).sum())} clusters none of them touches differ by at most "
        f"{err:.3g} (atol {LLOYD_CENTROID_ATOL}); {t2 - t1:.2f} s against "
        f"{t1 - t0:.2f} s, uploads included")
    t0 = time.perf_counter()
    res = build_centroids(
        packed, k=K_GEN, min_cluster_size=max(1, (n // K_GEN) // 10),
        max_iters=10, superset_iters=4, chunk=65_536, mesh=virtual,
    )
    out["build"] = {"s": time.perf_counter() - t0, "k": int(res.centroids.shape[0]),
                    "iterations": res.iterations, "assigned": int(res.counts.sum()),
                    "finite": bool(np.isfinite(res.centroids).all())}
    if not (out["build"]["finite"] and out["build"]["assigned"] == n
            and 1 < out["build"]["k"] <= 2 * K_GEN):
        fail(f"build_centroids on the mesh: {out['build']}")
    log(f"sharded build_centroids (phase 4's arguments) on {SHARDED_SHARDS} shards: "
        f"{out['build']['s']:.1f} s, {out['build']['k']} centroids, "
        f"{res.iterations} iters")

    # the engine's read replica: installed by a rebuild, used by a search,
    # dropped by a delete; the deleted document never comes back
    with tempfile.TemporaryDirectory(prefix="vs_smoke_sharded_") as tmp:
        store = Store(os.path.join(tmp, "store.db"))
        eng = Engine(store, NoopAI(seed=0), mesh=default_mesh(), device=dev)
        docs = [{"name": f"doc{i}", "document": {"text": f"body {i}"}} for i in range(2_000)]
        for i in range(0, len(docs), 500):
            eng.upload("o", "c", docs[i : i + 500])
        eng.refresh_centroids(target_cluster_size=200)
        cat = store.get_category(store.get_owner("o").id, "c")
        state = eng._state_for(cat.id, create=False)
        replica = state.sharded
        calls = []
        if replica is not None:
            real = replica.search
            object.__setattr__(replica, "search",
                               lambda *a, **kw: calls.append(1) or real(*a, **kw))
        hits = eng.search("o", "c", "some text", count=10, centroids=-1)
        victim = hits[0].document_id if hits else None
        eng.delete_document("o", "c", victim)
        dropped = state.sharded is None
        after = eng.search_many("o", "c", [f"again {i}" for i in range(64)], count=20,
                                centroids=-1)
        eng.refresh_centroids(target_cluster_size=200)
        again = eng.search_many("o", "c", [f"more {i}" for i in range(64)], count=20,
                                centroids=-1)
        out["engine"] = {
            "installed": replica is not None, "searched_through": len(calls),
            "hits": len(hits), "dropped_by_delete": dropped,
            "reinstalled": state.sharded is not None,
            "deleted_returned": sum(h.document_id == victim for p in after + again for h in p),
            "pages_full": all(len(p) == 20 for p in after + again),
        }
        eng.close()
        store.close()
    e = out["engine"]
    if not (e["installed"] and e["searched_through"] == 1 and e["hits"] == 10
            and e["dropped_by_delete"] and e["reinstalled"] and not e["deleted_returned"]
            and e["pages_full"]):
        fail(f"engine with a mesh: {e}")
    log(f"sharded engine: {e}")

    world = torch.cuda.device_count() if dev.type == "cuda" else 1
    out["entry"] = ent = sharded_entry_check(world)
    if not all(r.get("backend") == "nccl" and r.get("world") == world
               and r.get("shards") == world and min(r.get("same_sets", [0])) >= 0.99
               for r in ent["ranks"]):
        fail(f"process group of {world}: {ent}")
    log(f"sharded, a process group of {world} in child processes "
        f"({ent['s']:.1f} s): {ent['ranks']}")
    return out


def forward_checks(s, g, want_s, want_g) -> dict:
    """The entry forward's (scores, slots) against another formulation's on
    the same tensors: the largest score difference (-inf taken as -9),
    rows whose -inf pattern differs, and rows whose slot set differs other
    than at a tie within KERNEL_ATOL."""
    from vectorsearch_tpu_torch.tools.scale_corpus import sets_differ

    s, want_s = np.nan_to_num(s, neginf=-9.0), np.nan_to_num(want_s, neginf=-9.0)
    return {"max_abs_err": float(np.abs(s - want_s).max()),
            "sets_differ": sets_differ(s, g, want_s, want_g, KERNEL_ATOL),
            "finite_differ": int(((s == -9.0) != (want_s == -9.0)).any(axis=1).sum())}


def phase_graft(torch, dev, smi, single, queries) -> dict:
    """The port's graft entry points (vectorsearch_tpu_torch/graft_entry.py):
    entry()'s forward on the card at its example shape, held against the
    same function on CPU copies of its tensors (the scan kernel's plain
    version); the same forward at full width on phase 4's index `single`
    (B = the bench queries, nprobe=2, k=10), held against index/ivf's
    _ivf_scan, the plain gather formulation, on the card; then
    dryrun_multichip over every card (default_mesh) and over SHARDED_SHARDS
    shards of this card built as a Mesh."""
    from vectorsearch_tpu_torch import graft_entry
    from vectorsearch_tpu_torch.index import ivf as ivf_mod
    from vectorsearch_tpu_torch.parallel import Mesh

    out, failures = {"failures": []}, []
    fn, args = graft_entry.entry()
    if args[0].device.type != dev.type:
        failures.append(f"entry() built its example on {args[0].device}, not {dev.type}")
    s, g = fn(*args)
    torch.cuda.synchronize()
    ps, pg = fn(*[a.cpu() for a in args])
    c = out["example"] = forward_checks(*(t.cpu().numpy() for t in (s, g, ps, pg)))
    c["shape"] = [list(t.shape) for t in (s, g)]
    log(f"graft entry(): forward {c['shape']} on {args[0].device} against its plain "
        f"version on the CPU: max |diff| {c['max_abs_err']:.3g}, {c['sets_differ']} rows "
        f"whose slot set differs past a tie")

    b = queries.shape[0]
    full = (torch.from_numpy(queries).to(dev), single.centroids_n, *single.buckets,
            single.counts_dev, single.bucket_mask)
    t0 = time.perf_counter()
    s, g = fn(*full)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    parts = [ivf_mod._ivf_scan(full[0][i : i + 128], full[1], single.buckets, *full[6:],
                               nprobe=graft_entry.NPROBE, k=graft_entry.K)
             for i in range(0, b, 128)]
    want_s, want_g = (torch.cat([p[j] for p in parts]).cpu().numpy() for j in (0, 1))
    del parts
    torch.cuda.empty_cache()
    c = out["full"] = forward_checks(s.cpu().numpy(), g.cpu().numpy(), want_s, want_g)
    c.update(B=b, K=single.k_clusters, cap=single.cap, first_call_s=forward_s)
    log(f"graft entry()'s forward at full width (B={b}, K={single.k_clusters}, cap="
        f"{single.cap}, D={single.dim}, nprobe={graft_entry.NPROBE}, k={graft_entry.K}; "
        f"first call {forward_s:.3f} s, host clock) against _ivf_scan (the plain gather "
        f"formulation) on {dev}: max |diff| {c['max_abs_err']:.3g}, {c['sets_differ']} "
        f"rows whose slot set differs past a tie ({smi})")
    for label, r in (("example", out["example"]), ("full width", c)):
        if r["max_abs_err"] > KERNEL_ATOL or r["sets_differ"] or r["finite_differ"]:
            failures.append(f"entry() forward, {label}: {r}")

    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    out["dryrun"] = {}
    for label, kw in ((f"default_mesh({n_cards})", {"n_devices": n_cards}),
                      (f"{SHARDED_SHARDS} shards of {dev}",
                       {"mesh": Mesh((dev,) * SHARDED_SHARDS)})):
        t0 = time.perf_counter()
        out["dryrun"][label] = graft_entry.dryrun_multichip(**kw)
        log(f"graft dryrun_multichip, {label}: {time.perf_counter() - t0:.1f} s")
    out["failures"] = failures
    return out


def bulk_check(torch, dev, packed, queries, truth_ids, ivf) -> dict:
    """The search at bench.py's widest bulk shape (nprobe 2, B = BULK_BATCH,
    at most n): the queries, then query_pool rows up to B. Searched in one
    call of ivf_search (as bench.py timed it) and through IVFIndex.search
    (whose transient-memory model splits a batch this wide into chunks),
    each call's top-10 against the same rows searched BULK_CHECK_SPLIT at
    a time (sets equal but at a tie within TIE_SHARDED); the queries'
    recall@10 at the nprobe-2 floor; and the scan kernel on the one call's
    groups against its plain version (check_scan; those launches are taken
    out of the phase's count)."""
    from vectorsearch_tpu_torch.kernels import cosine
    from vectorsearch_tpu_torch.kernels import grouped_scan as gs
    from vectorsearch_tpu_torch.tools.scale_corpus import sets_differ

    nprobe, nq = 2, len(queries)
    b = min(BULK_BATCH, packed.codes.shape[0])
    rows = np.concatenate([queries, query_pool(packed, b - nq)])
    q = torch.from_numpy(rows).to(dev)
    fn, id_map = ivf_search(ivf, nprobe), slot_ids(ivf)
    s, i = (x.cpu().numpy() for x in fn(q))
    parts = [fn(q[j : j + BULK_CHECK_SPLIT]) for j in range(0, b, BULK_CHECK_SPLIT)]
    ws, wi = (np.concatenate([p[f].cpu().numpy() for p in parts]) for f in (0, 1))
    got, want = id_map(i), id_map(wi)
    del parts
    ss, si = ivf.search(rows, k=TOPK, nprobe=nprobe, refine=REFINE)
    floor = MIN_RECALL.get(nprobe, MIN_RECALL_WIDE)
    out = {
        "batch": b, "nprobe": nprobe,
        "recall": float(np.mean([len(set(got[r]) & set(truth_ids[r])) / TOPK
                                 for r in range(nq)])),
        "sets_differ": sets_differ(s, got, ws, want, TIE_SHARDED),
        "search_sets_differ": sets_differ(ss, si, ws, want, TIE_SHARDED),
        "max_score_diff": float(np.abs(s - ws).max()),
    }
    out["failures"] = [f"bulk check {out} (recall floor {floor})"] if (
        out["sets_differ"] or out["search_sets_differ"] or out["recall"] < floor) else []
    launches_before = gs.LAUNCHES
    qn = cosine.l2_normalize(q)
    qt, gcl, qidx, _, gcount = gs.build_groups(gs.probe(qn, ivf.centroids_n, nprobe),
                                               ivf.k_clusters)
    args = (qn.bfloat16()[qidx], qn.sum(-1)[qidx], gcl, ivf.counts_dev, ivf.buckets.codes,
            *ivf.folded)
    out["groups"], out["qt"] = int(gcount), qt
    out["scan_max_abs_err"], _, _ = check_scan(
        torch, gs, args, gcount, 128,
        f"bulk nprobe={nprobe} B={b} G={out['groups']} (grid {int(gcl.numel())})")
    gs.LAUNCHES = launches_before
    del args, qn, q
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"bulk nprobe={nprobe} B={b} ({out['groups']} groups of QT {qt}): scan max "
        f"|kernel - plain| {out['scan_max_abs_err']:.2e}; rows whose top-10 differs from "
        f"{BULK_CHECK_SPLIT} at a time: {out['sets_differ']} in one call (max score diff "
        f"{out['max_score_diff']:.2e}), {out['search_sets_differ']} through IVFIndex.search; "
        f"recall@10 {out['recall']:.4f}")
    return out


def sql_boot_check(dev, packed, centroids, assignments, queries, truth_ids) -> dict:
    """An engine booted from an in-memory SQL store of phase 4's rows
    (engine_10m_check.populate: each row's centroid_id its assignment, so
    the boot packs them without a rebuild) with QueryAI(queries): its
    recall@10 at nprobe 8, in-process, against the truth."""
    from vectorsearch_tpu_torch.engine import Engine
    from vectorsearch_tpu_torch.host import Store
    from vectorsearch_tpu_torch.tools import engine_10m_check as ec
    from vectorsearch_tpu_torch.tools import scale_corpus as sc

    store = Store(":memory:")
    try:
        out = {"populate_s": ec.populate(store, packed, centroids, assignments)["populate_s"]}
        t0 = time.perf_counter()
        eng = Engine(store, ec.QueryAI(queries), device=dev)
        try:
            out["boot_s"] = time.perf_counter() - t0
            out["recall"] = sc.recall(ec.top10(eng, queries.shape[0])[0], truth_ids)
        finally:
            eng.close()
            del eng
    finally:
        store.close()
    ec.release(dev)
    log(f"engine booted from SQL: {packed.codes.shape[0]} rows populated in "
        f"{out['populate_s']:.1f} s, booted in {out['boot_s']:.1f} s, recall@10 "
        f"{out['recall']:.4f} at nprobe {ec.NPROBE}")
    return out


def phase_engine(torch, dev, sql_inputs, n_docs=2_000) -> dict:
    """sql_boot_check on phase 4's (packed, centroids, assignments,
    queries, truth_ids), with its recall at the floor of nprobe 8; the
    native codec's build ("numpy" where a C++ compiler is present fails);
    then an Engine over a temporary SQLite store and snapshot dir."""
    import shutil

    from vectorsearch_tpu_torch import native
    from vectorsearch_tpu_torch.engine import Engine
    from vectorsearch_tpu_torch.host import NoopAI, Store, layout

    out = {"sql_boot": sql_boot_check(dev, *sql_inputs), "failures": []}
    if out["sql_boot"]["recall"] < MIN_RECALL_WIDE:
        out["failures"].append(f"the SQL-booted engine's recall@10 "
                               f"{out['sql_boot']['recall']:.4f} < {MIN_RECALL_WIDE}")
    out["native_codec"] = native.build_kind()
    toolchain = shutil.which("make") and shutil.which(os.environ.get("CXX", "g++"))
    log(f"engine: native codec {out['native_codec']} (C++ compiler "
        f"{'present' if toolchain else 'absent'})")
    if out["native_codec"] == "numpy" and toolchain:
        out["failures"].append("the native codec fell back to numpy where a C++ compiler "
                               "is present")
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


def clustered_ai(dim=DIM, k=K_GEN, seed=5):
    """The server phase's embedder: the first integer in a text names a
    document, and its vector is bench.py's recipe (2 * center + unit noise,
    k centers) drawn from that number and a fixed seed. A query that names
    a document therefore embeds exactly as the document did."""
    from vectorsearch_tpu_torch.host import AIProvider, codec

    centers = np.random.default_rng(seed).standard_normal((k, dim), dtype=np.float32)

    def vector(n):
        rng = np.random.default_rng((seed, n))
        return centers[rng.integers(k)] * np.float32(2.0) + rng.standard_normal(
            dim, dtype=np.float32)

    class ClusteredAI(AIProvider):
        def can_embed(self):
            return True

        def can_generate(self):
            return True

        def can_chat(self):
            return True

        def embed(self, inputs, model=None):
            nums = [int(re.search(r"\d+", t).group()) for t in inputs]
            return list(codec.quantize(np.stack([vector(n) for n in nums])))

        def generate(self, prompt, model=None):
            return CHAT_REPLY

        def generate_stream(self, prompt, model=None):
            yield CHAT_REPLY

        def chat(self, messages, model=None):
            return CHAT_REPLY

        def chat_stream(self, messages, model=None):
            yield from CHAT_REPLY.partition(" ")

        def embed_ctx_num(self):
            return 8192  # one section per document

    return ClusteredAI()


def phase_server(torch, dev, smi, n_docs=SERVER_DOCS, n_sample=SERVER_SAMPLE,
                 per_client=SERVER_PER_CLIENT) -> dict:
    """The port's entry served over HTTP: boot 1 takes the uploads, boot 2
    rebuilds at startup and answers the searches, deletes, chat and stats;
    then `python -m vectorsearch_tpu_torch` is started as users start it."""
    from vectorsearch_tpu_torch.tools.http_driver import (
        Client, fan_out, free_port, serving)
    from vectorsearch_tpu_torch import __main__ as entry
    from vectorsearch_tpu_torch.host import config

    out, failures = {"docs": n_docs}, []
    ai = clustered_ai()
    engines = []

    class RecordedEngine(entry.Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    def search(c, n, centroids, count=10):
        return c.post("/api/search", {"owner": "o", "category": "c",
                                      "text": f"document {n}", "count": count,
                                      "centroids": centroids})["documents"]

    entry.Engine = RecordedEngine
    try:
        with tempfile.TemporaryDirectory(prefix="vs_server_") as tmp:
            port = free_port()
            cfg = config.Config.parse(json.dumps({
                "server": {"http_address": f"127.0.0.1:{port}", "https_address": ""},
                "database": {"sqlite": os.path.join(tmp, "store.db"),
                             "snapshots": os.path.join(tmp, "snaps")},
                "log_level": "warn",
            }))

            # ---- boot 1: the uploads, SERVER_UPLOAD documents a request
            ids = {}
            with serving(entry, cfg, ai, port) as out["boot1_listen_s"]:
                # the startup rebuild of this boot finds an empty store; let
                # it end first, so that boot 2's is the one that clusters
                for t in threading.enumerate():
                    if t.name == "vstpu-startup":
                        t.join()

                def upload(start):
                    def job(c):
                        nums = range(start, min(start + SERVER_UPLOAD, n_docs))
                        got = c.post("/api/upload", {"owner": "o", "category": "c", "documents": [
                            {"name": f"d{n}", "document": {"text": f"document {n}"}} for n in nums]})
                        return dict(zip(nums, got["document_ids"]))
                    return job

                pages, out["upload_s"] = fan_out(
                    port, 4, [upload(s) for s in range(0, n_docs, SERVER_UPLOAD)])
                for p in pages:
                    ids.update(p)
                _, _, stats = Client(port).call("GET", "/api/stats")
            out["upload_docs_per_s"] = n_docs / out["upload_s"]
            if len(ids) != n_docs or len(set(ids.values())) != n_docs:
                failures.append(f"upload gave {len(set(ids.values()))} ids for {n_docs} documents")
            out["boot1_vectors"] = sum(c["live_vectors"] for c in stats["categories"].values())
            log(f"server boot 1: listening in {out['boot1_listen_s']:.2f} s; {n_docs} documents "
                f"in {n_docs // SERVER_UPLOAD} uploads of {SERVER_UPLOAD} from 4 clients in "
                f"{out['upload_s']:.1f} s ({out['upload_docs_per_s']:.0f} documents/s, host "
                f"clock), {out['boot1_vectors']} vectors; {smi}")

            # ---- boot 2: the startup rebuild, then the searches
            with serving(entry, cfg, ai, port) as out["boot2_listen_s"]:
                c = Client(port)
                t0 = time.perf_counter()
                during = []  # ms of each search while the startup rebuild runs
                while True:
                    _, _, stats = c.call("GET", "/api/stats")
                    (cat,) = stats["categories"].values()
                    if stats["build"] is None and cat["clusters"] > 1:
                        break
                    if time.perf_counter() - t0 > 600:
                        raise AssertionError(f"no rebuild within 600 s: {stats}")
                    t = time.perf_counter()
                    if not search(c, len(during) % n_docs, 8):
                        failures.append("a search during the startup rebuild found nothing")
                    during.append((time.perf_counter() - t) * 1e3)
                out["rebuild_s"] = time.perf_counter() - t0
                out["during_rebuild"] = {
                    "searches": len(during),
                    "max_ms": max(during, default=None),
                    "p50_ms": float(np.median(during)) if during else None,
                }
                out["clusters"], out["cap"] = cat["clusters"], cat["bucket_capacity"]
                out["device"] = str(engines[-1].device)
                if engines[-1].device.type != dev.type:
                    failures.append(f"the engine serves on {engines[-1].device}, not {dev.type}")
                log(f"server boot 2: listening in {out['boot2_listen_s']:.2f} s (snapshot "
                    f"restore), startup rebuild done {out['rebuild_s']:.2f} s later: "
                    f"{cat['live_vectors']} vectors in {out['clusters']} clusters, cap "
                    f"{out['cap']}, engine on {out['device']}; {smi}")
                log(f"server searches during the startup rebuild: "
                    f"{out['during_rebuild']} (host clock)")

                rng = np.random.default_rng(17)
                sample = rng.choice(n_docs, n_sample, replace=False)

                # 1. every sampled document finds itself first
                def self_search(n, centroids):
                    def job(c):
                        top = search(c, n, centroids)[0]
                        return top["name"] == f"d{n}" and top["document_id"] == ids[n]
                    return job

                for centroids in (8, -1):
                    got, _ = fan_out(port, SERVER_CLIENTS,
                                     [self_search(int(n), centroids) for n in sample])
                    out[f"self_top1_c{centroids}"] = float(np.mean(got))
                    if not all(got):
                        failures.append(f"{got.count(False)} of {n_sample} sampled documents "
                                        f"not first at centroids={centroids}")
                log(f"server self-search: {n_sample} sampled documents first at centroids 8 / "
                    f"-1: {out['self_top1_c8']:.4f} / {out['self_top1_c-1']:.4f}")

                # 2-3. single searches, from one client, then from 16 at once
                def timed_search(n, centroids):
                    def job(c):
                        t = time.perf_counter()
                        top = search(c, n, centroids)[0]
                        return time.perf_counter() - t, top["document_id"] == ids[n]
                    return job

                queries = [int(n) for n in sample[:SERVER_SINGLE]]
                for centroids in SERVER_NPROBES:
                    for clients, per in ((1, SERVER_SINGLE), (SERVER_CLIENTS, per_client)):
                        jobs = [timed_search(queries[i % len(queries)], centroids)
                                for i in range(clients * per)]
                        before = c.call("GET", "/api/stats")[2]["batcher"]["dispatches"]
                        got, wall = fan_out(port, clients, jobs)
                        after = c.call("GET", "/api/stats")[2]["batcher"]["dispatches"]
                        ms = np.array([t for t, _ in got]) * 1e3
                        key = f"c{centroids}_x{clients}"
                        out[key] = {"requests": len(jobs), "p50_ms": float(np.percentile(ms, 50)),
                                    "p99_ms": float(np.percentile(ms, 99)),
                                    "req_per_s": len(jobs) / wall,
                                    "dispatches": after - before,
                                    "self_top1": float(np.mean([ok for _, ok in got]))}
                        r = out[key]
                        log(f"server search centroids={centroids}, {clients} client(s), "
                            f"{r['requests']} requests: p50 {r['p50_ms']:.3f} ms, p99 "
                            f"{r['p99_ms']:.3f} ms, {r['req_per_s']:.0f} requests/s, "
                            f"{r['requests'] / max(r['dispatches'], 1):.2f} requests per "
                            f"device dispatch, self top-1 {r['self_top1']:.4f} (host clock, "
                            f"HTTP end to end; {smi})")
                        if centroids != 1 and r["self_top1"] < 1.0:
                            failures.append(f"{key}: self top-1 {r['self_top1']}")

                # 4. batched texts searches
                batches = [sample[i : i + SERVER_BATCH_Q]
                           for i in range(0, n_sample - SERVER_BATCH_Q + 1, SERVER_BATCH_Q)]
                t0 = time.perf_counter()
                hits = []
                for _ in range(SERVER_BATCH_ROUNDS):
                    for b in batches:
                        res = c.post("/api/search", {
                            "owner": "o", "category": "c", "count": 10, "centroids": 8,
                            "texts": [f"document {n}" for n in b]})["results"]
                        hits += [r["documents"][0]["document_id"] == ids[int(n)]
                                 for n, r in zip(b, res)]
                wall = time.perf_counter() - t0
                out["batch_queries_per_s"] = len(hits) / wall
                if not all(hits):
                    failures.append(f"batched texts: {hits.count(False)} queries not first")
                log(f"server batched texts: {len(hits)} queries in requests of "
                    f"{SERVER_BATCH_Q} at centroids=8: {out['batch_queries_per_s']:.0f} "
                    f"queries/s (host clock; {smi})")

                # 5. deletes; none may come back
                victims = [int(n) for n in sample[:SERVER_DELETE]]
                gone = {ids[n] for n in victims}
                for n in victims:
                    if c.post("/api/delete/document", {"owner": "o", "category": "c",
                                                       "document_id": ids[n]}) != {}:
                        failures.append(f"delete of document {ids[n]} did not answer {{}}")
                back = [d["document_id"] for n in victims for cc in (8, -1)
                        for d in search(c, n, cc)]
                back += [d["document_id"] for r in c.post("/api/search", {
                    "owner": "o", "category": "c", "count": 10, "centroids": 8,
                    "texts": [f"document {n}" for n in victims]})["results"]
                    for d in r["documents"]]
                out["deleted_returned"] = len(gone.intersection(back))
                if out["deleted_returned"]:
                    failures.append(f"{out['deleted_returned']} deleted documents came back")

                # 6-7. chat stream; stats name the card
                status, headers, body = c.call("POST", "/api/chat", {
                    "text": "summarize", "document_ids": [ids[int(sample[-1])]]})
                if (status, headers.get("Transfer-Encoding"), body) != (
                        200, "chunked", CHAT_REPLY.encode()):
                    failures.append(f"chat: {status} {headers} {body[:80]!r}")
                _, _, stats = c.call("GET", "/api/stats")
                out["devices"] = stats["devices"]
                (cat,) = stats["categories"].values()
                if [d["name"] for d in stats["devices"]] != [
                        torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]:
                    failures.append(f"/api/stats devices: {stats['devices']}")
                if cat["live_vectors"] != n_docs - SERVER_DELETE:
                    failures.append(f"live vectors {cat['live_vectors']} after the deletes")
                log(f"server: {SERVER_DELETE} deleted, {out['deleted_returned']} came back; "
                    f"chat streamed; /api/stats devices {[d['name'] for d in stats['devices']]}")

                # 8. the same server through the port's client SDK
                out["client"] = client_checks(port, c, search, ids, sample, n_docs, failures)

            # ---- the entry as users start it
            out["entry"] = entry_check(tmp, failures)
    finally:
        entry.Engine = RecordedEngine.__mro__[1]
    out["failures"] = failures
    return out


def client_checks(port, raw, search, ids, sample, n_docs, failures) -> dict:
    """vectorsearch_tpu_torch.client.Client against the serving port: an
    upload of SERVER_CLIENT_UPLOAD new documents (each then found first
    by its own text), searches at centroids 1 and 8 whose hits must equal
    the raw-HTTP client's answer to the same request, a zstd round trip
    (request and response compressed), a streamed chat, and an upload
    with no documents (ClientError with the status the raw request gets)."""
    from vectorsearch_tpu_torch.client import Client, ClientError

    url = f"http://127.0.0.1:{port}"
    cl, zc = Client(url), Client(url, use_zstd=True)
    out = {}
    t0 = time.perf_counter()
    nums = range(n_docs + 1, n_docs + 1 + SERVER_CLIENT_UPLOAD)
    new_ids = cl.upload("o", "c", [{"name": f"d{n}", "document": {"text": f"document {n}"}}
                                   for n in nums])
    out["upload_s"] = time.perf_counter() - t0
    if len(set(new_ids)) != len(nums) or set(new_ids) & set(ids.values()):
        failures.append(f"client upload: {len(set(new_ids))} new ids for {len(nums)} documents")
    ids = {**ids, **dict(zip(nums, new_ids))}
    queries = [int(n) for n in sample[-SERVER_CLIENT_SEARCHES:]] + list(nums)[:SERVER_CLIENT_SEARCHES]
    mismatched, not_first = 0, 0
    for centroids in SERVER_NPROBES:
        for n in queries:
            got = cl.search("o", "c", f"document {n}", count=10, centroids=centroids)
            mismatched += got != search(raw, n, centroids)
            not_first += centroids != 1 and got[0]["document_id"] != ids[n]
    zstd_hits = zc.search("o", "c", f"document {queries[0]}", count=10, centroids=8)
    zstd_same = zstd_hits == search(raw, queries[0], 8)
    reply = "".join(cl.chat("summarize", document_ids=[new_ids[0]]))
    status = raw.call("POST", "/api/upload", {"owner": "o", "category": "c", "documents": []})[0]
    try:
        cl.upload("o", "c", [])
        error = None
    except ClientError as e:
        error = e.status
    out.update(searches=len(queries) * len(SERVER_NPROBES), mismatched=mismatched,
               not_first=not_first, zstd_same=zstd_same, chat=reply == CHAT_REPLY,
               error_status=error, raw_status=status)
    if mismatched or not_first or not zstd_same or reply != CHAT_REPLY or error != status:
        failures.append(f"client: {out}")
    log(f"server through the client SDK: {len(nums)} documents uploaded in "
        f"{out['upload_s']:.2f} s; {out['searches']} searches at centroids "
        f"{SERVER_NPROBES}, {mismatched} answered other than the raw request, {not_first} "
        f"not first at centroids 8; zstd round trip equal {zstd_same}; chat "
        f"{reply == CHAT_REPLY}; an empty upload raised ClientError {error} (raw {status})")
    return out


def entry_check(tmp, failures) -> dict:
    """`python -m vectorsearch_tpu_torch config.json` with the noop
    embedder: boot, one upload and one search, exit 0 on SIGTERM."""
    from vectorsearch_tpu_torch.tools.http_driver import (
        Client, free_port, wait_listening)

    port = free_port()
    path = os.path.join(tmp, "entry.json")
    with open(path, "w") as f:
        json.dump({"server": {"http_address": f"127.0.0.1:{port}",
                              "https_address": f"127.0.0.1:{free_port()}"},
                   "database": {"sqlite": os.path.join(tmp, "entry.db"),
                                "snapshots": os.path.join(tmp, "entry_snaps")},
                   "log_level": "info"}, f)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, VSTPU_NOOP_AI="1", PYTHONPATH=root)
    out = {}
    with open(os.path.join(tmp, "entry.log"), "w+b") as log_file:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "vectorsearch_tpu_torch", path],
                                cwd=root, env=env, stdout=log_file, stderr=subprocess.STDOUT)
        try:
            wait_listening(port, lambda: proc.poll() is None, 300)
            out["listen_s"] = time.perf_counter() - t0
            c = Client(port)
            up = c.post("/api/upload", {"owner": "o", "category": "c", "documents": [
                {"name": "entry", "document": {"text": "entry check"}}]})["document_ids"]
            got = c.post("/api/search", {"owner": "o", "category": "c", "text": "entry check",
                                         "count": 1, "centroids": -1})["documents"]
            out["answered"] = [d["document_id"] for d in got] == up
            c.conn.close()
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            out["rc"] = proc.wait(timeout=30)
            out["exit_s"] = time.perf_counter() - t1
        except Exception as e:
            failures.append(f"entry check: {e!r}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        log_file.seek(0)
        text = log_file.read().decode(errors="replace")
    out["device_line"] = next((ln.split("\t")[-1] for ln in text.splitlines()
                               if "\tdevice " in ln), None)
    if not (out.get("answered") and out.get("rc") == 0):
        failures.append(f"entry check: {out}; its log ends:\n{text[-3000:]}")
    log(f"entry: python -m vectorsearch_tpu_torch listening in {out.get('listen_s', -1):.1f} s "
        f"({out['device_line']}), answered {out.get('answered')}, exit {out.get('rc')} "
        f"{out.get('exit_s', -1):.2f} s after SIGTERM")
    return out


def phase_build10m(torch, dev, n=BUILD_N, k=BUILD_K) -> dict:
    """bench_build.py's build: clustered packed rows from k generating
    centers, made on the card, moved to host numpy once, then
    build_centroids with bench_build.py's arguments (scale_corpus.build).
    The rows are returned under "rows", the build under "result", for
    profile_build and the 10M serving and engine phases."""
    from vectorsearch_tpu_torch.tools.scale_corpus import build, packed_host

    t0 = time.perf_counter()
    host = packed_host(dev, n, DIM, k, seed=0)
    torch.cuda.empty_cache()
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    result = build(host, dev, k=k)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    out = {
        "n": n, "k_asked": k, "gen_s": gen_s, "build_s": build_s,
        "k": int(result.centroids.shape[0]), "iterations": result.iterations,
        "final_churn": result.final_changes,
        "max_cluster": int(result.counts.max()), "mean_cluster": float(result.counts.mean()),
        "assigned": int(result.counts.sum()),
        "finite": bool(np.isfinite(result.centroids).all()),
        "peak_device_GiB": peak / 2**30,
    }
    log(f"build10m: {n}x{DIM} clustered rows made and moved to host in {gen_s:.1f} s; "
        f"build_centroids k={k}: {build_s:.1f} s, {out['k']} centroids, "
        f"{out['iterations']} iters, final churn {out['final_churn']}, max/mean cluster "
        f"{out['max_cluster']}/{out['mean_cluster']:.1f}, peak device memory "
        f"{out['peak_device_GiB']:.2f} GiB")
    out["rows"], out["result"] = host, result
    return out


def profile_build(torch, host, dev, k=BUILD_K, top=10) -> dict:
    """phase_build10m's build once more under torch.profiler: device time summed
    by kernel name (CUDA rows only), its total, and the profiled wall (the
    profiler slows the host, so build seconds come from the unprofiled
    build)."""
    from torch.autograd import DeviceType

    from vectorsearch_tpu_torch.tools.scale_corpus import build

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        build(host, dev, k=k)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    sums = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            sums[e.key] = sums.get(e.key, 0.0) + e.self_device_time_total / 1e3
    total = sum(sums.values())
    by_name = dict(sorted(sums.items(), key=lambda kv: -kv[1])[:top])
    log(f"build10m profile: device {total:.1f} ms in a {wall_s:.1f} s profiled build; by "
        f"kernel (ms): " + "; ".join(f"{name[:70]} {ms:.1f}" for name, ms in by_name.items()))
    return {"device_ms": total, "profiled_wall_s": wall_s, "kernel_ms": by_name}


def band_timing(torch, dev, smi, rows) -> dict:
    """Both band kernels on phase 11's rows on the card (N=10M, D=768),
    a hundredth of them dead: against their plain versions at each batch
    of SERVE10M_BAND_BS, queries near corpus rows (s8 bit-equal, bf16
    within KERNEL_ATOL, the same -inf pattern), then at B=N_QUERIES, the
    flat search's batch: the time of 10 launches back to back and of one, the
    plain version's, the library yardstick's (the product alone) and the
    bound."""
    from vectorsearch_tpu_torch.device import upload_packed
    from vectorsearch_tpu_torch.kernels import cosine
    from vectorsearch_tpu_torch.kernels import flat as tf

    full = upload_packed(rows, dev)
    n = full.codes.shape[0]
    gen = torch.Generator(device=dev).manual_seed(13)
    pick = torch.randint(0, n, (N_QUERIES,), generator=gen, device=dev)
    q = full.offset[pick, None] + full.scale[pick, None] * full.codes[pick].float()
    qn = cosine.l2_normalize(q + 0.1 * torch.randn(q.shape, generator=gen, device=dev))
    a, bv = full.scale * full.inv_norm, full.offset * full.inv_norm
    bias = torch.where(torch.rand((n,), generator=gen, device=dev) > 0.01, 0.0, float("-inf"))
    corpus = (full.codes, a, bv, bias)
    del q, pick
    out = {}
    for name, fn, ref in (("flat_bands_s8", tf.flat_bands_s8, tf.flat_bands_s8_ref),
                          ("flat_bands_bf16", tf.flat_bands_bf16, tf.flat_bands_bf16_ref)):
        def args(b):
            if name == "flat_bands_s8":
                qc, sq, qsum = cosine.quantize_queries(qn[:b])
                return (qc, sq, qsum, *corpus)
            return (qn[:b].bfloat16(), qn[:b].sum(-1), *corpus)

        errs = {b: check_bands(torch, name, fn, ref, args(b), f"N={n} B={b}")
                for b in SERVE10M_BAND_BS}
        main_args = args(N_QUERIES)
        r = {"max_abs_err": max(errs.values()),
             "max_abs_err_by_B": {str(b): e for b, e in errs.items()},
             "checked_at": f"B={' and '.join(map(str, SERVE10M_BAND_BS))}, N={n}, D={DIM}",
             "ms_at": f"B={N_QUERIES}, N={n}, D={DIM}, 10 launches back to back",
             **band_row(torch, name, fn, ref, main_args, runs=10, plain_runs=3)}
        del main_args
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"
        log(f"{name} N={n} D={DIM}: max |kernel - plain| "
            + ", ".join(f"{e:.3g} at B={b}" for b, e in errs.items()) + "; "
            f"at B={N_QUERIES} kernel {r['ms']:.3f} ms (10 launches back to back; one launch "
            f"{r['single_launch_ms']:.3f}), plain {r['plain_ms']:.3f} ms, library {lib} "
            f"(product only), bound {r['bound_ms']:.3f} ms ({r['bound_by']}), share "
            f"{r['share']:.3f} ({smi})")
        out[name] = r
    del full, corpus, a, bv, bias
    torch.cuda.empty_cache()
    return out


def phase_serve10m(torch, dev, smi, rows, result) -> dict:
    """bench_10m_serving on phase 11's rows and build (no second build):
    the queries and the exact-f32 truth over the original rows, IVFIndex
    under the engine's device budget at nprobe 1 / 8 / 64 and nprobe 1 at
    large batches, FlatIndex.search and flat_search (s8, bf16). Outside the
    phase's launch counts: the scan kernel on this 10M store at
    SERVE10M_CHECK_NPROBES against its plain version (scan_timing), and the
    band kernels at N=10M (band_timing)."""
    from vectorsearch_tpu_torch.device import upload_packed
    from vectorsearch_tpu_torch.kernels import cosine
    from vectorsearch_tpu_torch.kernels import flat as tf
    from vectorsearch_tpu_torch.kernels import grouped_scan as gs
    from vectorsearch_tpu_torch.tools import bench_10m_serving as bs
    from vectorsearch_tpu_torch.tools import scale_corpus as sc

    n = rows.codes.shape[0]
    out, failures = {"n": n}, []
    t0 = time.perf_counter()
    queries = sc.make_queries(rows)
    truth = sc.exact_truth(queries, dev, n, DIM, BUILD_K, seed=0)
    out["truth_s"] = time.perf_counter() - t0
    log(f"serve10m: {N_QUERIES} queries and their exact-f32 truth over the {n} original rows "
        f"in {out['truth_s']:.1f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    out["index"], out["build"], ivf = bs.index_rows(rows, result.centroids, result.assignments,
                                                    queries, truth, dev)
    for r in out["index"]:
        floor = MIN_RECALL.get(r["nprobe"], MIN_RECALL_WIDE)
        if r["batch"] == N_QUERIES and r["recall"] < floor:
            failures.append(f"recall@10 {r['recall']:.4f} < {floor} at nprobe={r['nprobe']}")
    launches = gs.LAUNCHES
    qn = cosine.l2_normalize(torch.from_numpy(queries).to(dev))
    out["scan"] = scan_timing(
        torch, dev, smi, f"10M index store K={ivf.k_clusters} cap={ivf.cap}",
        (ivf.buckets.codes, *ivf.folded, ivf.counts_dev), qn,
        {p: gs.probe(qn, ivf.centroids_n, p) for p in SERVE10M_CHECK_NPROBES
         if p <= ivf.k_clusters})
    gs.LAUNCHES = launches
    out["peak_device_GiB"] = torch.cuda.max_memory_allocated(dev) / 2**30
    del ivf, qn
    torch.cuda.empty_cache()
    out["flat"] = bs.flat_rows(upload_packed(rows, dev), queries, truth, dev)
    for r in out["flat"]:
        if r["recall"] < MIN_RECALL_WIDE:
            failures.append(f"{r['label']}: recall@10 {r['recall']:.4f} < {MIN_RECALL_WIDE}")
    torch.cuda.empty_cache()
    launches = tf.S8_LAUNCHES, tf.BF16_LAUNCHES
    out["bands"] = band_timing(torch, dev, smi, rows)
    tf.S8_LAUNCHES, tf.BF16_LAUNCHES = launches
    out["queries"], out["truth"] = queries, truth
    out["failures"] = failures
    return out


def phase_engine10m(torch, dev, smi, rows, result, queries, truth) -> dict:
    """engine_10m_check on the first ENGINE10M_N of phase 11's rows and
    its build's centroids and assignments (the truth computed again when
    the rows are cut), over a temporary directory removed afterwards."""
    from vectorsearch_tpu_torch.host import layout
    from vectorsearch_tpu_torch.tools import engine_10m_check as ec
    from vectorsearch_tpu_torch.tools import scale_corpus as sc

    n = min(ENGINE10M_N, rows.codes.shape[0])
    assignments = result.assignments[:n]
    if n < rows.codes.shape[0]:
        if n % sc.STEP:  # regen_slabs makes the first n rows again slab by slab
            raise ValueError(f"ENGINE10M_N {n} is not a multiple of {sc.STEP}")
        rows = layout.PackedVectors(*[a[:n] for a in rows])
        queries = sc.make_queries(rows)
        truth = sc.exact_truth(queries, dev, n, DIM, BUILD_K, seed=0)
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(prefix="vs_engine10m_") as tmp:
        out = ec.check(rows, result.centroids, assignments, queries, truth, dev, tmp)
    out["peak_device_GiB"] = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"engine10m: {n} documents; populate {out.get('populate_s', 0):.1f} s, peak device "
        f"memory {out['peak_device_GiB']:.2f} GiB, peak RSS {out['peak_rss_GB']:.2f} GB, "
        f"failures {out['failures']} ({smi})")
    return out




def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from vectorsearch_tpu_torch.kernels import flat as tf
    from vectorsearch_tpu_torch.kernels import grouped_scan
    from vectorsearch_tpu_torch.kernels import kmeans as km

    dev = torch.device("cuda", 0)
    smi = phase_env(torch)
    ptxas = phase_build()
    entries = [phase_kernel(torch, dev, smi), *phase_kmeans_kernels(torch, dev, smi),
               *phase_flat_kernels(torch, dev, smi, ptxas)]
    entries[2].update(ptxas=ptxas["accumulate"], ptxas_warnings=ptxas["accumulate_warnings"])

    def run(phase, fn):
        """fn() with every launch count set to 0 just before and read just
        after: the main path's own launches."""
        grouped_scan.LAUNCHES = km.ASSIGN_LAUNCHES = km.ACCUMULATE_LAUNCHES = 0
        tf.S8_LAUNCHES = tf.BF16_LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn()
        log(f"the {phase} phase took {time.perf_counter() - t0:.1f} s")
        launches[phase] = {"grouped_scores": grouped_scan.LAUNCHES,
                           "kmeans_assign": km.ASSIGN_LAUNCHES,
                           "kmeans_accumulate": km.ACCUMULATE_LAUNCHES,
                           "flat_bands_s8": tf.S8_LAUNCHES,
                           "flat_bands_bf16": tf.BF16_LAUNCHES}
        log(f"launches in the {phase} phase: {launches[phase]}")
        return out

    launches = {}
    idx = run("index", lambda: phase_index(torch, dev, smi))
    # the scan kernel's row: its time where the main path launches it, on the
    # built index's store; the synthetic store's times stay beside it
    scan = idx.pop("scan")
    entries[0].update({f: scan[8][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "share", "library_ms")})
    entries[0].update({
        "ms_at": f"nprobe=8, B={N_QUERIES}, the 1M index's store K={idx['k']} "
                 f"cap={idx['cap']}, D={DIM}",
        "by_nprobe_index_store": scan, "ptxas": ptxas["grouped_scores"],
        "ptxas_warnings": ptxas["grouped_scores_warnings"]})
    flat = run("flat", lambda: phase_flat(torch, dev, *idx.pop("flat_inputs")))
    sharded_inputs = idx.pop("sharded_inputs")
    shd = run("sharded", lambda: phase_sharded(torch, dev, smi, *sharded_inputs))
    # the scan held against plain on one shard's store of the sharded path
    entries[0]["sharded_shard_checks"] = shd["scan_checks"]
    entries[0]["max_abs_err"] = max([entries[0]["max_abs_err"],
                                     *(c["max_abs_err"] for c in shd["scan_checks"].values())])
    # the graft entry points, the full-width forward on phase 4's index
    grf = run("graft", lambda: phase_graft(torch, dev, smi, sharded_inputs[-1],
                                           sharded_inputs[4]))
    # phase 4's host rows, build, queries and truth; its device index goes
    engine_inputs = [sharded_inputs[i] for i in (0, 2, 3, 4, 5)]
    del sharded_inputs
    torch.cuda.empty_cache()
    eng = run("engine", lambda: phase_engine(torch, dev, engine_inputs))
    del engine_inputs
    srv = run("server", lambda: phase_server(torch, dev, smi))
    torch.cuda.empty_cache()
    b10 = run("build10m", lambda: phase_build10m(torch, dev))
    rows10, build10 = b10.pop("rows"), b10.pop("result")
    # outside run(): its launches are not the main path's
    b10["profile"] = profile_build(torch, rows10, dev)
    s10 = run("serve10m", lambda: phase_serve10m(torch, dev, smi, rows10, build10))
    queries10, truth10 = s10.pop("queries"), s10.pop("truth")
    e10 = run("engine10m", lambda: phase_engine10m(torch, dev, smi, rows10, build10,
                                                   queries10, truth10))
    del rows10
    # the kernels' rows at the 10M shapes, beside the 1M ones
    entries[0]["by_nprobe_10M_store"] = s10["scan"]
    entries[0]["max_abs_err"] = max([entries[0]["max_abs_err"],
                                     *(r["max_abs_err"] for r in s10["scan"].values())])
    for e in entries:
        if e["name"] in s10["bands"]:
            e["at_10M"] = s10["bands"][e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"], e["at_10M"]["max_abs_err"])

    failures = []
    for nprobe, r in idx["recall"].items():
        floor = MIN_RECALL.get(nprobe, MIN_RECALL_WIDE)
        if r < floor:
            failures.append(f"recall@10 {r:.4f} < {floor} at nprobe={nprobe}")
    failures += [f"index phase: {f}" for f in idx["bulk"]["failures"]]
    for phase, names in PHASE_KERNELS.items():
        idle = [k for k in names if not launches[phase][k]]
        if idle:
            failures.append(f"not launched in the {phase} phase: {idle}")
    failures += [f"sharded phase: {f}" for f in shd["failures"]]
    failures += [f"graft phase: {f}" for f in grf["failures"]]
    # the scan once a shard of every search on the card's shards
    if launches["sharded"]["grouped_scores"] < SHARDED_SHARDS * shd["virtual_searches"]:
        failures.append(f"sharded phase: {launches['sharded']['grouped_scores']} scan "
                        f"launches for {shd['virtual_searches']} searches of "
                        f"{SHARDED_SHARDS} shards")
    for name, r in flat.items():
        if r["recall"] < MIN_RECALL_WIDE:
            failures.append(f"flat {name}: recall@10 {r['recall']:.4f} < {MIN_RECALL_WIDE}")
        if r["repeats"] or not r["finite"]:
            failures.append(f"flat {name}: {r}")
    if idx["self_top1"] < 1.0:
        failures.append(f"inserted rows found themselves first in {idx['self_top1']:.4f}")
    if idx["deleted_returned"] or idx["n_live"] != idx["expected_live"]:
        failures.append(f"deletes: {idx['deleted_returned']} returned, "
                        f"n_live {idx['n_live']} != {idx['expected_live']}")
    if not (eng["rebuilt"] and eng["clusters"] > 1 and eng["delete_ok"]
            and min(eng["hits"]) > 0 and eng["reboot_hits"] > 0
            and eng["reboot_live"] == eng["live"] - eng["deleted_vectors"]):
        failures.append(f"engine phase: {eng}")
    failures += [f"engine phase: {f}" for f in eng["failures"]]
    failures += [f"server phase: {f}" for f in srv["failures"]]
    if not (b10["finite"] and b10["assigned"] == b10["n"] and b10["iterations"] >= 1
            and 1 < b10["k"] <= 2 * b10["k_asked"]):
        failures.append(f"10M build: {b10}")
    failures += [f"serve10m phase: {f}" for f in s10["failures"]]
    failures += [f"engine10m phase: {f}" for f in e10["failures"]]
    if "jax" in sys.modules:
        failures.append("jax was imported")
    jax_pkg = sorted(m for m in sys.modules
                     if m == "vectorsearch_tpu" or m.startswith("vectorsearch_tpu."))
    if jax_pkg:
        failures.append(f"the JAX package was imported: {jax_pkg}")
    if failures:
        for f in failures:
            print("FAIL: " + f, file=sys.stderr)
        return 1

    for e in entries:
        e["launches_by_phase"] = {p: v[e["name"]] for p, v in launches.items()}
        e["launches"] = sum(e["launches_by_phase"].values())
    log(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s ({smi})")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # a phase that raised fails the run like a failed check
        traceback.print_exc()
        print(f"FAIL: {type(exc).__name__}: {exc}", file=sys.stderr)
        sys.exit(1)
