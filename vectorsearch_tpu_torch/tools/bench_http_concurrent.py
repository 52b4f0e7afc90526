"""Concurrent-HTTP batcher benchmark: counterpart of
tools/bench_http_concurrent.py.

    VSTPU_DEVICE=cpu python -m vectorsearch_tpu_torch.tools.bench_http_concurrent
    python -m vectorsearch_tpu_torch.tools.bench_http_concurrent      # the card
    python -m vectorsearch_tpu_torch.tools.bench_http_concurrent \\
        --external http://host:port --owner scale --category corpus

The engine coalesces concurrent searches into single device dispatches
(engine/batcher.py). This measures whether that multiplies served
throughput:
  1. the hermetic boot: a clustered corpus from seed 0 (K seed directions
     plus noise), per-cluster mean centroids and each row's exact nearest
     one, SQL rows with their true centroid_id (engine_10m_check.populate,
     so no rebuild), the engine booted from SQL, the seeded provider that
     maps `q<i>` to query i (engine_10m_check.QueryAI), and api/http.py's
     router on a free localhost port; or a running server (--external);
  2. a sequential pass: 1 client, min(REQS, 128) requests;
  3. the sweep: for each client count C, C threads with a keep-alive
     connection each share REQS requests at nprobe NPROBE: requests/s, the
     batcher's dispatches and rows per dispatch (engine stats, or
     /api/stats), p50/p99 ms, errors;
  4. after the hermetic sweep, whose clients run in this interpreter beside
     the server, the same sweep again from a client process of its own
     (this tool with --external), so that the clients' work is not the
     server's;
  5. one JSON line with the table on stdout (the JAX tool's keys, and
     `sweep_client_process` after a hermetic sweep; mode `gpu`, `cpu` or
     `external`); the log on stderr.

Env: VSTPU_HTTPB_N (50000), VSTPU_HTTPB_K (64), VSTPU_HTTPB_CLIENTS
("1,8,32"), VSTPU_HTTPB_REQS (requests a sweep point, 256),
VSTPU_HTTPB_NPROBE (8), VSTPU_HTTPB_DIM (768). The hermetic boot's device
is device.resolve(None): VSTPU_DEVICE, else the card, else NoDeviceError.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.parse

import numpy as np

from .. import logger, native
from ..device import resolve
from ..engine import Engine, EngineCache
from ..quant import layout
from ..store import Store
from . import engine_10m_check as ec
from .host_profile import device_name
from .http_driver import Client, serving_app

DIM = int(os.environ.get("VSTPU_HTTPB_DIM", 768))
N = int(os.environ.get("VSTPU_HTTPB_N", 50_000))
K = int(os.environ.get("VSTPU_HTTPB_K", 64))
NPROBE = int(os.environ.get("VSTPU_HTTPB_NPROBE", 8))
REQS = int(os.environ.get("VSTPU_HTTPB_REQS", 256))
CLIENTS = tuple(int(c) for c in os.environ.get("VSTPU_HTTPB_CLIENTS", "1,8,32").split(","))
SEQUENTIAL = 128
TOPK = 10
N_QUERIES = 256
TIMEOUT = 600


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def corpus(n: int = N, k: int = K, dim: int = DIM):
    """The JAX tool's hermetic corpus: (packed rows, centroids f32 [k, dim],
    assignments, queries f32 [256, dim])."""
    rng = np.random.default_rng(0)
    seeds = rng.standard_normal((k, dim)).astype(np.float32)
    member = rng.integers(0, k, size=n)
    rows = seeds[member] + 0.3 * rng.standard_normal((n, dim)).astype(np.float32)
    packed = layout.pack_float(rows)
    cents = np.stack([rows[member == c].mean(0) for c in range(k)]).astype(np.float32)
    cn = cents / np.linalg.norm(cents, axis=1, keepdims=True)
    xn = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    assign = np.argmax(xn @ cn.T, axis=1)
    queries = rows[rng.choice(n, size=N_QUERIES, replace=False)] + 0.1 * (
        rng.standard_normal((N_QUERIES, dim)).astype(np.float32))
    return packed, cents, assign, queries


def boot(packed, centroids, assignments, queries, dev):
    """The rows in a fresh in-memory SQL store (owner `scale`, category
    `corpus`, each row's centroid_id its assignment), then an engine booted
    from it with QueryAI(queries). Returns (engine, store, populate and
    boot seconds)."""
    store = Store(":memory:")
    try:
        secs = {"populate_s": ec.populate(store, packed, centroids, assignments)["populate_s"]}
        t0 = time.perf_counter()
        eng = Engine(store, ec.QueryAI(queries), cache=EngineCache(ttl=60.0), device=dev)
    except BaseException:
        store.close()
        raise
    secs["boot_s"] = time.perf_counter() - t0
    log(f"httpb: {packed.codes.shape[0]} rows populated in {secs['populate_s']:.1f} s, engine "
        f"booted from SQL in {secs['boot_s']:.1f} s on {dev}")
    return eng, store, secs


def batcher_stats(host, port, eng) -> dict:
    """The batcher's counts: the engine's own, or a server's /api/stats."""
    if eng is not None:
        return eng.stats()["batcher"]
    c = Client(port, TIMEOUT, host)
    try:
        return c.call("GET", "/api/stats")[2]["batcher"]
    finally:
        c.conn.close()


def run_load(host, port, owner, category, n_threads, total_reqs, nprobe, eng) -> dict:
    """n_threads clients issue total_reqs single-query searches: requests/s,
    dispatches, rows a dispatch, p50/p99 ms, errors."""
    per = max(1, total_reqs // n_threads)
    total = per * n_threads
    before = batcher_stats(host, port, eng)
    errors = []
    lats = [[] for _ in range(n_threads)]
    barrier = threading.Barrier(n_threads)

    def worker(i):
        try:
            c = Client(port, TIMEOUT, host)
            barrier.wait(120)
            for r in range(per):
                t0 = time.perf_counter()
                c.post("/api/search", {
                    "owner": owner, "category": category,
                    "text": f"q{(i * per + r) % N_QUERIES}",
                    "count": TOPK, "centroids": nprobe})
                lats[i].append(time.perf_counter() - t0)
            c.conn.close()
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if errors:
        log(f"httpb: {len(errors)} errors at C={n_threads}: {errors[0]!r}")
    after = batcher_stats(host, port, eng)
    disp = after["dispatches"] - before["dispatches"]
    rows = after["rows_served"] - before["rows_served"]
    flat = np.array([x for lat in lats for x in lat]) * 1e3
    return {
        "clients": n_threads, "requests": total, "qps": total / dt, "dispatches": disp,
        "rows_per_dispatch": rows / max(1, disp),
        "p50_ms": float(np.percentile(flat, 50)) if flat.size else None,
        "p99_ms": float(np.percentile(flat, 99)) if flat.size else None,
        "errors": len(errors),
    }


def sweep(port, owner=ec.OWNER, category=ec.CATEGORY, eng=None, host="127.0.0.1") -> list:
    """Steps 2-3 against a server: the warm-up, the sequential pass, then
    each client count of CLIENTS at REQS requests and nprobe NPROBE; the
    sweep's points (C=1 is the sequential pass)."""
    if eng is not None:
        eng.warmup(nprobes=(NPROBE,))
    c = Client(port, TIMEOUT, host)
    c.post("/api/search", {"owner": owner, "category": category, "text": "q0",
                           "count": TOPK, "centroids": NPROBE})
    c.conn.close()
    seq = run_load(host, port, owner, category, 1, min(REQS, SEQUENTIAL), NPROBE, eng)
    log(f"httpb: sequential {seq['qps']:.1f} requests/s (p50 {seq['p50_ms']:.1f} ms)")
    points = []
    for n in CLIENTS:
        if n == 1:
            points.append(seq)
            continue
        r = run_load(host, port, owner, category, n, REQS, NPROBE, eng)
        r["speedup_vs_seq"] = r["qps"] / seq["qps"]
        log(f"httpb: C={n} -> {r['qps']:.1f} requests/s ({r['speedup_vs_seq']:.2f}x seq), "
            f"{r['rows_per_dispatch']:.2f} rows/dispatch, p50 {r['p50_ms']:.1f} ms "
            f"p99 {r['p99_ms']:.1f} ms")
        points.append(r)
    return points


def client_process_sweep(port, owner=ec.OWNER, category=ec.CATEGORY) -> list:
    """The same sweep with its clients in a process of their own (this
    tool with --external): the hermetic sweep's clients share the server's
    interpreter, so the two together tell the clients' cost from the
    server's. Returns that process's sweep points."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, VSTPU_HTTPB_CLIENTS=",".join(map(str, CLIENTS)),
               VSTPU_HTTPB_REQS=str(REQS), VSTPU_HTTPB_NPROBE=str(NPROBE),
               PYTHONPATH=os.pathsep.join(filter(None, (root, os.environ.get("PYTHONPATH")))))
    proc = subprocess.run(
        [sys.executable, "-m", "vectorsearch_tpu_torch.tools.bench_http_concurrent",
         "--external", f"http://127.0.0.1:{port}", "--owner", owner, "--category", category],
        env=env, stdout=subprocess.PIPE, timeout=TIMEOUT, check=True, text=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])["sweep"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--external", default=None,
                    help="base URL of a running server (skip the hermetic boot)")
    ap.add_argument("--owner", default=ec.OWNER)
    ap.add_argument("--category", default=ec.CATEGORY)
    args = ap.parse_args(argv)
    # a line a search at info would be the tool's own cost
    logger.configure("warn")
    out = {"mode": "external", "n": None, "nprobe": NPROBE, "host_cores": os.cpu_count()}
    with contextlib.ExitStack() as stack:
        if args.external:
            url = urllib.parse.urlsplit(args.external)
            host, port, eng = url.hostname, url.port or 80, None
        else:
            dev = resolve(None)
            t0 = time.perf_counter()
            packed, cents, assign, queries = corpus(N, K, DIM)
            log(f"httpb: corpus built ({N} x {DIM}, K={K}) in {time.perf_counter() - t0:.1f} s")
            eng, store, secs = boot(packed, cents, assign, queries, dev)
            stack.callback(store.close)
            stack.callback(eng.close)
            host, port = "127.0.0.1", stack.enter_context(serving_app(eng))
            out.update(mode=dev.type if dev.type == "cpu" else "gpu", n=N, k=K, dim=DIM,
                       device=device_name(dev), native_codec=native.build_kind(), **secs)
        out["sweep"] = sweep(port, args.owner, args.category, eng, host)
        if eng is not None:
            out["sweep_client_process"] = client_process_sweep(port, args.owner, args.category)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
