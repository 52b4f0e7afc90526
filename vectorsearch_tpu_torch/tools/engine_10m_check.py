"""The whole engine at 10M x 768 on one device, through its own entry
point: counterpart of tools/engine_10m_check.py, and with --n 2000000 of
tools/engine_scale_check.py.

    python -m vectorsearch_tpu_torch.tools.engine_10m_check [--n N] [--k K] [--dir D]
    VSTPU_DEVICE=cpu python -m vectorsearch_tpu_torch.tools.engine_10m_check --n 20000 --k 16

In order:
  (a) populate: N documents and their wire rows written in bulk into a
      fresh SQLite store through the port's Store, the build's assignment
      in centroid_id (as a rebuild leaves it), document id = row + 1;
  (b) cold boot: Engine(store, ai, snapshot_dir) streams SQL, packs,
      builds the device buckets and writes the boot snapshot (the engine's
      own split of the seconds); a second Engine then boots warm from that
      snapshot. Both answer the 512 queries at nprobe 8 in-process, and
      their top-10 sets must agree but at ties;
  (c) the port's entry (__main__.run) in this process on the same store
      and snapshots, with QueryAI: the seconds until it listens; while its
      startup rebuild runs, one client searching one request at a time
      (the slowest search, the rebuild's seconds); then over HTTP recall@10
      at nprobe 8 against the exact truth, sequential latency, 64 threads x
      20 requests (requests/s, the mean device batch from /api/stats),
      batched texts with and without documents, 20 uploads of 10
      documents that must each find itself first, 20 deletes that must
      never come back, RSS and device bytes from /api/stats; then a clean
      stop.

The store and snapshots take about 3.3 KB a row on disk at D=768 (the SQL
rows, and up to three snapshot versions while the closing one is
written); too little free space is a failure that names the bytes needed.
Prints one JSON line; exits 1 if a check failed.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import re
import resource
import shutil
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from .. import config as config_mod
from .. import constants
from ..device import resolve
from ..embed.base import AIProvider
from ..quant import codec, layout
from ..store import Store
from ..store.db import compress
from . import bench_10m_serving as serving_tool
from . import scale_corpus as sc
from .http_driver import Client, fan_out, free_port, serving

N, K = 10_000_000, 4096
OWNER, CATEGORY = "scale", "corpus"
NPROBE = 8
THREADS, PER_THREAD = 64, 20
BATCH_REPS = (("ids", 20, False), ("docs", 5, True))
UPLOADS, UPLOAD_DOCS, DELETES = 20, 10, 20
MIN_HTTP_RECALL = 0.96
TIE = 1e-6  # the cold and warm boots search the same buckets
POPULATE_CHUNK = 200_000
LIVE_SEED = 29
# SQL bytes a row beyond its codes (header, sidecar-free row, indexes,
# the document row), and a snapshot's bytes a row beyond its codes
SQL_ROW_EXTRA, SNAP_ROW_EXTRA = 170, 32
SNAP_VERSIONS = 3
# seconds a request, and the entry's boot or stop, may take at 10M
REQUEST_TIMEOUT, SERVE_TIMEOUT = 600, 900


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class QueryAI(AIProvider):
    """The check's embedder: a text naming `q<i>` embeds to query i, one
    naming `live-<n>` to a vector drawn from n (so an uploaded document and
    a search for it embed alike), anything else to a vector drawn from its
    text."""

    def __init__(self, queries: np.ndarray):
        self.queries = np.asarray(queries, np.float32)

    def can_embed(self):
        return True

    def _vector(self, text: str) -> np.ndarray:
        m = re.search(r"\bq(\d+)\b", text)
        if m:
            return self.queries[int(m.group(1))]
        m = re.search(r"live-(\d+)", text)
        key = int(m.group(1)) if m else zlib.crc32(text.encode())
        return np.random.default_rng((LIVE_SEED, key)).standard_normal(
            self.queries.shape[1], dtype=np.float32)

    def embed(self, inputs, model=None):
        return list(codec.quantize(np.stack([self._vector(t) for t in inputs])))

    def embed_ctx_num(self):
        return 8192  # one section a document

    def generate(self, prompt, model=None):
        return ""

    def generate_stream(self, prompt, model=None):
        yield ""

    def chat(self, messages, model=None):
        return ""

    def chat_stream(self, messages, model=None):
        yield ""


# ------------------------------------------------------------------ steps


def disk_needed(n: int, dim: int) -> int:
    """Bytes the store and snapshots of n rows take at their peak."""
    return n * (dim + 8 + SQL_ROW_EXTRA + SNAP_VERSIONS * (dim + SNAP_ROW_EXTRA))


def populate(store: Store, packed, centroids, assignments) -> dict:
    """Rows written in bulk on the store's write connection, a commit a
    chunk; explicit ids make document id = embedding id = row + 1."""
    t0 = time.perf_counter()
    owner = store.get_or_create_owner(OWNER)
    cat = store.get_or_create_category(owner.id, CATEGORY)
    cent_ids = np.asarray(store.replace_centroids(
        cat.id, [codec.quantize(np.asarray(c, np.float32)).tobytes() for c in centroids], {}),
        np.int64)
    n = packed.codes.shape[0]
    empty_doc = compress(b"{}")
    now = time.time()
    with store._lock:
        conn = store._conn
        if conn.execute("SELECT COUNT(*) FROM documents").fetchone()[0]:
            raise RuntimeError("populate needs a fresh store")
        # the centroid_id index takes its keys in random order: keep its
        # pages in memory. A bulk load of a fresh store: no sync a commit
        saved = {p: conn.execute(f"PRAGMA {p}").fetchone()[0]
                 for p in ("cache_size", "synchronous")}
        conn.execute("PRAGMA cache_size=-1048576")
        conn.execute("PRAGMA synchronous=OFF")
        try:
            for start in range(0, n, POPULATE_CHUNK):
                m = min(POPULATE_CHUNK, n - start)
                rows = range(start + 1, start + m + 1)
                wires = layout.to_wire(layout.PackedVectors(
                    *[a[start : start + m] for a in packed]))
                cids = cent_ids[np.asarray(assignments[start : start + m])].tolist()
                with conn:
                    conn.executemany(
                        "INSERT INTO documents(id, name, external_id, last_updated, "
                        "document, category_id) VALUES (?, '', '', ?, ?, ?)",
                        ((i, now, empty_doc, cat.id) for i in rows))
                    conn.executemany(
                        "INSERT INTO embeddings(id, vector, document_id, centroid_id) "
                        "VALUES (?, ?, ?, ?)",
                        zip(rows, map(bytes, wires), rows, cids))
                if (start // POPULATE_CHUNK) % 10 == 0:
                    log(f"populate: {start + m}/{n} rows ({time.perf_counter() - t0:.0f} s)")
        finally:
            for p, v in saved.items():
                conn.execute(f"PRAGMA {p}={v}")
    secs = time.perf_counter() - t0
    log(f"populate: {n} rows in {secs:.1f} s ({n / secs:.0f} rows/s)")
    return {"category_id": cat.id, "populate_s": secs, "populate_rows_per_s": n / secs}


def release(dev) -> None:
    """Free what a closed engine left on the device before the next boot."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def top10(eng, n_queries: int):
    """(ids, similarities) [n_queries, 10] of queries q0.. at NPROBE
    through eng.search_many, in-process; -1 / -inf pad short pages."""
    pages = eng.search_many(OWNER, CATEGORY, [f"q{i}" for i in range(n_queries)],
                            count=sc.TOPK, centroids=NPROBE, include_documents=False)
    ids = np.full((n_queries, sc.TOPK), -1, np.int64)
    sims = np.full((n_queries, sc.TOPK), -np.inf, np.float32)
    for r, hits in enumerate(pages):
        ids[r, : len(hits)] = [h.document_id for h in hits]
        sims[r, : len(hits)] = [h.similarity for h in hits]
    return ids, sims


def boot_top10(make_engine, cat_id: int, n_queries: int, dev):
    """An engine booted by make_engine(): its boot stats, its seconds, and
    top10(); closed and its device memory released afterwards."""
    t0 = time.perf_counter()
    eng = make_engine()
    boot_s = time.perf_counter() - t0
    try:
        ids, sims = top10(eng, n_queries)
        boot = eng.stats()["categories"][cat_id]["boot"]
    finally:
        eng.close()
        del eng
        release(dev)
    return boot, boot_s, ids, sims


def peak_rss_bytes() -> int:
    """The process's peak resident set (getrusage's ru_maxrss, KiB on
    Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def serve_checks(entry, cfg, ai, port, truth, n, failures) -> dict:
    """Step (c): the entry in this process, its startup rebuild, and the
    HTTP checks."""
    out = {}
    b = truth.shape[0]

    def search(c, text, count=sc.TOPK, centroids=NPROBE):
        return c.post("/api/search", {"owner": OWNER, "category": CATEGORY, "text": text,
                                      "count": count, "centroids": centroids})["documents"]

    with serving(entry, cfg, ai, port, SERVE_TIMEOUT) as out["listen_s"]:
        c = Client(port, REQUEST_TIMEOUT)
        startup = [t for t in threading.enumerate() if t.name == "vstpu-startup"]
        t0 = noted = time.perf_counter()
        during = []
        while any(t.is_alive() for t in startup):
            t = time.perf_counter()
            if not search(c, f"q{len(during) % b}"):
                failures.append("a search during the startup rebuild found nothing")
            during.append((time.perf_counter() - t) * 1e3)
            if t - noted > 30:  # where the rebuild is (None: past its k-means)
                noted = t
                log(f"engine10m entry: startup work at {t - t0:.0f} s, build "
                    f"{c.call('GET', '/api/stats')[2]['build']}, {len(during)} searches, "
                    f"slowest {max(during):.0f} ms")
        out["rebuild_s"] = time.perf_counter() - t0
        out["during_rebuild"] = {"searches": len(during), "max_ms": max(during, default=None),
                                 "p50_ms": float(np.median(during)) if during else None}
        (cat,) = c.call("GET", "/api/stats")[2]["categories"].values()
        out["boot"], out["clusters"], out["cap"] = cat["boot"], cat["clusters"], cat[
            "bucket_capacity"]
        if cat["boot"].get("source") != "snapshot":
            failures.append(f"the entry's boot did not restore the snapshot: {cat['boot']}")
        log(f"engine10m entry: listening in {out['listen_s']:.1f} s ({cat['boot']}); startup "
            f"work (warmup + rebuild) ended {out['rebuild_s']:.1f} s later: {cat['clusters']} "
            f"clusters, cap {cat['bucket_capacity']}; searches "
            f"meanwhile {out['during_rebuild']}")

        # recall@10 at NPROBE over HTTP, one request at a time
        got = np.full((b, sc.TOPK), -1, np.int64)
        t0 = time.perf_counter()
        for i in range(b):
            ids = [d["document_id"] for d in search(c, f"q{i}")]
            got[i, : len(ids)] = ids
        out["sequential_ms"] = (time.perf_counter() - t0) / b * 1e3
        out["recall_at_10"] = sc.recall(got, truth + 1)
        if out["recall_at_10"] < MIN_HTTP_RECALL:
            failures.append(f"HTTP recall@10 {out['recall_at_10']:.4f} < {MIN_HTTP_RECALL} at "
                            f"nprobe {NPROBE}")
        log(f"engine10m HTTP: recall@10 {out['recall_at_10']:.4f} at nprobe {NPROBE} over {b} "
            f"requests, {out['sequential_ms']:.2f} ms each (sequential, host clock)")

        # THREADS clients at once
        def dispatches():
            return c.call("GET", "/api/stats")[2]["batcher"]["dispatches"]

        before = dispatches()
        jobs = [lambda cl, i=i: len(search(cl, f"q{i % b}")) for i in range(THREADS * PER_THREAD)]
        hits, wall = fan_out(port, THREADS, jobs, REQUEST_TIMEOUT)
        d = dispatches() - before
        out["concurrent"] = {"requests": len(jobs), "req_per_s": len(jobs) / wall,
                             "dispatches": d, "mean_device_batch": len(jobs) / max(1, d)}
        if min(hits) == 0:
            failures.append("a concurrent search found nothing")
        log(f"engine10m HTTP: {THREADS} threads x {PER_THREAD}: {out['concurrent']}")

        # batched texts, the server's largest batch
        bq = constants.MAX_QUERY_BATCH
        for label, reps, docs in BATCH_REPS:
            t0 = time.perf_counter()
            for r in range(reps):
                res = c.post("/api/search", {
                    "owner": OWNER, "category": CATEGORY, "count": sc.TOPK, "centroids": NPROBE,
                    "texts": [f"q{(r * bq + j) % b}" for j in range(bq)],
                    "include_documents": docs})["results"]
                if len(res) != bq or not all(x["documents"] for x in res):
                    failures.append(f"batched texts ({label}): {len(res)} results for {bq}")
            out[f"batched_{label}_qps"] = reps * bq / (time.perf_counter() - t0)
        log(f"engine10m HTTP: batched texts of {bq}: {out['batched_ids_qps']:.0f} queries/s "
            f"(ids), {out['batched_docs_qps']:.0f} (with documents)")

        # streaming uploads: each document finds itself first
        lat, new = [], {}
        for u in range(UPLOADS):
            keys = range(u * UPLOAD_DOCS, (u + 1) * UPLOAD_DOCS)
            t0 = time.perf_counter()
            got_ids = c.post("/api/upload", {"owner": OWNER, "category": CATEGORY, "documents": [
                {"name": f"live-{k}", "document": {"text": f"live-{k}"}} for k in keys]})[
                "document_ids"]
            lat.append(time.perf_counter() - t0)
            new.update(zip(keys, got_ids))
        not_first = [k for k, doc in new.items()
                     if [d["document_id"] for d in search(c, f"live-{k}", count=1)] != [doc]]
        out["upload"] = {"docs": len(new), "p50_ms": float(np.median(lat)) * 1e3,
                         "max_ms": max(lat) * 1e3, "docs_per_s": len(new) / sum(lat),
                         "not_first": len(not_first)}
        if len(new) != UPLOADS * UPLOAD_DOCS or not_first:
            failures.append(f"uploads: {len(new)} ids, {len(not_first)} not first at "
                            f"centroids {NPROBE}")

        # deletes: none may come back
        lat = []
        gone = list(new.items())[:DELETES]
        for _, doc in gone:
            t0 = time.perf_counter()
            if c.post("/api/delete/document", {"owner": OWNER, "category": CATEGORY,
                                               "document_id": doc}) != {}:
                failures.append(f"delete of document {doc} did not answer {{}}")
            lat.append(time.perf_counter() - t0)
        back = {d["document_id"] for k, _ in gone for d in search(c, f"live-{k}")}
        out["delete"] = {"docs": len(gone), "p50_ms": float(np.median(lat)) * 1e3,
                         "max_ms": max(lat) * 1e3,
                         "returned": len(back & {doc for _, doc in gone})}
        if out["delete"]["returned"]:
            failures.append(f"{out['delete']['returned']} deleted documents came back")
        log(f"engine10m HTTP: uploads {out['upload']}; deletes {out['delete']}")

        stats = c.call("GET", "/api/stats")[2]
        (cat,) = stats["categories"].values()
        out["rss_GB"] = (stats["rss_bytes"] or 0) / 1e9
        out["index_GB"] = cat["hbm_bytes"] / 1e9
        out["live_vectors"], out["spill"] = cat["live_vectors"], cat["spill"]
        out["devices"] = stats.get("devices", [])
        if cat["live_vectors"] != n + len(new) - len(gone):
            failures.append(f"live vectors {cat['live_vectors']} != {n + len(new) - len(gone)}")
        log(f"engine10m stats: RSS {out['rss_GB']:.2f} GB, index {out['index_GB']:.2f} GB on "
            f"the device, {out['live_vectors']} live, {out['spill']} spill; devices "
            f"{out['devices']}")
    return out


def check(packed, centroids, assignments, queries, truth, dev, workdir) -> dict:
    """Steps (a) to (c) over `workdir`, which must hold room for the store
    and snapshots. Returns the results, "failures" among them."""
    from .. import __main__ as entry
    from ..engine import Engine

    n, dim = packed.codes.shape
    out, failures = {"n": n, "nprobe": NPROBE}, []
    out["failures"] = failures
    need, free = disk_needed(n, dim), shutil.disk_usage(workdir).free
    out["disk_needed_bytes"], out["disk_free_bytes"] = need, free
    if free < need:
        failures.append(f"{free} bytes free in {workdir}, {need} needed for {n} rows")
        return out
    db, snaps = os.path.join(workdir, "store.db"), os.path.join(workdir, "snaps")
    ai = QueryAI(queries)
    store = Store(db)
    try:
        out.update(populate(store, packed, centroids, assignments))
        cat_id = out.pop("category_id")
        top = {}
        for name in ("cold", "warm"):
            boot, secs, ids, sims = boot_top10(
                lambda: Engine(store, ai, snapshot_dir=snaps, device=dev), cat_id,
                queries.shape[0], dev)
            out[f"{name}_boot"] = {"seconds": secs, **boot}
            top[name] = sims, ids
            log(f"engine10m {name} boot: {secs:.1f} s {boot}")
        if out["warm_boot"].get("source") != "snapshot":
            failures.append(f"the warm boot did not restore the snapshot: {out['warm_boot']}")
        out["boots_differ"] = sc.sets_differ(*top["warm"], *top["cold"], TIE)
        if out["boots_differ"]:
            failures.append(f"cold and warm boots: {out['boots_differ']} top-10 sets differ")
    finally:
        store.close()
    port = free_port()
    cfg = config_mod.Config.parse(json.dumps({
        "server": {"http_address": f"127.0.0.1:{port}", "https_address": ""},
        "database": {"sqlite": db, "snapshots": snaps}, "log_level": "warn"}))
    try:
        out["entry"] = serve_checks(entry, cfg, ai, port, truth, n, failures)
    except AssertionError as e:
        failures.append(str(e))
    release(dev)
    out["peak_rss_GB"] = peak_rss_bytes() / 1e9
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N, help="documents (default 10M)")
    ap.add_argument("--k", type=int, default=K,
                    help="generating centers and k-means clusters (default 4096)")
    ap.add_argument("--dir", default=None,
                    help="directory for the store and snapshots (default: a temporary one, "
                         "removed afterwards)")
    args = ap.parse_args(argv)
    dev = resolve(None)
    t0 = time.perf_counter()
    packed = sc.packed_host(dev, args.n, sc.DIM, args.k, seed=0)
    queries = sc.make_queries(packed)
    truth = sc.exact_truth(queries, dev, args.n, sc.DIM, args.k, seed=0)
    result = serving_tool.build(packed, args.k, dev)
    log(f"engine10m: rows, queries, truth and build in {time.perf_counter() - t0:.1f} s")
    with contextlib.ExitStack() as stack:
        workdir = args.dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="vs_engine10m_"))
        os.makedirs(workdir, exist_ok=True)
        out = check(packed, result.centroids, result.assignments, queries, truth, dev, workdir)
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps(out))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
