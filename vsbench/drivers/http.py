"""The served engine over HTTP, driven by closed-loop clients.

Set-up: the configuration's rows made on the card from the seed as wire
rows; an in-memory SQL store populated in bulk (each row a document named
`r<row>`, its embedding's centroid_id the seed's assignment, document id =
row + 1); the engine booted from that store on the card with the
benchmark's embedding provider (the stand-in for an external embedding
service: `q<i>` is pool query i, `u<n>` uploaded document n's vector);
warm-up at the cell's probe width; the port's router on a free localhost
port in this process; the clients in a process of their own
(vsbench/drivers/http_client.py), each warmed by `warm` requests.

Window: `go` to the clients, which run the traffic file's closed loop for
the window's seconds. search_qps = searches answered inside the window /
seconds; search_p95_ms and upload_p95_ms = the 95th percentile of the
requests answered inside the window, timed at the client.

Answers: a sample of the searches, drawn from the seed, against the
reference's top k over the probed clusters (vsbench/checks), each hit's
document name against the one written for it; every acknowledged upload
is searched for by its own text after the window and has to come back
first, under the id it was acknowledged with.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from vsbench import checks, corpus
from vsbench.drivers.library import load_kernels
from vsbench.harness import Outcome, log
from vsbench.trace import TRACE_CAP_S
from vsbench.reference import codec
from vsbench.reference import ivf as ref_ivf

OWNER, CATEGORY = "vsbench", "corpus"
POPULATE_CHUNK = 200_000
REF_SLAB = 250_000
WAIT = 600  # seconds for the clients to warm up, and to finish after the window


def make_provider(pool: np.ndarray, gen: corpus.Corpus):
    """The benchmark's embedding provider: wire rows (vsbench's own codec)
    of pool query i for a text naming `q<i>`, of uploaded document n's
    vector for one naming `u<n>`."""
    from vectorsearch_tpu_torch.embed.base import AIProvider

    class SeededProvider(AIProvider):
        def can_embed(self):
            return True

        def vector(self, text: str) -> np.ndarray:
            m = re.search(r"\bq(\d+)\b", text)
            if m:
                return pool[int(m.group(1))]
            m = re.search(r"\bu(\d+)\b", text)
            if m:
                return corpus.upload_vector(gen, int(m.group(1)))
            raise ValueError(f"the benchmark's provider has no vector for {text[:60]!r}")

        def embed(self, inputs, model=None):
            return list(codec.quantize(np.stack([self.vector(t) for t in inputs])))

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

    return SeededProvider()


def populate(store, wire: np.ndarray, centroids: np.ndarray, members: np.ndarray) -> float:
    """The rows written in bulk into a fresh store (a copy of the port's
    tools/engine_10m_check.populate): document id = embedding id = row + 1,
    each document named r<row>, its centroid_id the row's assignment.
    Returns the seconds it took."""
    from vectorsearch_tpu_torch.store.db import compress

    t0 = time.perf_counter()
    owner = store.get_or_create_owner(OWNER)
    cat = store.get_or_create_category(owner.id, CATEGORY)
    cent_ids = np.asarray(store.replace_centroids(
        cat.id, [bytes(r) for r in codec.quantize(centroids)], {}), np.int64)
    n = wire.shape[0]
    empty_doc = compress(b"{}")
    now = time.time()
    with store._lock:
        conn = store._conn
        saved = {p: conn.execute(f"PRAGMA {p}").fetchone()[0] for p in ("cache_size", "synchronous")}
        conn.execute("PRAGMA cache_size=-1048576")
        conn.execute("PRAGMA synchronous=OFF")
        try:
            for start in range(0, n, POPULATE_CHUNK):
                rows = range(start + 1, min(n, start + POPULATE_CHUNK) + 1)
                cids = cent_ids[members[start : start + len(rows)]].tolist()
                with conn:
                    conn.executemany(
                        "INSERT INTO documents(id, name, external_id, last_updated, "
                        "document, category_id) VALUES (?, ?, '', ?, ?, ?)",
                        ((i, f"r{i - 1}", now, empty_doc, cat.id) for i in rows))
                    conn.executemany(
                        "INSERT INTO embeddings(id, vector, document_id, centroid_id) "
                        "VALUES (?, ?, ?, ?)",
                        zip(rows, map(bytes, wire[start : start + len(rows)]), rows, cids))
        finally:
            for p, v in saved.items():
                conn.execute(f"PRAGMA {p}={v}")
    return time.perf_counter() - t0


def setup(cell) -> dict:
    from vectorsearch_tpu_torch.engine import Engine, EngineCache
    from vectorsearch_tpu_torch.store import Store
    from vectorsearch_tpu_torch.tools.http_driver import serving_app

    tr = cell.traffic
    recipe = corpus.Recipe.of(cell.config)
    gen = corpus.Corpus(recipe, cell.seed, cell.dev)
    wire, members = corpus.wire_rows(gen)
    centroids = gen.centroids()  # stored as wire rows: both sides see them so
    stored = codec.dequantize(codec.quantize(centroids))
    pool = corpus.query_pool(recipe, cell.seed, int(tr["query_pool"]),
                             lambda idx: codec.dequantize(wire[idx]))
    st = {"recipe": recipe, "gen": gen, "wire": wire, "members": members,
          "centroids": stored, "pool": pool, "stack": contextlib.ExitStack(),
          "nprobe": int(tr["nprobe"])}
    try:
        store = Store(":memory:")
        st["stack"].callback(store.close)
        st["populate_s"] = populate(store, wire, centroids, members)
        if cell.dev.type == "cuda":
            torch.cuda.synchronize(cell.dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(cell.dev)
        load_kernels(cell.dev)
        t0 = time.perf_counter()
        eng = Engine(store, make_provider(pool, gen), cache=EngineCache(ttl=60.0), device=cell.dev)
        st["stack"].callback(eng.close)
        st["engine_boot_s"] = time.perf_counter() - t0
        eng.warmup(nprobes=(int(tr["nprobe"]),))
        st["engine"] = eng
        port = st["stack"].enter_context(serving_app(eng))
        plan = {"port": port, "owner": OWNER, "category": CATEGORY, "seed": abs(int(cell.seed)),
                "pool": int(tr["query_pool"]), "count": int(tr["count"]),
                "nprobe": int(tr["nprobe"]), "search_clients": int(tr["search_clients"]),
                "upload_clients": int(tr["upload_clients"]),
                "docs_per_upload": int(tr.get("docs_per_upload", 0)), "warm": int(tr["warm"]),
                "seconds": window_s(cell), "sample": int(tr["sample"])}
        proc = subprocess.Popen([sys.executable, "-m", "vsbench.drivers.http_client", json.dumps(plan)],
                                cwd=str(cell.root), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                text=True)
        st["proc"] = proc
        st["stack"].callback(_stop, proc)
        line = proc.stdout.readline().strip()
        if line != "ready":
            raise RuntimeError(f"the clients did not start (said {line!r})")
    except BaseException:
        st["stack"].close()
        raise
    return st


def window_s(cell) -> int:
    """The clients' window: the run's seconds, traced at most TRACE_CAP_S."""
    return min(cell.seconds, TRACE_CAP_S) if cell.trace else cell.seconds


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
    proc.wait(WAIT)


def window(st, cell, win) -> Outcome:
    eng, proc = st["engine"], st["proc"]
    before = eng.stats()
    cpu0 = os.times()
    win.start()
    proc.stdin.write("go\n")
    proc.stdin.flush()
    out = json.loads(proc.stdout.readline())
    win.stop()
    cpu1 = os.times()
    after = eng.stats()
    proc.wait(WAIT)
    if out["n_errors"]:
        log(f"http: {out['n_errors']} client errors, the first: {out['errors'][:1]}")
    st["out"] = out
    s = window_s(cell)
    e2e = {}
    search = np.asarray(out["search"], np.float64).reshape(-1, 3)
    done = search[(search[:, 2] == 200) & (search[:, 1] <= s)]
    e2e["search_qps"] = len(done) / s
    if len(done):
        lat = (done[:, 1] - done[:, 0]) * 1e3
        e2e["search_p50_ms"], e2e["search_p95_ms"] = (float(np.percentile(lat, q)) for q in (50, 95))
    up = np.asarray(out["upload"], np.float64).reshape(-1, 3)
    up_done = up[(up[:, 2] == 200) & (up[:, 1] <= s)]
    if len(up_done):
        e2e["upload_p95_ms"] = float(np.percentile((up_done[:, 1] - up_done[:, 0]) * 1e3, 95))
    attempted = len(search) + len(up)
    failed = int((search[:, 2] != 200).sum() + (up[:, 2] != 200).sum())
    cat = next(iter(after["categories"].values()))
    layer = {
        "batcher": {k: after["batcher"][k] - before["batcher"][k] for k in after["batcher"]},
        "upload_batcher": {k: after["upload_batcher"][k] - before["upload_batcher"][k]
                           for k in after["upload_batcher"]},
        "boot": cat["boot"], "populate_s": st["populate_s"],
        "engine_boot_s": st["engine_boot_s"], "searches": len(search),
    }
    bins = np.histogram(done[:, 1], bins=max(1, int(s // 5)), range=(0, s))[0].tolist() if len(done) else []
    b = layer["batcher"]
    log(f"http: completions a 5 s {bins}; rows a dispatch "
        f"{b['rows_served'] / max(1, b['dispatches']):.3f}; server cpu user "
        f"{cpu1.user - cpu0.user:.2f} s sys {cpu1.system - cpu0.system:.2f} s; "
        f"latency p50 / p95 {e2e.get('search_p50_ms', float('nan')):.2f} / "
        f"{e2e.get('search_p95_ms', float('nan')):.2f} ms")
    log(f"http: {len(done)} searches in {s} s, {len(up)} uploads; populate "
        f"{st['populate_s']:.1f} s, boot {st['engine_boot_s']:.1f} s ({cat['boot']})")
    return Outcome(attempted=attempted, failed=failed, e2e=e2e, layer=layer)


def release(st) -> None:
    if "engine" in st and "out" in st:
        st["readback"] = readback(st, st["nprobe"])
    st.pop("engine", None)
    st["stack"].close()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def readback(st, nprobe: int) -> dict:
    """Every acknowledged upload searched for by its own text at the cell's
    probe width, in-process, before the engine closes: {document id:
    (upload number, first hit's id, its name)}."""
    acks = st.get("out", {}).get("acks", [])
    docs = [(first + j, doc_id) for a in acks for j, doc_id in enumerate(a["ids"])
            for first in [a["first"]]]
    got = {}
    for s in range(0, len(docs), 256):
        part = docs[s : s + 256]
        pages = st["engine"].search_many(OWNER, CATEGORY, [f"u{n}" for n, _ in part],
                                          count=1, centroids=nprobe)
        for (n, doc_id), hits in zip(part, pages):
            got[doc_id] = (n, hits[0].document_id if hits else -1, hits[0].name if hits else "")
    return got


def _uploaded(st) -> dict:
    """{document id: upload number n} of every acknowledged upload."""
    return {doc_id: a["first"] + j for a in st["out"]["acks"] for j, doc_id in enumerate(a["ids"])}


def _rows_f64(st):
    """Vectors by served row number: base rows, then uploads above n."""
    n = st["recipe"].n
    up = st["up_rows"]

    def rows(idx):
        idx = np.asarray(idx, np.int64)
        out = np.empty((len(idx), st["recipe"].dim), np.float64)
        base = idx < n
        out[base] = codec.dequantize(st["wire"][idx[base]])
        for j in np.nonzero(~base)[0]:
            out[j] = codec.dequantize(codec.quantize(
                corpus.upload_vector(st["gen"], up[int(idx[j])])[None]))[0]
        return out
    return rows


def _sample(st):
    """(queries as the engine received them f64 [Q, D], served rows [Q, k],
    served similarities, names right)."""
    n, k = st["recipe"].n, None
    up = _uploaded(st)
    st["up_rows"] = {}
    sample = st["out"]["sample"]
    k = max((len(s["ids"]) for s in sample), default=0)
    rows = np.full((len(sample), k), -1, np.int64)
    sims = np.full((len(sample), k), np.nan)
    names_bad = 0
    for r, s in enumerate(sample):
        for j, (doc_id, sim, name) in enumerate(zip(s["ids"], s["sims"], s["names"])):
            if doc_id <= n:
                row = doc_id - 1
                names_bad += name != f"r{row}"
            elif doc_id in up:
                row = n + len(st["up_rows"])
                st["up_rows"][row] = up[doc_id]
                names_bad += name != f"u{up[doc_id]}"
            else:
                row = 10**15  # a document the run never wrote
            rows[r, j], sims[r, j] = row, sim
    queries = codec.dequantize(codec.quantize(st["pool"][[s["q"] for s in sample]]))
    return queries, rows, sims, names_bad


def _slabs(st, dev):
    wire = st["wire"]
    for start in range(0, wire.shape[0], REF_SLAB):
        yield start, codec.dequantize(wire[start : start + REF_SLAB])


def _reference(st, cell, queries, precision):
    tr = cell.traffic
    return ref_ivf.search(queries, st["centroids"], st["members"], _slabs(st, cell.dev),
                          int(tr["nprobe"]), int(tr["count"]), cell.dev, precision)


def _readback_misses(st) -> int:
    got = st.get("readback", {})
    bad = 0
    for doc_id, (n, first, name) in got.items():
        bad += first != doc_id or name != f"u{n}"
    return bad + len(_uploaded(st)) - len(got)


def answers(st, cell) -> dict:
    queries, rows, sims, names_bad = _sample(st)
    if not len(queries):
        return {"sim_err": float("inf"), "topk_gap": float("inf"), "bad_answers": 1,
                "name_mismatch": 0, "upload_missing": 0}
    ref_sims, _ = _reference(st, cell, queries, "f64")
    out = checks.judge_search(rows, sims, queries, _rows_f64(st), ref_sims,
                              st["recipe"].n + len(st["up_rows"]))
    out["name_mismatch"] = names_bad
    out["upload_missing"] = _readback_misses(st)
    return out


def control(st, cell) -> dict:
    """The control in the program's place: the reference's answers to the
    sampled queries in TF32, judged the same way."""
    queries, _, _, _ = _sample(st)
    ref_sims, _ = _reference(st, cell, queries, "f64")
    c_sims, c_rows = _reference(st, cell, queries, "tf32")
    out = checks.judge_search(c_rows, c_sims, queries, _rows_f64(st), ref_sims, st["recipe"].n)
    out["name_mismatch"] = 0
    out["upload_missing"] = 0
    return out
