"""The served engine over HTTP under batched search: closed-loop clients,
each request `POST /api/search` with `texts` query texts.

Set-up as vsbench/drivers/http.py's: the configuration's rows made on the
card from the seed, the in-memory SQL store populated in bulk (document
`r<row>`, id row + 1), the engine booted from it on the card with the
benchmark's embedding provider, warm-up at the cell's probe width, the
port's router on a free localhost port in this process; then the clients
(vsbench/drivers/http_batch_client.py) in a process of their own, each
warmed by `warm` requests. The traffic sends no uploads.

Window: `go` to the clients, which run their closed loop for the window's
seconds. search_qps = texts answered inside the window / seconds: a
request counts for all its texts when it answers 200 with one page a text
inside the window; one that answers another status, or fewer pages than
texts, is failed.

Answers: `sample` texts drawn by the seed from the window's answers,
against the reference's top `count` over the probed clusters
(vsbench/checks); each hit's document name against `r<row>`.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from vsbench import checks, corpus, span_sums, spans
from vsbench.drivers.http import (CATEGORY, OWNER, WAIT, _reference, _stop, make_provider,
                                  populate, release, window_s)
from vsbench.drivers.library import load_kernels
from vsbench.harness import Outcome, log
from vsbench.reference import codec

# the spans of a request, in the order it meets them (served.json_ms and
# served.pages_ms read four of them); logged a call in a traced run
REQUEST_SPANS = ("http.request", "http.parse", "engine.search_many", "engine.embed",
                 "batcher.wait", "batcher.dispatch", "ivf.search", "engine.pages",
                 "engine.sql_fetch", "engine.hits", "http.encode")


def setup(cell) -> dict:
    from vectorsearch_tpu_torch.engine import Engine, EngineCache
    from vectorsearch_tpu_torch.store import Store
    from vectorsearch_tpu_torch.tools.http_driver import serving_app

    tr = cell.traffic
    if int(tr["upload_clients"]):
        raise ValueError("the http_batch driver sends no uploads: upload_clients must be 0")
    recipe = corpus.Recipe.of(cell.config)
    gen = corpus.Corpus(recipe, cell.seed, cell.dev)
    wire, members = corpus.wire_rows(gen)
    centroids = gen.centroids()
    pool = corpus.query_pool(recipe, cell.seed, int(tr["query_pool"]),
                             lambda idx: codec.dequantize(wire[idx]))
    st = {"recipe": recipe, "wire": wire, "members": members, "pool": pool,
          "centroids": codec.dequantize(codec.quantize(centroids)),
          "nprobe": int(tr["nprobe"]), "stack": contextlib.ExitStack()}
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
                "pool": int(tr["query_pool"]), "batch": int(tr["texts"]),
                "count": int(tr["count"]), "nprobe": int(tr["nprobe"]),
                "search_clients": int(tr["search_clients"]), "warm": int(tr["warm"]),
                "seconds": window_s(cell), "sample": int(tr["sample"])}
        proc = subprocess.Popen([sys.executable, "-m", "vsbench.drivers.http_batch_client",
                                 json.dumps(plan)], cwd=str(cell.root), stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True)
        st["proc"] = proc
        st["stack"].callback(_stop, proc)
        line = proc.stdout.readline().strip()
        if line != "ready":
            raise RuntimeError(f"the clients did not start (said {line!r})")
    except BaseException:
        st["stack"].close()
        raise
    return st


def thread_cpu() -> dict:
    """{thread id: (role, CPU seconds)} of the router's threads in this
    process: its event loop (`vstpu-http`, tools/http_driver.serving_app)
    and the loop's executor (asyncio's `asyncio_<n>`)."""
    out = {}
    for t in threading.enumerate():
        role = ("loop" if t.name == "vstpu-http"
                else "executor" if t.name.startswith("asyncio_") else None)
        if role and t.ident is not None:
            with contextlib.suppress(OSError):  # the thread ended meanwhile
                out[t.ident] = (role, time.clock_gettime(time.pthread_getcpuclockid(t.ident)))
    return out


def _cpu_by_role(before: dict, after: dict) -> dict:
    by = {"loop": 0.0, "executor": 0.0}
    for ident, (role, cpu) in after.items():
        by[role] += cpu - before.get(ident, (role, 0.0))[1]
    return by


def window(st, cell, win) -> Outcome:
    eng, proc = st["engine"], st["proc"]
    batch = int(cell.traffic["texts"])
    before = eng.stats()
    cpu0, threads0 = os.times(), thread_cpu()
    win.start()
    proc.stdin.write("go\n")
    proc.stdin.flush()
    out = json.loads(proc.stdout.readline())
    win.stop()
    cpu1, threads1 = os.times(), thread_cpu()
    after = eng.stats()
    proc.wait(WAIT)
    if out["n_errors"]:
        log(f"http_batch: {out['n_errors']} client errors, the first: {out['errors'][:1]}")
    st["out"] = out
    s = window_s(cell)
    reqs = np.asarray(out["search"], np.float64).reshape(-1, 4)  # t0, t1, status, pages
    whole = (reqs[:, 2] == 200) & (reqs[:, 3] == batch)
    done = reqs[whole & (reqs[:, 1] <= s)]
    e2e = {"search_qps": len(done) * batch / s}
    cat = next(iter(after["categories"].values()))
    layer = {
        "batcher": {k: after["batcher"][k] - before["batcher"][k] for k in after["batcher"]},
        "boot": cat["boot"], "populate_s": st["populate_s"],
        "engine_boot_s": st["engine_boot_s"], "searches": len(reqs),
    }
    lat = (done[:, 1] - done[:, 0]) * 1e3
    threads = _cpu_by_role(threads0, threads1)
    bins = np.histogram(done[:, 1], bins=max(1, int(s // 5)), range=(0, s))[0].tolist()
    log(f"http_batch: {len(done)} requests of {batch} texts in {s} s, a 5 s {bins}; latency p50 / p95 "
        f"{np.percentile(lat, 50) if len(lat) else float('nan'):.2f} / "
        f"{np.percentile(lat, 95) if len(lat) else float('nan'):.2f} ms; cpu s: server user "
        f"{cpu1.user - cpu0.user:.2f} sys {cpu1.system - cpu0.system:.2f}, loop thread "
        f"{threads['loop']:.2f}, executor threads {threads['executor']:.2f}, client process "
        f"{out['client_cpu_s']:.2f}; populate {st['populate_s']:.1f} s, boot "
        f"{st['engine_boot_s']:.1f} s ({cat['boot']})")
    table = span_sums.table()
    if table:
        calls = {n: table[n] for n in REQUEST_SPANS if n in table}
        log("http_batch: spans, count / ms a call / thread cpu ms a call: " + "; ".join(
            f"{n} {v['count']} / {v['seconds'] / v['count'] * 1e3:.3f} / "
            f"{v['cpu_s'] / v['count'] * 1e3:.3f}" for n, v in calls.items())
            + f"; counters {spans.counters()}")
    return Outcome(attempted=len(reqs), failed=int((~whole).sum()), e2e=e2e, layer=layer)


def _sample(st, cell):
    """(queries as the engine received them f64 [Q, D], served rows [Q,
    count] (-1 past a short page), served similarities, names wrong)."""
    sample = st["out"]["sample"]
    k = int(cell.traffic["count"])
    rows = np.full((len(sample), k), -1, np.int64)
    sims = np.full((len(sample), k), np.nan)
    names_bad = 0
    for r, s in enumerate(sample):
        for j, (doc_id, sim, name) in enumerate(zip(s["ids"][:k], s["sims"], s["names"])):
            rows[r, j], sims[r, j] = doc_id - 1, sim
            names_bad += name != f"r{doc_id - 1}"
    queries = codec.dequantize(codec.quantize(st["pool"][[s["q"] for s in sample]]))
    return queries, rows, sims, names_bad


def _rows_f64(st):
    return lambda idx: codec.dequantize(st["wire"][np.asarray(idx, np.int64)])


def answers(st, cell) -> dict:
    queries, rows, sims, names_bad = _sample(st, cell)
    if not len(queries):
        return {"sim_err": float("inf"), "topk_gap": float("inf"), "bad_answers": 1,
                "name_mismatch": 0}
    ref_sims, _ = _reference(st, cell, queries, "f64")
    out = checks.judge_search(rows, sims, queries, _rows_f64(st), ref_sims, st["recipe"].n)
    out["name_mismatch"] = names_bad
    return out


def control(st, cell) -> dict:
    """The control in the program's place: the reference's answers to the
    sampled texts in TF32, judged the same way."""
    queries, _, _, _ = _sample(st, cell)
    ref_sims, _ = _reference(st, cell, queries, "f64")
    c_sims, c_rows = _reference(st, cell, queries, "tf32")
    out = checks.judge_search(c_rows, c_sims, queries, _rows_f64(st), ref_sims, st["recipe"].n)
    out["name_mismatch"] = 0
    return out
