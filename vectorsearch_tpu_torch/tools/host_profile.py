"""Single-query host-path split: counterpart of tools/host_profile.py.

    VSTPU_DEVICE=cpu python -m vectorsearch_tpu_torch.tools.host_profile
    python -m vectorsearch_tpu_torch.tools.host_profile        # the card

Splits one engine search into its layers on the host:
  1. in-process Engine.search at nprobe 1 and 8, timed at its seams (the
     JAX engine's names): ai.embed, the batcher's submit (the device
     dispatch: probe, scan, epilogue and refine, waited for),
     store.fetch_documents (the SQL rows), and the residue, "engine
     other" (owner and category caches, doc-map dedup, the hits); on a
     card also the card's busy ms a search (torch.profiler's CUDA rows
     over DEVICE_ROUNDS more searches; null on the CPU): what of the
     dispatch is the device's;
  2. a cProfile of the searches, top 18 functions by cumulative time, to
     stderr;
  3. the HTTP layer on top (api/http.py's router and HTTP/1.1 server:
     JSON, the socket, the executor hop), as sequential HTTP latency minus
     in-process latency; the in-process figure is taken before and after
     the HTTP loop and the smaller one is used. The client runs in this
     interpreter, so the figure also holds its own request and response
     work.

Every shape is warmed first. The engine holds one category of N rows
packed straight into its state (uploading N documents through SQL would
take the tool's time), with real SQL documents mapped ~20 embeddings to
1. Standalone: N rows at the noop embedder's D=512 from seed 7 and the
JAX tool's k-means (k = max(8, N // 10,000), 4 passes); chip_smoke.py's
hostpath phase passes its own rows, centroids and assignments and an
embedder of their width.

The engine logs at warn: a line a search at info would be the tool's own
cost. Env: VSTPU_HOSTPROF_N (50000), VSTPU_HOSTPROF_ROUNDS (300). The device is
device.resolve(None): VSTPU_DEVICE, else the card, else NoDeviceError.
Prints one JSON line with the split in ms a query; the log on stderr.
"""
from __future__ import annotations

import cProfile
import json
import os
import pstats
import sys
import time

import numpy as np
import torch

from .. import logger, native
from ..build import build_centroids
from ..device import resolve
from ..embed.noop import NoopAI
from ..engine import Engine, EngineCache
from ..engine.engine import CategoryState
from ..index import IVFIndex
from ..quant import layout
from ..store import Store
from .http_driver import Client, serving_app

N = int(os.environ.get("VSTPU_HOSTPROF_N", 50_000))
DIM = 512  # the noop embedder's native dim
ROUNDS = int(os.environ.get("VSTPU_HOSTPROF_ROUNDS", 300))
NPROBES = (1, 8)
OWNER, CATEGORY = "o", "c"
DOCS_PER_INSERT = 500
TOP = 18
# searches under torch.profiler a probe width: its trace costs ~60 ms of
# host time a search on an H100 host (35 s for 2 x 300)
DEVICE_ROUNDS = 50


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def synthetic(n: int, dev):
    """The JAX tool's rows (seed 7, D=512) and k-means: (packed,
    centroids, assignments)."""
    data = np.random.default_rng(7).normal(size=(n, DIM)).astype(np.float32)
    packed = layout.pack_float(data)
    result = build_centroids(packed, k=max(8, n // 10_000), max_iters=4, superset_iters=2,
                             device=dev)
    return packed, result.centroids, result.assignments


def build_engine(packed, centroids, assignments, ai, dev):
    """An engine with one category holding `packed` (ids 1..N) in an
    IVFIndex on `dev`, and N // 20 (at least 64) SQL documents, embedding
    e mapped to document e % n_docs. Returns (engine, store, category)."""
    n = packed.codes.shape[0]
    ids = np.arange(1, n + 1, dtype=np.int64)
    ivf = IVFIndex.build(packed, ids, centroids, assignments=assignments, device=dev)
    store = Store(":memory:")
    eng = Engine(store, ai, cache=EngineCache(ttl=60.0), device=dev)
    owner = store.get_or_create_owner(OWNER)
    cat = store.get_or_create_category(owner.id, CATEGORY)
    # real SQL documents so fetch_documents measures true row reads;
    # embeddings map ~20:1 onto docs (a realistic sections-per-doc ratio:
    # one document for everything would make every search a deep
    # pagination escalation, not a representative request)
    n_docs = max(64, n // 20)
    doc_ids = []
    for s in range(0, n_docs, DOCS_PER_INSERT):
        doc_ids.extend(store.insert_documents(
            cat.id, [(f"d{i}", "", {"text": f"x{i}"})
                     for i in range(s, min(s + DOCS_PER_INSERT, n_docs))]))
    st = CategoryState(category_id=cat.id)
    st.ivf = ivf
    st.doc_map.update((int(e), doc_ids[int(e) % n_docs]) for e in ids)
    eng._states[cat.id] = st
    return eng, store, cat


class Seams:
    """Seconds spent in the engine's seams, by the instance attributes
    that replace them (the search path calls them through the instance)."""

    NAMES = ("embed", "dispatch", "sql_fetch")

    def __init__(self, eng, store):
        self.s = dict.fromkeys(self.NAMES, 0.0)
        eng.ai.embed = self._timed("embed", eng.ai.embed)
        eng._batcher.submit = self._timed("dispatch", eng._batcher.submit)
        store.fetch_documents = self._timed("sql_fetch", store.fetch_documents)

    def _timed(self, name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.s[name] += time.perf_counter() - t0
        return timed

    def reset(self):
        self.s = dict.fromkeys(self.NAMES, 0.0)


def searches(eng, prefix: str, rounds: int, nprobe: int) -> float:
    """`rounds` in-process searches of texts prefix0..; ms a search. Each
    must find something."""
    t0 = time.perf_counter()
    for i in range(rounds):
        if not eng.search(OWNER, CATEGORY, f"{prefix}{i}", count=10, centroids=nprobe):
            raise AssertionError(f"search {prefix}{i} at nprobe {nprobe} found nothing")
    return (time.perf_counter() - t0) / rounds * 1e3


def device_ms(eng, rounds: int, nprobe: int) -> float | None:
    """The card's busy ms a search: torch.profiler's CUDA rows summed over
    `rounds` searches (the profiler slows the host, not the device); None
    off the card."""
    if eng.device.type != "cuda":
        return None
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        searches(eng, "d", rounds, nprobe)
        torch.cuda.synchronize(eng.device)
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / rounds


def profile(eng, store, rounds: int = ROUNDS) -> dict:
    """Steps 1-3 on an engine from build_engine(); the split in ms a query."""
    seams = Seams(eng, store)
    for nprobe in NPROBES:  # every shape warmed: builds and first uses excluded
        searches(eng, "warm", 1, nprobe)
    out = {}
    for nprobe in NPROBES:
        seams.reset()
        total = searches(eng, "q", rounds, nprobe)
        split = {f"{k}_ms": v / rounds * 1e3 for k, v in seams.s.items()}
        split["engine_other_ms"] = total - sum(split.values())
        split["device_ms"] = device_ms(eng, min(rounds, DEVICE_ROUNDS), nprobe)
        out[f"nprobe{nprobe}"] = {"total_ms": total, **split}
        log(f"hostprof: in-process nprobe={nprobe} {total:.2f} ms/query ("
            + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in split.items() if v is not None)
            + ("" if split["device_ms"] is not None else ", device not measured") + ")")

    prof = cProfile.Profile()
    prof.enable()
    searches(eng, "p", rounds, NPROBES[-1])
    prof.disable()
    log(f"hostprof: top {TOP} functions by cumulative time (engine in-process, nprobe "
        f"{NPROBES[-1]}):")
    pstats.Stats(prof, stream=sys.stderr).sort_stats("cumulative").print_stats(TOP)

    body = {"owner": OWNER, "category": CATEGORY, "text": "q", "count": 10,
            "centroids": NPROBES[-1]}
    with serving_app(eng) as port:
        c = Client(port)
        c.post("/api/search", body)  # warm
        # bracket the HTTP loop with fresh in-process passes: the first
        # in-process figure is minutes old and the device keeps warming
        pre = searches(eng, "r", rounds, NPROBES[-1])
        t0 = time.perf_counter()
        for _ in range(rounds):
            if not c.post("/api/search", body)["documents"]:
                raise AssertionError("an HTTP search found nothing")
        http_ms = (time.perf_counter() - t0) / rounds * 1e3
        post = searches(eng, "r", rounds, NPROBES[-1])
        c.conn.close()
    out["http"] = {"sequential_ms": http_ms, "inprocess_pre_ms": pre,
                   "inprocess_post_ms": post, "overhead_ms": http_ms - min(pre, post)}
    log(f"hostprof: HTTP sequential {http_ms:.2f} ms/query vs in-process {pre:.2f}/{post:.2f} "
        f"(pre/post) -> HTTP layer overhead {out['http']['overhead_ms']:.2f} ms "
        f"= router + JSON + socket + executor + this process's client")
    return out


def device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main() -> int:
    dev = resolve(None)
    # a line a search at info would be the tool's own cost
    logger.configure("warn")
    t0 = time.perf_counter()
    packed, centroids, assignments = synthetic(N, dev)
    eng, store, _ = build_engine(packed, centroids, assignments, NoopAI(seed=1), dev)
    log(f"hostprof: engine ready (N={N}) in {time.perf_counter() - t0:.1f} s on {dev}")
    try:
        out = {"tool": "host_profile", "n": N, "dim": DIM, "rounds": ROUNDS,
               "device": device_name(dev), "native_codec": native.build_kind(),
               **profile(eng, store, ROUNDS)}
    finally:
        eng.close()
        store.close()
    print(json.dumps(out))
    log("hostprof: done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
