"""The batched served cell's clients, in a process of their own so that
their Python is not charged to the server. Standard library and NumPy only.

    python3 -m vsbench.drivers.http_batch_client '<json plan>'

Each client holds one keep-alive HTTP/1.1 connection (http_client.Conn)
and sends its next request as soon as the last one answered (a closed
loop, no think time): `POST /api/search` with `texts`, `batch` texts
`q<i>`, each i drawn with replacement from the pool by the seed. After
`warm` requests a client (set-up), the process prints `ready`, waits for
`go` on stdin, runs for `seconds`, and prints one JSON object: every
request's send and answer times (seconds after go), its status and the
pages it answered, the process's CPU seconds over the window, and the
answers of `sample` texts drawn by the seed from the window's answers.
"""
from __future__ import annotations

import http.client
import json
import os
import sys
import threading
import time

import numpy as np

from vsbench.drivers.http_client import TIMEOUT, Conn


def search_body(plan, idx) -> dict:
    return {"owner": plan["owner"], "category": plan["category"],
            "texts": [f"q{i}" for i in idx], "count": plan["count"],
            "centroids": plan["nprobe"]}


def compact(i: int, page: dict) -> dict:
    docs = page["documents"]
    return {"q": i, "ids": [d["document_id"] for d in docs],
            "sims": [d["document_similarity"] for d in docs],
            "names": [d["name"] for d in docs]}


class Reservoir:
    """A uniform sample of `size` of the texts a client was answered
    (Algorithm R, its draws from the seed), and how many it saw."""

    def __init__(self, size: int, rng):
        self.size, self.rng, self.seen, self.items = size, rng, 0, []

    def add(self, idx, pages) -> None:
        m = len(pages)
        c = self.seen + np.arange(1, m + 1)  # each text's 1-based count
        slot = np.where(c <= self.size, c - 1, np.floor(self.rng.random(m) * c).astype(np.int64))
        for t in np.nonzero(slot < self.size)[0]:
            item = compact(int(idx[t]), pages[t])
            if slot[t] < len(self.items):
                self.items[slot[t]] = item
            else:
                self.items.append(item)
        self.seen += m


def run(plan, go_line) -> dict:
    """Warm-up, `ready`, then the window once go_line() returns."""
    n = plan["search_clients"]
    go, ready = threading.Event(), threading.Barrier(n + 1, timeout=TIMEOUT * 5)
    t_go = [0.0]
    recs = [[] for _ in range(n)]
    res = [Reservoir(plan["sample"], np.random.default_rng([plan["seed"], 3, c])) for c in range(n)]
    errors = []

    def client(c: int):
        try:
            conn = Conn(plan["port"])
            rng = np.random.default_rng([plan["seed"], 1, c])
            for _ in range(plan["warm"]):
                conn.post("/api/search", search_body(plan, rng.integers(0, plan["pool"], plan["batch"])))
            ready.wait()
            go.wait()
            t_end = t_go[0] + plan["seconds"]
            while True:
                t0 = time.perf_counter()
                if t0 >= t_end:
                    break
                idx = rng.integers(0, plan["pool"], plan["batch"])
                try:
                    status, out = conn.post("/api/search", search_body(plan, idx))
                except (OSError, http.client.HTTPException) as e:
                    status, out = -1, None
                    errors.append(repr(e))
                    conn = Conn(plan["port"])
                t1 = time.perf_counter()
                pages = out["results"] if status == 200 else []
                if len(pages) == len(idx):  # else the driver counts it failed
                    res[c].add(idx, pages)
                recs[c].append((t0 - t_go[0], t1 - t_go[0], status, len(pages)))
        except Exception as e:  # reported, and every request it did not send is missing
            errors.append(repr(e))
            ready.abort()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n)]
    for t in threads:
        t.start()
    ready.wait()
    print("ready", flush=True)
    go_line()
    cpu0 = os.times()
    t_go[0] = time.perf_counter()
    go.set()
    for t in threads:
        t.join()
    cpu1 = os.times()
    return {"search": [list(r) for c in recs for r in c], "sample": merge(plan, res),
            "client_cpu_s": (cpu1.user - cpu0.user) + (cpu1.system - cpu0.system),
            "errors": errors[:5], "n_errors": len(errors)}


def merge(plan, res) -> list:
    """`sample` texts drawn uniformly from every client's answered texts:
    how many from each client by the seed (hypergeometric over what each
    saw), then that many of its reservoir."""
    seen = [r.seen for r in res]
    pick = min(plan["sample"], sum(seen))
    if not pick:
        return []
    rng = np.random.default_rng([plan["seed"], 2])
    take = rng.multivariate_hypergeometric(seen, pick)
    return [r.items[j] for r, t in zip(res, take)
            for j in sorted(rng.choice(len(r.items), size=int(t), replace=False).tolist())]


def main() -> int:
    plan = json.loads(sys.argv[1])
    out = run(plan, lambda: sys.stdin.readline())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
