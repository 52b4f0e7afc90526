"""The served cells' clients, in a process of their own so that their
Python is not charged to the server. Standard library and NumPy only.

    python3 -m vsbench.drivers.http_client '<json plan>'

Each client holds one keep-alive HTTP/1.1 connection and sends its next
request as soon as the last one answered (a closed loop, no think time):
a search client `POST /api/search` with one query text `q<i>` (i drawn
from the seed over the pool), an upload client `POST /api/upload` with
`docs_per_upload` new documents `u<n>`. After `warm` requests a client
(set-up), the process prints `ready`, waits for `go` on stdin, runs for
`seconds`, and prints one JSON object: every request's send and answer
times (seconds after go), its status, and the answers of a sample of
searches drawn from the seed together with every upload's acknowledgement.
"""
from __future__ import annotations

import http.client
import json
import sys
import threading
import time

import numpy as np

TIMEOUT = 120
UPLOAD_SHIFT = 24  # upload n = client << UPLOAD_SHIFT | its sequence number


class Conn:
    def __init__(self, port: int):
        self.c = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)

    def post(self, path: str, obj) -> tuple[int, dict | None]:
        self.c.request("POST", path, body=json.dumps(obj).encode(),
                       headers={"Content-Type": "application/json"})
        r = self.c.getresponse()
        raw = r.read()
        return r.status, (json.loads(raw) if r.status == 200 else None)


def search_body(plan, i: int) -> dict:
    return {"owner": plan["owner"], "category": plan["category"], "text": f"q{i}",
            "count": plan["count"], "centroids": plan["nprobe"]}


def upload_body(plan, first: int) -> dict:
    docs = [{"name": f"u{n}", "document": {"text": f"u{n}"}}
            for n in range(first, first + plan["docs_per_upload"])]
    return {"owner": plan["owner"], "category": plan["category"], "documents": docs}


def run(plan, go_line) -> dict:
    """Warm-up, `ready`, then the window once go_line() returns."""
    n_search, n_up = plan["search_clients"], plan["upload_clients"]
    go, ready = threading.Event(), threading.Barrier(n_search + n_up + 1, timeout=TIMEOUT * 5)
    t_go = [0.0]
    recs = [[] for _ in range(n_search + n_up)]
    warm_acks = []  # uploads acknowledged in the warm-up: they are written too
    errors = []

    def client(c: int):
        try:
            conn = Conn(plan["port"])
            is_search = c < n_search
            if is_search:
                seq = np.random.default_rng([plan["seed"], 1, c]).integers(0, plan["pool"], 1 << 20)
            else:
                u = c - n_search
            j = 0
            for _ in range(plan["warm"]):
                if is_search:
                    conn.post("/api/search", search_body(plan, int(seq[j])))
                else:
                    first = (u << UPLOAD_SHIFT) | (j * plan["docs_per_upload"])
                    status, out = conn.post("/api/upload", upload_body(plan, first))
                    if status == 200:
                        warm_acks.append({"first": first, "ids": out["document_ids"]})
                j += 1
            ready.wait()
            go.wait()
            t_end = t_go[0] + plan["seconds"]
            while True:
                t0 = time.perf_counter()
                if t0 >= t_end:
                    break
                if is_search:
                    i = int(seq[j])
                    body, path = search_body(plan, i), "/api/search"
                else:
                    i = (u << UPLOAD_SHIFT) | (j * plan["docs_per_upload"])
                    body, path = upload_body(plan, i), "/api/upload"
                try:
                    status, out = conn.post(path, body)
                except (OSError, http.client.HTTPException) as e:
                    status, out = -1, None
                    errors.append(repr(e))
                    conn = Conn(plan["port"])
                recs[c].append((t0 - t_go[0], time.perf_counter() - t_go[0], status, i, out))
                j += 1
        except Exception as e:  # reported, and every request it did not send is missing
            errors.append(repr(e))
            ready.abort()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_search + n_up)]
    for t in threads:
        t.start()
    ready.wait()
    print("ready", flush=True)
    go_line()
    t_go[0] = time.perf_counter()
    go.set()
    for t in threads:
        t.join()
    return summarize(plan, recs, warm_acks, errors)


def summarize(plan, recs, warm_acks, errors) -> dict:
    n_search = plan["search_clients"]
    search = [r for c in recs[:n_search] for r in c]
    uploads = [r for c in recs[n_search:] for r in c]
    ok = [k for k, r in enumerate(search) if r[2] == 200]
    rng = np.random.default_rng([plan["seed"], 2])
    pick = sorted(rng.choice(len(ok), size=min(plan["sample"], len(ok)), replace=False).tolist()) if ok else []
    sample = []
    for k in pick:
        docs = search[ok[k]][4]["documents"]
        sample.append({"q": search[ok[k]][3], "ids": [d["document_id"] for d in docs],
                       "sims": [d["document_similarity"] for d in docs],
                       "names": [d["name"] for d in docs]})
    acks = warm_acks + [{"first": r[3], "ids": r[4]["document_ids"]} for r in uploads if r[2] == 200]
    return {
        "search": [[r[0], r[1], r[2]] for r in search],
        "upload": [[r[0], r[1], r[2]] for r in uploads],
        "sample": sample, "acks": acks, "errors": errors[:5], "n_errors": len(errors),
    }


def main() -> int:
    plan = json.loads(sys.argv[1])
    out = run(plan, lambda: sys.stdin.readline())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
