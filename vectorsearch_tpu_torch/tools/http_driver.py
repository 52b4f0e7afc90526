"""Drive the port's HTTP API from a test or check: a free local port, a
wait until the server listens, a keep-alive client, a fan-out over
threads, and the entry's run() served from a thread of this process."""
from __future__ import annotations

import contextlib
import http.client
import json
import socket
import threading
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_listening(port, alive, timeout) -> None:
    """Until the port accepts a connection; `alive()` false fails."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            if not alive() or time.monotonic() > deadline:
                raise AssertionError(f"nothing listens on port {port}") from None
            time.sleep(0.1)


class Client:
    """One keep-alive HTTP/1.1 connection (the standard library's client)."""

    def __init__(self, port, timeout=300):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)

    def call(self, method, path, obj=None):
        """(status, headers, body): JSON bodies decoded, others as bytes."""
        body = None if obj is None else json.dumps(obj).encode()
        self.conn.request(method, path, body=body)
        r = self.conn.getresponse()
        raw = r.read()
        ctype = r.getheader("Content-Type", "")
        return r.status, dict(r.getheaders()), (
            json.loads(raw) if ctype.startswith("application/json") else raw)

    def post(self, path, obj):
        status, _, out = self.call("POST", path, obj)
        if status != 200:
            raise AssertionError(f"POST {path}: HTTP {status} {out}")
        return out


def fan_out(port, n_clients, jobs, timeout=300):
    """jobs (callables of a Client) over n_clients threads, each with its
    own connection; returns (results in order, wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    local = threading.local()

    def one(job):
        if not hasattr(local, "client"):
            local.client = Client(port, timeout)
        return job(local.client)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(n_clients) as ex:
        out = list(ex.map(one, jobs))
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def serving(entry, cfg, ai, port, timeout=600):
    """The port's entry, run() in a thread of this process, until the
    block ends; yields the seconds it took to listen."""
    stop, rc = threading.Event(), []
    thread = threading.Thread(target=lambda: rc.append(entry.run(cfg, ai, stop)))
    t0 = time.perf_counter()
    thread.start()
    try:
        wait_listening(port, thread.is_alive, timeout)
        yield time.perf_counter() - t0
    finally:
        stop.set()
        thread.join(timeout)
    if thread.is_alive() or rc != [0]:
        raise AssertionError(f"the server did not stop cleanly (run() returned {rc})")
