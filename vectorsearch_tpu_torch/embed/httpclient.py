"""HTTP client pooling, endpoint balancing, and zstd request compression.

Host-side plumbing kept host-side (SURVEY.md §2.8 keeps this pattern):
  * per-host pooled `requests.Session`, recycled after
    HTTP_CLIENT_MAX_REQUESTS uses (reference: ai/httpclient/httpclient.go:
    44-116, config/constants.go:18);
  * multi-endpoint pick = shuffle + least-active-connections
    (reference: ai/httpclient/provider.go:56-87);
  * optional zstd request compression + transparent zstd response
    decompression (reference: ai/httpclient/compression.go).
"""
from __future__ import annotations

import random
import threading
from contextlib import contextmanager
from urllib.parse import urljoin

import requests

from .. import constants
from .base import AIError
from ..store.db import HAVE_ZSTD, compress, decompress


class SessionManager:
    """Per-host session pool with request-count recycling."""

    def __init__(self, max_requests: int | None = None):
        self._lock = threading.Lock()
        self._sessions: dict[str, tuple[requests.Session, int]] = {}
        self._max = max_requests or constants.HTTP_CLIENT_MAX_REQUESTS

    def get(self, host: str) -> requests.Session:
        with self._lock:
            sess, used = self._sessions.get(host, (None, 0))
            if sess is None or used >= self._max:
                # do NOT close the old session here: another thread may
                # still have a request in flight on it; dropping the
                # reference lets keep-alive expiry / GC reclaim it
                sess, used = requests.Session(), 0
            self._sessions[host] = (sess, used + 1)
            return sess

    def close(self):
        with self._lock:
            for sess, _ in self._sessions.values():
                sess.close()
            self._sessions.clear()


class EndpointPool:
    """Least-active-connections endpoint picker with shuffled tie-break."""

    def __init__(self, urls: list[str]):
        if not urls:
            raise ValueError("no endpoints configured")
        self._urls = list(urls)
        self._active = {u: 0 for u in urls}
        self._lock = threading.Lock()

    @contextmanager
    def acquire(self):
        with self._lock:
            order = list(self._urls)
            random.shuffle(order)
            url = min(order, key=lambda u: self._active[u])
            self._active[url] += 1
        try:
            yield url
        finally:
            with self._lock:
                self._active[url] -= 1


class ProviderClient:
    """One provider role (embed/generate/chat): endpoints + sessions +
    compression + auth headers."""

    def __init__(self, cfg, sessions: SessionManager | None = None):
        self.cfg = cfg
        self.pool = EndpointPool(cfg.api_base)
        self.sessions = sessions or SessionManager()

    def post_json(self, path: str, payload: bytes, stream: bool = False, timeout=120):
        ctx = self.pool.acquire()
        base = ctx.__enter__()
        try:
            url = urljoin(base if base.endswith("/") else base + "/", path.lstrip("/"))
            headers = {"Content-Type": "application/json"}
            # store.db falls back to zlib when the zstd module is missing;
            # zlib frames labeled "zstd" would corrupt the exchange, so only
            # advertise/emit zstd when the real codec is present
            if HAVE_ZSTD:
                headers["Accept-Encoding"] = "zstd"
            body = payload
            if self.cfg.request_compression and HAVE_ZSTD:
                body = compress(payload)
                headers["Content-Encoding"] = "zstd"
            if self.cfg.token:
                headers["Authorization"] = f"Bearer {self.cfg.token}"
            sess = self.sessions.get(base)
            resp = sess.post(
                url, data=body, headers=headers, stream=stream, timeout=timeout
            )
        except BaseException:
            ctx.__exit__(None, None, None)
            raise
        if not stream:
            # body already buffered; release the active-connection slot now
            ctx.__exit__(None, None, None)
            return resp
        # streaming: the connection stays busy until the body is consumed —
        # keep the least-connections slot held until close()
        orig_close = resp.close
        released = []

        def close_and_release():
            if not released:
                released.append(True)
                ctx.__exit__(None, None, None)
            orig_close()

        resp.close = close_and_release
        return resp

    @staticmethod
    def read_body(resp) -> bytes:
        body = resp.content
        if resp.headers.get("Content-Encoding", "").strip().lower() == "zstd":
            # urllib3 builds with zstd support auto-decode the body before
            # we see it; only decompress when the zstd frame magic is still
            # present, so we never double-decompress
            if body[:4] == b"\x28\xb5\x2f\xfd":
                if not HAVE_ZSTD:
                    # zlib fallback can't decode zstd frames; fail loudly
                    # instead of handing zlib garbage to the JSON parser
                    raise AIError(
                        "server sent zstd-encoded body but no zstd codec is "
                        "available in this runtime"
                    )
                body = decompress(body)
        return body
