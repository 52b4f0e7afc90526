"""Read-through TTL cache with singleflight (reference: cache/).

Concurrent misses on the same key issue ONE loader call
(cache/middleware.go:12-56 uses golang.org/x/sync/singleflight); entries
expire after CACHE_DURATION and a background sweep runs every
CACHE_CLEANUP (cache/cache.go:38-79 — whose sweep locks the owner lock for
all three maps; here every cache owns its own lock).
"""
from __future__ import annotations

import threading
import time

from .. import constants
from ..utils.errors import fresh_exc


class _InFlight:
    __slots__ = ("event", "value", "error")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error = None


class TTLCache:
    """One keyed read-through cache."""

    def __init__(self, ttl: float | None = None):
        self.ttl = constants.CACHE_DURATION_S if ttl is None else ttl
        self._lock = threading.Lock()
        self._entries: dict = {}  # key -> (value, expires_at)
        self._inflight: dict = {}  # key -> _InFlight

    def get_or_load(self, key, loader):
        now = time.monotonic()
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and hit[1] > now:
                return hit[0]
            flight = self._inflight.get(key)
            if flight is None:
                flight = _InFlight()
                self._inflight[key] = flight
                is_leader = True
            else:
                is_leader = False
        if not is_leader:
            flight.event.wait()
            if flight.error is not None:
                # per-waiter copy (see utils.errors.fresh_exc)
                raise fresh_exc(flight.error)
            if flight.value is not None:
                return flight.value
            # The flight is keyed by key alone, whatever its loader: a
            # leader that only reads (a search's get_owner) answers None
            # for a row that this waiter's loader (an upload's
            # get_or_create_owner) would create. That miss is not this
            # caller's answer, so run its own loader once.
            return self._keep(key, loader())
        try:
            value = loader()
        except BaseException as e:
            flight.error = e
            raise
        else:
            flight.value = value
            return self._keep(key, value)
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            flight.event.set()

    def _keep(self, key, value):
        """Cache a loaded value and return it. None = not-found: do NOT
        cache it (reference parity — a miss propagates ErrRecordNotFound
        and is never stored, so an upload right after a failed search can
        create the row, cache/middleware.go:22-56)."""
        if value is not None:
            with self._lock:
                self._entries[key] = (value, time.monotonic() + self.ttl)
        return value

    def invalidate(self, key=None):
        with self._lock:
            if key is None:
                self._entries.clear()
            else:
                self._entries.pop(key, None)

    def sweep(self):
        now = time.monotonic()
        with self._lock:
            dead = [k for k, (_, exp) in self._entries.items() if exp <= now]
            for k in dead:
                del self._entries[k]

    def __len__(self):
        with self._lock:
            return len(self._entries)


class EngineCache:
    """Owner / category / centroid-list caches + background sweeper
    (reference: cache/cache.go:27-79, cache/types.go)."""

    def __init__(self, ttl: float | None = None, cleanup_s: float | None = None):
        self.owners = TTLCache(ttl)  # key: owner name
        self.categories = TTLCache(ttl)  # key: (name, owner_id)
        self.centroids = TTLCache(ttl)  # key: category_id
        self._stop = threading.Event()
        self._interval = constants.CACHE_CLEANUP_S if cleanup_s is None else cleanup_s
        self._thread: threading.Thread | None = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def _run(self):
        while not self._stop.wait(self._interval):
            for c in (self.owners, self.categories, self.centroids):
                c.sweep()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1)
            self._thread = None

    def invalidate_all(self):
        for c in (self.owners, self.categories, self.centroids):
            c.invalidate()
