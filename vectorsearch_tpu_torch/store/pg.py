"""PostgreSQL-backed Store with read/write splitting.

Mirrors the reference's production database path: the first `postgres`
DSN is the primary, `postgres_readonly` DSNs are replicas, and reads are
routed strict-round-robin over the replicas while writes always hit the
primary (database/database.go:86-103, dbresolver.StrictRoundRobinPolicy).
Schema and semantics match store/db.py's SQLite Store exactly (same row
dataclasses, same zstd document column, same build-lock table with stale
expiry — the reference's SHARE NOWAIT analogue, server/centroids.go:33-52).

Built on the pure-Python wire client (store/pgwire.py); no driver needed.
Connection use is serialized under one lock like the SQLite Store — the
engine's hot path never touches SQL (vectors live in HBM).
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Iterator

import numpy as np

from .db import (
    BUILD_LOCK_STALE_S,
    CategoryRow,
    CentroidRow,
    DocumentRow,
    OwnerRow,
    compress,
    decompress,
)
from .pgwire import PgConnection, PgError

_PG_SCHEMA = [
    """CREATE TABLE IF NOT EXISTS owners (
    id BIGINT GENERATED BY DEFAULT AS IDENTITY PRIMARY KEY,
    name TEXT NOT NULL UNIQUE)""",
    """CREATE TABLE IF NOT EXISTS categories (
    id BIGINT GENERATED BY DEFAULT AS IDENTITY PRIMARY KEY,
    name TEXT NOT NULL,
    owner_id BIGINT NOT NULL REFERENCES owners(id) ON DELETE CASCADE,
    UNIQUE(owner_id, name))""",
    """CREATE TABLE IF NOT EXISTS centroids (
    id BIGINT GENERATED BY DEFAULT AS IDENTITY PRIMARY KEY,
    vector BYTEA NOT NULL,
    last_updated DOUBLE PRECISION NOT NULL,
    category_id BIGINT NOT NULL REFERENCES categories(id) ON DELETE CASCADE)""",
    """CREATE TABLE IF NOT EXISTS documents (
    id BIGINT GENERATED BY DEFAULT AS IDENTITY PRIMARY KEY,
    name TEXT NOT NULL DEFAULT '',
    external_id TEXT NOT NULL DEFAULT '',
    last_updated DOUBLE PRECISION NOT NULL,
    document BYTEA NOT NULL,
    category_id BIGINT NOT NULL REFERENCES categories(id) ON DELETE CASCADE)""",
    """CREATE TABLE IF NOT EXISTS embeddings (
    id BIGINT GENERATED BY DEFAULT AS IDENTITY PRIMARY KEY,
    vector BYTEA NOT NULL,
    document_id BIGINT NOT NULL REFERENCES documents(id) ON DELETE CASCADE,
    centroid_id BIGINT NOT NULL REFERENCES centroids(id) ON DELETE CASCADE)""",
    "CREATE INDEX IF NOT EXISTS idx_embedding_document ON embeddings(document_id)",
    "CREATE INDEX IF NOT EXISTS idx_embedding_centroid ON embeddings(centroid_id)",
    "CREATE INDEX IF NOT EXISTS idx_document_category ON documents(category_id)",
    "CREATE INDEX IF NOT EXISTS idx_centroid_category ON centroids(category_id)",
    """CREATE TABLE IF NOT EXISTS build_locks (
    category_id BIGINT PRIMARY KEY,
    holder TEXT NOT NULL,
    acquired_at DOUBLE PRECISION NOT NULL)""",
]


class PgStore:
    """Store API over Postgres (drop-in for store.db.Store)."""

    def __init__(
        self,
        write_dsns: list[str],
        read_dsns: list[str] | None = None,
        migrate: bool = True,
        connect=PgConnection,
    ):
        if not write_dsns:
            raise ValueError("no writable postgres DSN configured")
        self.path = write_dsns[0]  # parity with Store.path (logging)
        self._lock = threading.RLock()
        self._connect = connect
        # extra write DSNs are FAILOVER candidates: the primary is
        # write_dsns[_widx]; a broken connection rolls to the next DSN
        # (reference registers them as extra resolver sources,
        # database/database.go:86-103)
        self._write_dsns = list(write_dsns)
        self._widx = 0
        # boot resilience: the initial write connection uses the SAME
        # failover walk as runtime healing — a momentarily-down primary
        # must not kill the server when a configured failover DSN is up
        self._write = None
        self._reconnect_write()
        # reads round-robin over the read-only replicas; with none
        # configured they fall through to the primary (reference: resolver
        # only registered when >1 DSN, database/database.go:86). A replica
        # that is down AT BOOT is recorded as None and reconnected on its
        # first read (a replica dying one second after boot is already
        # handled that way — boot must not be stricter).
        self._read_dsns = list(read_dsns or [])
        self._reads = []
        for i, dsn in enumerate(self._read_dsns):
            try:
                self._reads.append(connect(dsn))
            except Exception as e:  # noqa: BLE001 - degrade, heal in _r
                from ..logger import sugar

                sugar().warning(
                    "postgres read replica #%d unreachable at boot "
                    "(%s); will retry on first read", i,
                    type(e).__name__,
                )
                self._reads.append(None)
        self._rr = 0
        if migrate:
            with self._lock:
                for ddl in _PG_SCHEMA:
                    self._write.execute(ddl)

    def _reconnect_write(self) -> None:
        """Replace a broken primary connection, failing over across the
        configured write DSNs (current first, then round-robin). Raises
        the last connect error if every DSN is down."""
        from ..logger import sugar

        last: Exception | None = None
        for step in range(len(self._write_dsns)):
            i = (self._widx + step) % len(self._write_dsns)
            try:
                conn = self._connect(self._write_dsns[i])
            except Exception as e:  # noqa: BLE001 - try the next DSN
                last = e
                continue
            if i != self._widx:
                sugar().warning(
                    "postgres primary failed over to write DSN #%d", i
                )
            self._widx = i
            self.path = self._write_dsns[i]
            self._write = conn
            return
        raise ConnectionError(
            f"all {len(self._write_dsns)} postgres write DSNs unreachable"
        ) from last

    def close(self):
        with self._lock:
            self._write.close()
            for c in self._reads:
                if c is not None:
                    c.close()

    # ---- routing ----

    def _r(self, sql: str, *params):
        """DISPLAY read: strict round-robin over replicas (owner/category
        lookups, document fetches — where replica lag only delays
        visibility). Index-consistency reads (count/max_id divergence
        checks, the boot/rebuild embedding stream, delete targeting,
        centroid lists) go through _w instead: the engine SWAPS its HBM
        index based on them, so serving them from a lagging replica would
        rebuild from stale data and drop freshly-indexed rows.

        Reads are safe to retry, so a broken connection reconnects and
        retries once (falling back to the primary if the replica stays
        down)."""
        with self._lock:
            if not self._reads:
                try:
                    return self._write.execute(sql, params)
                except ConnectionError:
                    self._reconnect_write()
                    return self._write.execute(sql, params)
            i = self._rr % len(self._reads)
            self._rr += 1
            try:
                if self._reads[i] is None:  # down since boot: heal below
                    raise ConnectionError("replica not connected")
                return self._reads[i].execute(sql, params)
            except ConnectionError:
                try:
                    self._reads[i] = self._connect(self._read_dsns[i])
                    return self._reads[i].execute(sql, params)
                except Exception:  # noqa: BLE001 - auth/pg_hba failures
                    # must ALSO fall back to the primary, not just socket
                    # errors (a replica with a rotated password would
                    # otherwise fail 1/N of all reads forever)
                    # replica down: serve this read from the primary
                    try:
                        return self._write.execute(sql, params)
                    except ConnectionError:
                        self._reconnect_write()
                        return self._write.execute(sql, params)

    def _w(self, sql: str, *params):
        """Write (or read-your-writes) query: always the primary.

        On a mid-statement connection failure the statement may or may
        not have applied server-side, so a write is NEVER silently
        retried — the connection is healed (with DSN failover) for the
        next call and the error surfaces to the caller."""
        with self._lock:
            try:
                return self._write.execute(sql, params)
            except ConnectionError:
                with contextlib.suppress(ConnectionError):
                    self._reconnect_write()
                raise

    @contextlib.contextmanager
    def _txn(self):
        """Multi-statement transaction on the primary."""
        with self._lock:
            try:
                self._write.execute("BEGIN")
            except ConnectionError:
                # nothing applied yet: safe to heal and retry the BEGIN
                self._reconnect_write()
                self._write.execute("BEGIN")
            try:
                yield self._write
            except BaseException:
                # a dead connection already aborted the txn server-side;
                # otherwise roll back explicitly. Either way surface the
                # ORIGINAL error, with the connection healed for the
                # next caller.
                with contextlib.suppress(ConnectionError, PgError):
                    self._write.execute("ROLLBACK")
                if self._write.broken:
                    with contextlib.suppress(ConnectionError):
                        self._reconnect_write()
                raise
            try:
                self._write.execute("COMMIT")
            except ConnectionError:
                with contextlib.suppress(ConnectionError):
                    self._reconnect_write()
                raise

    # ---- owners ----

    def get_owner(self, name: str) -> OwnerRow | None:
        rows = self._r("SELECT id, name FROM owners WHERE name=?", name).rows
        return OwnerRow(*rows[0]) if rows else None

    def get_or_create_owner(self, name: str) -> OwnerRow:
        self._w(
            "INSERT INTO owners(name) VALUES (?) ON CONFLICT (name) DO NOTHING",
            name,
        )
        rows = self._w("SELECT id, name FROM owners WHERE name=?", name).rows
        return OwnerRow(*rows[0])

    def delete_owner(self, name: str) -> None:
        self._w("DELETE FROM owners WHERE name=?", name)

    # ---- categories ----

    def get_category(self, owner_id: int, name: str) -> CategoryRow | None:
        rows = self._r(
            "SELECT id, name, owner_id FROM categories "
            "WHERE owner_id=? AND name=?",
            owner_id, name,
        ).rows
        return CategoryRow(*rows[0]) if rows else None

    def get_or_create_category(self, owner_id: int, name: str) -> CategoryRow:
        self._w(
            "INSERT INTO categories(name, owner_id) VALUES (?,?) "
            "ON CONFLICT (owner_id, name) DO NOTHING",
            name, owner_id,
        )
        rows = self._w(
            "SELECT id, name, owner_id FROM categories "
            "WHERE owner_id=? AND name=?",
            owner_id, name,
        ).rows
        return CategoryRow(*rows[0])

    def category_names(self, owner_id: int) -> list[str]:
        return [
            r[0]
            for r in self._r(
                "SELECT name FROM categories WHERE owner_id=? ORDER BY id",
                owner_id,
            ).rows
        ]

    def all_categories(self) -> list[CategoryRow]:
        return [
            CategoryRow(*r)
            for r in self._r(
                "SELECT id, name, owner_id FROM categories ORDER BY id"
            ).rows
        ]

    def delete_category(self, owner_id: int, name: str) -> None:
        self._w(
            "DELETE FROM categories WHERE owner_id=? AND name=?", owner_id, name
        )

    # ---- centroids ----

    def centroids(self, category_id: int) -> list[CentroidRow]:
        return [
            CentroidRow(r[0], bytes(r[1]), r[2])
            for r in self._w(
                "SELECT id, vector, category_id FROM centroids "
                "WHERE category_id=? ORDER BY id",
                category_id,
            ).rows
        ]

    def create_centroid(self, category_id: int, vector: bytes) -> int:
        rows = self._w(
            "INSERT INTO centroids(vector, last_updated, category_id) "
            "VALUES (?,?,?) RETURNING id",
            vector, time.time(), category_id,
        ).rows
        return rows[0][0]

    def replace_centroids(
        self, category_id: int, vectors: list[bytes], reassign: dict[int, int]
    ) -> list[int]:
        """See store.db.Store.replace_centroids (same transaction shape)."""
        now = time.time()
        with self._txn() as conn:
            new_ids = []
            for v in vectors:
                r = conn.execute(
                    "INSERT INTO centroids(vector, last_updated, category_id) "
                    "VALUES (?,?,?) RETURNING id",
                    (v, now, category_id),
                )
                new_ids.append(r.rows[0][0])
            # batched VALUES-join reassign: one statement per ~5k rows
            # instead of one protocol round trip per embedding — at the
            # 10M scale the per-row loop would hold the engine's
            # state.lock for 10M sequential round trips
            items = list(reassign.items())
            for s0 in range(0, len(items), 5000):
                chunk = items[s0 : s0 + 5000]
                values = ",".join(
                    f"({int(eid)},{int(new_ids[c])})" for eid, c in chunk
                )
                conn.execute(
                    "UPDATE embeddings SET centroid_id = v.cid::bigint "
                    f"FROM (VALUES {values}) AS v(id, cid) "
                    "WHERE embeddings.id = v.id"
                )
            keep = ",".join(str(int(i)) for i in new_ids) or "0"
            conn.execute(
                f"DELETE FROM centroids WHERE category_id=? AND id NOT IN ({keep}) "
                "AND NOT EXISTS (SELECT 1 FROM embeddings "
                "WHERE embeddings.centroid_id = centroids.id)",
                (category_id,),
            )
        return new_ids

    # ---- documents ----

    def insert_documents(
        self, category_id: int, docs: list[tuple[str, str, Any]]
    ) -> list[int]:
        now = time.time()
        with self._txn() as conn:
            ids = []
            for name, ext, value in docs:
                blob = compress(json.dumps(value).encode("utf-8"))
                r = conn.execute(
                    "INSERT INTO documents"
                    "(name, external_id, last_updated, document, category_id) "
                    "VALUES (?,?,?,?,?) RETURNING id",
                    (name, ext, now, blob, category_id),
                )
                ids.append(r.rows[0][0])
        return ids

    def fetch_documents(self, ids: list[int]) -> list[DocumentRow]:
        if not ids:
            return []
        q = ",".join(str(int(i)) for i in ids)
        rows = self._r(
            f"SELECT id, name, external_id, document, category_id "
            f"FROM documents WHERE id IN ({q})"
        ).rows
        return [
            DocumentRow(
                r[0], r[1], r[2], json.loads(decompress(bytes(r[3]))), r[4]
            )
            for r in rows
        ]

    def delete_document(self, category_id: int, document_id: int) -> None:
        self._w(
            "DELETE FROM documents WHERE category_id=? AND id=?",
            category_id, document_id,
        )

    # ---- embeddings ----

    def insert_documents_with_embeddings(
        self,
        category_id: int,
        docs: list[tuple[str, str, Any]],
        embeddings_per_doc: list[list[tuple[bytes, int]]],
    ) -> tuple[list[int], list[int]]:
        now = time.time()
        with self._txn() as conn:
            doc_ids: list[int] = []
            emb_ids: list[int] = []
            for (name, ext, value), embs in zip(docs, embeddings_per_doc):
                blob = compress(json.dumps(value).encode("utf-8"))
                r = conn.execute(
                    "INSERT INTO documents"
                    "(name, external_id, last_updated, document, category_id) "
                    "VALUES (?,?,?,?,?) RETURNING id",
                    (name, ext, now, blob, category_id),
                )
                doc_id = r.rows[0][0]
                doc_ids.append(doc_id)
                for vector, cent_id in embs:
                    r = conn.execute(
                        "INSERT INTO embeddings(vector, document_id, centroid_id) "
                        "VALUES (?,?,?) RETURNING id",
                        (vector, doc_id, cent_id),
                    )
                    emb_ids.append(r.rows[0][0])
        return doc_ids, emb_ids

    def insert_embeddings(
        self, rows: list[tuple[bytes, int, int]]
    ) -> list[int]:
        with self._txn() as conn:
            ids = []
            for vector, doc_id, cent_id in rows:
                r = conn.execute(
                    "INSERT INTO embeddings(vector, document_id, centroid_id) "
                    "VALUES (?,?,?) RETURNING id",
                    (vector, doc_id, cent_id),
                )
                ids.append(r.rows[0][0])
        return ids

    def embeddings_page(
        self, category_id: int, after_id: int, batch: int
    ) -> list[tuple[int, bytes, int, int]]:
        rows = self._w(
            "SELECT e.id, e.vector, e.document_id, e.centroid_id "
            "FROM embeddings e "
            "JOIN documents d ON d.id = e.document_id "
            "WHERE d.category_id=? AND e.id>? ORDER BY e.id LIMIT ?",
            category_id, after_id, batch,
        ).rows
        return [(r[0], bytes(r[1]), r[2], r[3]) for r in rows]

    def iter_embeddings(
        self, category_id: int, batch: int = 1000
    ) -> Iterator[list[tuple[int, bytes, int, int]]]:
        last = 0
        while True:
            rows = self.embeddings_page(category_id, last, batch)
            if not rows:
                return
            last = rows[-1][0]
            yield rows

    def embeddings_for_documents(self, doc_ids: list[int]) -> list[int]:
        if not doc_ids:
            return []
        q = ",".join(str(int(i)) for i in doc_ids)
        return [
            r[0]
            for r in self._w(
                f"SELECT id FROM embeddings WHERE document_id IN ({q})"
            ).rows
        ]

    def count_embeddings(self, category_id: int) -> int:
        rows = self._w(
            "SELECT COUNT(*) FROM embeddings e JOIN documents d "
            "ON d.id = e.document_id WHERE d.category_id=?",
            category_id,
        ).rows
        return rows[0][0]

    def max_embedding_id(self, category_id: int) -> int:
        rows = self._w(
            "SELECT MAX(e.id) FROM embeddings e JOIN documents d "
            "ON d.id = e.document_id WHERE d.category_id=?",
            category_id,
        ).rows
        return rows[0][0] or 0

    def document_ids_for_category(self, category_id: int) -> list[int]:
        return [
            r[0]
            for r in self._w(
                "SELECT id FROM documents WHERE category_id=?", category_id
            ).rows
        ]

    def embedding_doc_map(self, category_id: int) -> dict[int, int]:
        rows = self._w(
            "SELECT e.id, e.document_id FROM embeddings e "
            "JOIN documents d ON d.id = e.document_id WHERE d.category_id=?",
            category_id,
        ).rows
        return dict(rows)

    def embedding_doc_pairs(
        self, category_id: int
    ) -> tuple[np.ndarray, np.ndarray]:
        rows = self._w(
            "SELECT e.id, e.document_id FROM embeddings e "
            "JOIN documents d ON d.id = e.document_id "
            "WHERE d.category_id=? ORDER BY e.id",
            category_id,
        ).rows
        if not rows:
            z = np.zeros((0,), np.int64)
            return z, z
        arr = np.array(rows, np.int64)
        return arr[:, 0].copy(), arr[:, 1].copy()

    # ---- build coordination ----

    def try_acquire_build_lock(self, category_id: int, holder: str) -> bool:
        """Same contract as the SQLite Store: one transaction, stale locks
        (crashed holders) expire after BUILD_LOCK_STALE_S (the reference's
        SHARE NOWAIT skip-if-contended, server/centroids.go:33-52)."""
        now = time.time()
        with self._txn() as conn:
            conn.execute(
                "DELETE FROM build_locks WHERE category_id=? AND acquired_at<?",
                (category_id, now - BUILD_LOCK_STALE_S),
            )
            r = conn.execute(
                "INSERT INTO build_locks(category_id, holder, acquired_at) "
                "VALUES (?,?,?) ON CONFLICT (category_id) DO NOTHING "
                "RETURNING category_id",
                (category_id, holder, now),
            )
            return bool(r.rows)

    def release_build_lock(self, category_id: int, holder: str) -> None:
        self._w(
            "DELETE FROM build_locks WHERE category_id=? AND holder=?",
            category_id, holder,
        )
