"""SQLite persistence layer.

Replaces the reference's GORM stack (database/database.go, model.go,
type.go, compression.go) with stdlib sqlite3:

  owners 1-N categories 1-N {centroids, documents};
  documents 1-N embeddings N-1 centroids
  (schema mirror of database/model.go:9-67, cascade deletes included)

  * documents.document stores zstd-compressed JSON, transparently
    (de)compressed on read/write (database/type.go:20-45,
    database/compression.go:8-34 — same SpeedFastest-style level).
  * embeddings.vector stores the 8-byte-header wire format, exactly the
    bytes the quant codec produces (database/model.go:11).
  * WAL + a process-wide write lock; multi-reader is native to SQLite.
    A file-backed store serves its read-only queries from a connection
    per thread, so that a search never waits on a long write transaction
    (a centroid rebuild): under WAL a reader sees the last committed
    state. Writes keep the one connection and its lock. ":memory:" cannot
    share data across connections and keeps the one connection for all.
  * zstd contexts are not thread-safe: each thread compresses and
    decompresses with its own (the same bytes as one shared context).

The DB is the durable source of truth (SURVEY.md §5: "the database is the
checkpoint"); HBM indexes are rebuilt from it at boot or restored from the
array snapshots in store/snapshots.py. Postgres (with read-replica routing,
database/database.go:86-103) is represented by the same interface but gated
on a driver being present; the TPU-native scale-out path is sharded device
replicas (parallel/sharded.py), not SQL replicas.
"""
from __future__ import annotations

import contextlib
import json
import os
import sqlite3
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np

try:
    import zstandard as _zstd

    HAVE_ZSTD = True
    _ZSTD = threading.local()  # this thread's (compressor, decompressor)

    def _contexts():
        ctx = getattr(_ZSTD, "ctx", None)
        if ctx is None:
            ctx = _ZSTD.ctx = (_zstd.ZstdCompressor(level=1), _zstd.ZstdDecompressor())
        return ctx

    def compress(raw: bytes) -> bytes:
        return _contexts()[0].compress(raw)

    def decompress(blob: bytes) -> bytes:
        return _contexts()[1].decompress(blob)

except ImportError:  # pragma: no cover - zstd is present in the image
    import zlib

    # NOT wire-compatible with zstd: callers that put "zstd" on the wire
    # (embed/httpclient.py) must check HAVE_ZSTD before labeling bodies
    HAVE_ZSTD = False

    def compress(raw: bytes) -> bytes:
        return zlib.compress(raw, 1)

    def decompress(blob: bytes) -> bytes:
        return zlib.decompress(blob)


_SCHEMA = """
PRAGMA journal_mode=WAL;
PRAGMA foreign_keys=ON;
CREATE TABLE IF NOT EXISTS owners (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL UNIQUE
);
CREATE TABLE IF NOT EXISTS categories (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL,
    owner_id INTEGER NOT NULL REFERENCES owners(id) ON DELETE CASCADE,
    UNIQUE(name, owner_id)
);
CREATE TABLE IF NOT EXISTS centroids (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    vector BLOB NOT NULL,
    last_updated REAL NOT NULL,
    category_id INTEGER NOT NULL REFERENCES categories(id) ON DELETE CASCADE
);
CREATE INDEX IF NOT EXISTS idx_centroid_category ON centroids(category_id);
CREATE TABLE IF NOT EXISTS documents (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL DEFAULT '',
    external_id TEXT NOT NULL DEFAULT '',
    last_updated REAL NOT NULL,
    document BLOB NOT NULL,
    category_id INTEGER NOT NULL REFERENCES categories(id) ON DELETE CASCADE
);
CREATE INDEX IF NOT EXISTS idx_document_updated ON documents(last_updated);
CREATE INDEX IF NOT EXISTS idx_document_category ON documents(category_id);
CREATE TABLE IF NOT EXISTS embeddings (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    vector BLOB NOT NULL,
    document_id INTEGER NOT NULL REFERENCES documents(id) ON DELETE CASCADE,
    centroid_id INTEGER NOT NULL REFERENCES centroids(id) ON DELETE CASCADE
);
CREATE INDEX IF NOT EXISTS idx_embedding_document ON embeddings(document_id);
CREATE INDEX IF NOT EXISTS idx_embedding_centroid ON embeddings(centroid_id);
CREATE TABLE IF NOT EXISTS build_locks (
    category_id INTEGER PRIMARY KEY,
    holder TEXT NOT NULL,
    acquired_at REAL NOT NULL
);
"""

# A build lock is considered abandoned (crashed holder) after this long.
BUILD_LOCK_STALE_S = 3600.0


@dataclass(frozen=True)
class OwnerRow:
    id: int
    name: str


@dataclass(frozen=True)
class CategoryRow:
    id: int
    name: str
    owner_id: int


@dataclass(frozen=True)
class CentroidRow:
    id: int
    vector: bytes
    category_id: int


@dataclass(frozen=True)
class DocumentRow:
    id: int
    name: str
    external_id: str
    document: Any  # decoded JSON
    category_id: int


# the write connection's page cache (KiB) while a rebuild rewrites its
# category's centroid_id column: room for the column's index at 10M rows
REWRITE_CACHE_KIB = 262_144


class Store:
    """Thread-safe SQLite store. One writer at a time (lock). Read-only
    queries of a file-backed store run on a connection of the calling
    thread's own, outside the lock (WAL: the last committed state); those
    of ":memory:" share the write connection under the lock."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._shared = path in (":memory:", "")
        if not self._shared:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA foreign_keys=ON")
        self._lock = threading.RLock()
        self._local = threading.local()
        self._readers: list[sqlite3.Connection] = []
        self._readers_lock = threading.Lock()  # never waits on a write
        with self._lock, self._conn:
            self._conn.executescript(_SCHEMA)

    @contextlib.contextmanager
    def _read(self) -> Iterator[sqlite3.Connection]:
        """The connection for a read-only query of the calling thread."""
        if self._shared:
            with self._lock:
                yield self._conn
            return
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, check_same_thread=False)
            with self._readers_lock:
                self._readers.append(conn)
            self._local.conn = conn
        yield conn

    def close(self):
        with self._lock, self._readers_lock:
            for conn in self._readers:
                conn.close()
            self._readers.clear()
            self._conn.close()

    # ---- owners ----

    def get_owner(self, name: str) -> OwnerRow | None:
        with self._read() as conn:
            row = conn.execute(
                "SELECT id, name FROM owners WHERE name=?", (name,)
            ).fetchone()
        return OwnerRow(*row) if row else None

    def get_or_create_owner(self, name: str) -> OwnerRow:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR IGNORE INTO owners(name) VALUES (?)", (name,)
            )
        return self.get_owner(name)

    def delete_owner(self, name: str) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM owners WHERE name=?", (name,))

    # ---- categories ----

    def get_category(self, owner_id: int, name: str) -> CategoryRow | None:
        with self._read() as conn:
            row = conn.execute(
                "SELECT id, name, owner_id FROM categories WHERE owner_id=? AND name=?",
                (owner_id, name),
            ).fetchone()
        return CategoryRow(*row) if row else None

    def get_or_create_category(self, owner_id: int, name: str) -> CategoryRow:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR IGNORE INTO categories(name, owner_id) VALUES (?,?)",
                (name, owner_id),
            )
        return self.get_category(owner_id, name)

    def category_names(self, owner_id: int) -> list[str]:
        with self._read() as conn:
            rows = conn.execute(
                "SELECT name FROM categories WHERE owner_id=? ORDER BY id",
                (owner_id,),
            ).fetchall()
        return [r[0] for r in rows]

    def all_categories(self) -> list[CategoryRow]:
        with self._read() as conn:
            rows = conn.execute(
                "SELECT id, name, owner_id FROM categories ORDER BY id"
            ).fetchall()
        return [CategoryRow(*r) for r in rows]

    def delete_category(self, owner_id: int, name: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "DELETE FROM categories WHERE owner_id=? AND name=?",
                (owner_id, name),
            )

    # ---- centroids ----

    def centroids(self, category_id: int) -> list[CentroidRow]:
        with self._read() as conn:
            rows = conn.execute(
                "SELECT id, vector, category_id FROM centroids "
                "WHERE category_id=? ORDER BY id",
                (category_id,),
            ).fetchall()
        return [CentroidRow(r[0], bytes(r[1]), r[2]) for r in rows]

    def create_centroid(self, category_id: int, vector: bytes) -> int:
        with self._lock, self._conn:
            cur = self._conn.execute(
                "INSERT INTO centroids(vector, last_updated, category_id) "
                "VALUES (?,?,?)",
                (vector, time.time(), category_id),
            )
            return cur.lastrowid

    def replace_centroids(
        self, category_id: int, vectors: list[bytes], reassign: dict[int, int]
    ) -> list[int]:
        """Atomically swap a category's centroid set and remap embeddings.

        `reassign` maps embedding id -> index into `vectors`. Mirrors the
        reference's upsert + batched centroid_id update pass
        (dnc/dnc.go:149-263) as ONE transaction.

        The remap is one UPDATE over a JSON array of (embedding id, centroid
        id) pairs in id order, with a page cache of REWRITE_CACHE_KIB.
        Row by row (executemany), the sqlite3 module releases and retakes
        the GIL around every row, and while the server's threads run Python
        each retake waits its turn: on an H100 host a startup rebuild of 10M
        rows under search load had not ended after 17 minutes that way, and
        ended in 706 s with this statement. In a rebuild's cluster order
        (random ids) every update would spill table and index pages to the
        WAL again; in id order each table page is written once.
        """
        with self._lock:
            (cache,) = self._conn.execute("PRAGMA cache_size").fetchone()
            self._conn.execute(f"PRAGMA cache_size=-{REWRITE_CACHE_KIB}")
            try:
                with self._conn:
                    cur = self._conn.cursor()
                    new_ids = []
                    for v in vectors:
                        cur.execute(
                            "INSERT INTO centroids(vector, last_updated, category_id) "
                            "VALUES (?,?,?)",
                            (v, time.time(), category_id),
                        )
                        new_ids.append(cur.lastrowid)
                    pairs = json.dumps(
                        [(eid, new_ids[reassign[eid]]) for eid in sorted(reassign)]
                    )
                    cur.execute(
                        "UPDATE embeddings SET centroid_id = m.cid FROM ("
                        "SELECT json_extract(value, '$[0]') AS id, "
                        "json_extract(value, '$[1]') AS cid FROM json_each(?)"
                        ") AS m WHERE embeddings.id = m.id",
                        (pairs,),
                    )
                    # Delete only old centroids with NO remaining members: an
                    # embedding inserted by ANOTHER instance during this build
                    # still references its old centroid and must not be
                    # cascade-deleted; its orphaned centroid survives until a
                    # later rebuild/sync covers it (the reference likewise
                    # never force-deletes in-use centroids).
                    cur.execute(
                        "DELETE FROM centroids WHERE category_id=? AND id NOT IN (%s) "
                        "AND NOT EXISTS (SELECT 1 FROM embeddings "
                        "WHERE embeddings.centroid_id = centroids.id)"
                        % ",".join("?" * len(new_ids)),
                        (category_id, *new_ids),
                    )
            finally:
                self._conn.execute(f"PRAGMA cache_size={cache}")
        return new_ids

    # ---- documents ----

    def insert_documents(
        self,
        category_id: int,
        docs: list[tuple[str, str, Any]],  # (name, external_id, json_value)
    ) -> list[int]:
        now = time.time()
        with self._lock, self._conn:
            cur = self._conn.cursor()
            ids = []
            for name, ext, value in docs:
                blob = compress(json.dumps(value).encode("utf-8"))
                cur.execute(
                    "INSERT INTO documents"
                    "(name, external_id, last_updated, document, category_id) "
                    "VALUES (?,?,?,?,?)",
                    (name, ext, now, blob, category_id),
                )
                ids.append(cur.lastrowid)
        return ids

    def fetch_documents(self, ids: list[int]) -> list[DocumentRow]:
        if not ids:
            return []
        q = ",".join("?" * len(ids))
        with self._read() as conn:
            rows = conn.execute(
                f"SELECT id, name, external_id, document, category_id "
                f"FROM documents WHERE id IN ({q})",
                tuple(ids),
            ).fetchall()
        return [
            DocumentRow(
                r[0], r[1], r[2], json.loads(decompress(bytes(r[3]))), r[4]
            )
            for r in rows
        ]

    def delete_document(self, category_id: int, document_id: int) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "DELETE FROM documents WHERE category_id=? AND id=?",
                (category_id, document_id),
            )

    # ---- embeddings ----

    def insert_documents_with_embeddings(
        self,
        category_id: int,
        docs: list[tuple[str, str, Any]],
        embeddings_per_doc: list[list[tuple[bytes, int]]],
    ) -> tuple[list[int], list[int]]:
        """Insert documents AND their embeddings in ONE transaction so a
        failure cannot leave orphaned (unsearchable) document rows.
        embeddings_per_doc[i] = [(vector_wire, centroid_id), ...] for doc i.
        Returns (document_ids, embedding_ids in document order)."""
        now = time.time()
        with self._lock, self._conn:
            cur = self._conn.cursor()
            doc_ids: list[int] = []
            emb_ids: list[int] = []
            for (name, ext, value), embs in zip(docs, embeddings_per_doc):
                blob = compress(json.dumps(value).encode("utf-8"))
                cur.execute(
                    "INSERT INTO documents"
                    "(name, external_id, last_updated, document, category_id) "
                    "VALUES (?,?,?,?,?)",
                    (name, ext, now, blob, category_id),
                )
                doc_id = cur.lastrowid
                doc_ids.append(doc_id)
                for vector, cent_id in embs:
                    cur.execute(
                        "INSERT INTO embeddings(vector, document_id, centroid_id) "
                        "VALUES (?,?,?)",
                        (vector, doc_id, cent_id),
                    )
                    emb_ids.append(cur.lastrowid)
        return doc_ids, emb_ids

    def insert_embeddings(
        self, rows: list[tuple[bytes, int, int]]  # (vector, document_id, centroid_id)
    ) -> list[int]:
        with self._lock, self._conn:
            cur = self._conn.cursor()
            ids = []
            for vector, doc_id, cent_id in rows:
                cur.execute(
                    "INSERT INTO embeddings(vector, document_id, centroid_id) "
                    "VALUES (?,?,?)",
                    (vector, doc_id, cent_id),
                )
                ids.append(cur.lastrowid)
        return ids

    def embeddings_page(
        self, category_id: int, after_id: int, batch: int
    ) -> list[tuple[int, bytes, int, int]]:
        """One id-ordered page of (id, vector, document_id, centroid_id)
        after `after_id` (also the paging unit RemoteStore streams over).
        centroid_id lets boot rebuild the IVF layout without a device
        re-assignment pass — SQL already holds the authoritative
        assignment (inserts persist it, rebuilds rewrite it)."""
        with self._read() as conn:
            # CROSS JOIN pins the join order: drive from the embeddings
            # PRIMARY KEY (rowid>?, already in ORDER BY order) and probe
            # documents per row. SQLite's default plan drives from the
            # documents category index and sorts each page through a TEMP
            # B-TREE — measured 4.15s vs 0.11s per 50k page on a 10M-row
            # store (the r3 cold-boot bottleneck).
            rows = conn.execute(
                "SELECT e.id, e.vector, e.document_id, e.centroid_id "
                "FROM embeddings e "
                "CROSS JOIN documents d ON d.id = e.document_id "
                "WHERE d.category_id=? AND e.id>? ORDER BY e.id LIMIT ?",
                (category_id, after_id, batch),
            ).fetchall()
        return [(r[0], bytes(r[1]), r[2], r[3]) for r in rows]

    def iter_embeddings(
        self, category_id: int, batch: int = 1000
    ) -> Iterator[list[tuple[int, bytes, int, int]]]:
        """Stream (id, vector, document_id, centroid_id) for a category in
        id-ordered batches (reference: dnc/dnc.go:91-114 streams the same
        way)."""
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
        q = ",".join("?" * len(doc_ids))
        with self._read() as conn:
            rows = conn.execute(
                f"SELECT id FROM embeddings WHERE document_id IN ({q})",
                tuple(doc_ids),
            ).fetchall()
        return [r[0] for r in rows]

    def count_embeddings(self, category_id: int) -> int:
        with self._read() as conn:
            (n,) = conn.execute(
                "SELECT COUNT(*) FROM embeddings e JOIN documents d "
                "ON d.id = e.document_id WHERE d.category_id=?",
                (category_id,),
            ).fetchone()
        return n

    def max_embedding_id(self, category_id: int) -> int:
        """Largest embedding id in a category (0 if empty). AUTOINCREMENT
        ids are monotonic, so (count, max_id) is a collision-proof cheap
        divergence signal: a remote delete+upload pair leaves COUNT(*)
        unchanged but always raises MAX(id)."""
        with self._read() as conn:
            (m,) = conn.execute(
                "SELECT MAX(e.id) FROM embeddings e JOIN documents d "
                "ON d.id = e.document_id WHERE d.category_id=?",
                (category_id,),
            ).fetchone()
        return m or 0

    def document_ids_for_category(self, category_id: int) -> list[int]:
        with self._read() as conn:
            rows = conn.execute(
                "SELECT id FROM documents WHERE category_id=?", (category_id,)
            ).fetchall()
        return [r[0] for r in rows]

    # ---- build coordination ----

    def try_acquire_build_lock(self, category_id: int, holder: str) -> bool:
        """Non-blocking per-category build lock shared by every process on
        this store — the reference coordinates multi-instance centroid
        rebuilds with a Postgres SHARE NOWAIT row lock and skips contended
        categories (server/centroids.go:33-52); this is the same contract
        on a lock table. Stale locks (crashed holders) expire after
        BUILD_LOCK_STALE_S."""
        now = time.time()
        with self._lock, self._conn:
            self._conn.execute(
                "DELETE FROM build_locks WHERE category_id=? AND acquired_at<?",
                (category_id, now - BUILD_LOCK_STALE_S),
            )
            cur = self._conn.execute(
                "INSERT OR IGNORE INTO build_locks(category_id, holder, acquired_at) "
                "VALUES (?,?,?)",
                (category_id, holder, now),
            )
            return cur.rowcount == 1

    def release_build_lock(self, category_id: int, holder: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "DELETE FROM build_locks WHERE category_id=? AND holder=?",
                (category_id, holder),
            )

    def embedding_doc_map(self, category_id: int) -> dict[int, int]:
        """embedding id -> document id for a whole category (boot path)."""
        with self._read() as conn:
            rows = conn.execute(
                "SELECT e.id, e.document_id FROM embeddings e "
                "JOIN documents d ON d.id = e.document_id WHERE d.category_id=?",
                (category_id,),
            ).fetchall()
        return dict(rows)

    def embedding_doc_pairs(
        self, category_id: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """(embedding ids, document ids) as int64 arrays, id-sorted — the
        array form of embedding_doc_map (a python dict costs ~100 B/entry,
        GBs at the 10M BASELINE config; arrays cost 16)."""
        chunks = []
        with self._read() as conn:
            # CROSS JOIN: drive from the embeddings PK (see embeddings_page)
            cur = conn.execute(
                "SELECT e.id, e.document_id FROM embeddings e "
                "CROSS JOIN documents d ON d.id = e.document_id "
                "WHERE d.category_id=? ORDER BY e.id",
                (category_id,),
            )
            while True:
                rows = cur.fetchmany(200_000)
                if not rows:
                    break
                chunks.append(np.array(rows, np.int64))
        if not chunks:
            z = np.zeros((0,), np.int64)
            return z, z
        both = np.concatenate(chunks)
        return both[:, 0].copy(), both[:, 1].copy()
