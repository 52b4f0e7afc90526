"""Versioned array snapshots (checkpoint/resume for the HBM index).

The reference's checkpoint story is "the database is the checkpoint"
(SURVEY.md §5): index state is centroid rows + embeddings.centroid_id, and
a crashed rebuild just leaves the old assignment. Here the device-resident
index (packed codes + sidecars + centroids) additionally snapshots to disk
as monotonically versioned npz files with atomic renames, so boot restores
the packed HBM layout directly instead of re-quantizing/re-packing every
row out of SQL. The SQL store remains the durable source of truth; a stale
or missing snapshot only costs a slower boot.

Layout: <root>/<scope>/snap-<version>.npz (+ meta json inside the npz).
Writers write to *.tmp then os.replace -> readers never see a torn file.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np

_SNAP_RE = re.compile(r"^snap-(\d+)\.npz$")


def _scope_dir(root: str, scope: str) -> str:
    return os.path.join(root, scope)


def save(root: str, scope: str, arrays: dict[str, np.ndarray], meta: dict) -> int:
    """Write a new snapshot version; returns the version number."""
    d = _scope_dir(root, scope)
    os.makedirs(d, exist_ok=True)
    version = latest_version(root, scope) + 1
    path = os.path.join(d, f"snap-{version}.npz")
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                __meta__=np.frombuffer(
                    json.dumps(meta).encode("utf-8"), dtype=np.uint8
                ),
                **arrays,
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return version


def latest_version(root: str, scope: str) -> int:
    d = _scope_dir(root, scope)
    if not os.path.isdir(d):
        return 0
    versions = [
        int(m.group(1)) for f in os.listdir(d) if (m := _SNAP_RE.match(f))
    ]
    return max(versions, default=0)


def load(
    root: str, scope: str, version: int | None = None
) -> tuple[dict, dict[str, np.ndarray]] | None:
    """Load the given (default: latest) snapshot; None if absent/corrupt."""
    if version is None:
        version = latest_version(root, scope)
    if version <= 0:
        return None
    path = os.path.join(_scope_dir(root, scope), f"snap-{version}.npz")
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        return meta, arrays
    except Exception:
        # any unreadable snapshot (torn zip, bad pickle header, missing
        # meta, truncated file) falls back to the SQL rebuild path — a
        # corrupt snapshot must never block boot
        return None


def prune(root: str, scope: str, keep: int = 2) -> None:
    """Delete all but the newest `keep` versions."""
    d = _scope_dir(root, scope)
    if not os.path.isdir(d):
        return
    versions = sorted(
        int(m.group(1)) for f in os.listdir(d) if (m := _SNAP_RE.match(f))
    )
    for v in versions[:-keep] if keep > 0 else versions:
        try:
            os.unlink(os.path.join(d, f"snap-{v}.npz"))
        except OSError:
            pass


def purge(root: str, scope: str) -> None:
    """Remove every snapshot for a scope (category deleted)."""
    prune(root, scope, keep=0)
    d = _scope_dir(root, scope)
    if os.path.isdir(d) and not os.listdir(d):
        os.rmdir(d)
