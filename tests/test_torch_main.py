"""The port's entry point, `python -m vectorsearch_tpu_torch config.json`.

In a subprocess with the deterministic fake embedder (VSTPU_NOOP_AI=1): a
missing config writes a sample and exits 1; the entry boots, serves an
upload and a search over HTTP and HTTPS, exits 0 on SIGTERM, and serves
the same documents again after a reboot; a `mesh` config serves through
its sharded replica, and one over several processes is refused. Every
boot asks for the CPU by name (VSTPU_DEVICE=cpu): with the variable unset
and no card, run() names it on stderr and returns non-zero before it
opens the store. In process: a SQLite store and snapshot dir written by the JAX
Engine boot the port's server (from the snapshot) and answer the same
searches, and a store and snapshots written by the port's Engine boot the
JAX Engine with the same answers.
"""
import http.client
import json
import os
import signal
import socket
import ssl
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from vectorsearch_tpu import constants
from vectorsearch_tpu.engine import Engine as JaxEngine
from vectorsearch_tpu.store import Store
from vectorsearch_tpu_torch import __main__ as entry
from vectorsearch_tpu_torch import config as config_mod
from vectorsearch_tpu_torch import constants as port_constants
from vectorsearch_tpu_torch.host import Store as PortStore
from vectorsearch_tpu_torch.engine import Engine

from test_engine import WordHashAI

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config(tmp_path, https=False, **extra):
    http_port = _free_port()
    cfg = {
        "server": {
            "http_address": f"127.0.0.1:{http_port}",
            "https_address": f"127.0.0.1:{_free_port()}" if https else "",
        },
        "database": {"sqlite": str(tmp_path / "store.db"),
                     "snapshots": str(tmp_path / "snaps")},
        "log_level": "info",
        **extra,
    }
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return path, cfg


def _entry(config_path, log_path):
    env = dict(os.environ, PYTHONPATH=ROOT, VSTPU_NOOP_AI="1", VSTPU_DEVICE="cpu")
    log = open(log_path, "ab")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "vectorsearch_tpu_torch", str(config_path)],
            cwd=str(config_path.parent), env=env, stdout=log, stderr=log,
        )
    finally:
        log.close()


def _wait_listening(proc, port, log_path, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, log_path.read_text()
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.2)
    proc.kill()
    raise AssertionError("entry did not listen:\n" + log_path.read_text())


def _post(conn, path, obj):
    conn.request("POST", path, body=json.dumps(obj).encode())
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def _stop(proc, log_path):
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError("no exit within 30 s of SIGTERM:\n" + log_path.read_text())
    assert rc == 0, log_path.read_text()


def test_missing_config_writes_a_sample_and_exits_1(tmp_path):
    path = tmp_path / "config.json"
    out = subprocess.run(
        [sys.executable, "-m", "vectorsearch_tpu_torch", str(path)],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 1 and "sample configuration" in out.stderr
    assert config_mod.load(str(path)).ollama.embed.model  # a loadable sample


def test_boot_serve_sigterm_and_reboot(tmp_path):
    path, cfg = _config(tmp_path, https=True)
    port = int(cfg["server"]["http_address"].rsplit(":", 1)[1])
    tls_port = int(cfg["server"]["https_address"].rsplit(":", 1)[1])
    log_path = tmp_path / "entry.log"
    docs = [{"name": f"doc{i}", "document": {"text": f"body {i}"}} for i in range(5)]
    query = {"owner": "o", "category": "c", "text": "body", "count": 10, "centroids": -1}

    proc = _entry(path, log_path)
    try:
        _wait_listening(proc, port, log_path)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        status, up = _post(conn, "/api/upload", {"owner": "o", "category": "c",
                                                 "documents": docs})
        assert status == 200 and len(up["document_ids"]) == 5
        status, res = _post(conn, "/api/search", query)
        assert status == 200
        assert sorted(d["document_id"] for d in res["documents"]) == up["document_ids"]
        conn.close()
        ctx = ssl.create_default_context()
        ctx.check_hostname, ctx.verify_mode = False, ssl.CERT_NONE
        tls = http.client.HTTPSConnection("127.0.0.1", tls_port, timeout=60, context=ctx)
        assert _post(tls, "/api/categories", {"owner": "o"}) == (200, {"category_names": ["c"]})
        tls.close()
    finally:
        _stop(proc, log_path)
    assert "device cpu (asked for with VSTPU_DEVICE)" in log_path.read_text()

    proc = _entry(path, log_path)
    try:
        _wait_listening(proc, port, log_path)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        status, res = _post(conn, "/api/search", query)
        assert status == 200
        assert sorted(d["document_id"] for d in res["documents"]) == up["document_ids"]
        assert {d["name"] for d in res["documents"]} == {d["name"] for d in docs}
        conn.close()
    finally:
        _stop(proc, log_path)


def _get(conn, path):
    conn.request("GET", path)
    r = conn.getresponse()
    return r.status, json.loads(r.read())


@pytest.mark.parametrize("coordinator", [False, True], ids=["one-process", "coordinator"])
def test_mesh_config_serves_through_the_replica(tmp_path, coordinator):
    """`mesh.shard_serving` with 2 CPU shards (VSTPU_DEVICE=cpu), alone or
    after joining a process group of one (`mesh.coordinator`,
    num_processes 1, gloo): boot 1 takes an upload; boot 2's startup
    rebuild installs the sharded replica (/api/stats), a search answers
    through it, and SIGTERM exits 0."""
    mesh = {"shard_serving": True, "devices": 2}
    if coordinator:
        mesh.update(coordinator=f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0)
    path, cfg = _config(tmp_path, mesh=mesh)
    port = int(cfg["server"]["http_address"].rsplit(":", 1)[1])
    log_path = tmp_path / "entry.log"
    docs = [{"name": f"doc{i}", "document": {"text": f"body {i}"}} for i in range(6)]
    query = {"owner": "o", "category": "c", "text": "body", "count": 10, "centroids": -1}

    proc = _entry(path, log_path)
    try:
        _wait_listening(proc, port, log_path)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        status, up = _post(conn, "/api/upload", {"owner": "o", "category": "c",
                                                 "documents": docs})
        assert status == 200 and len(up["document_ids"]) == 6
        conn.close()
    finally:
        _stop(proc, log_path)

    proc = _entry(path, log_path)
    try:
        _wait_listening(proc, port, log_path)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        deadline = time.monotonic() + 60
        while True:
            status, stats = _get(conn, "/api/stats")
            cats = stats["categories"]
            if cats and all(c["replica_shards"] == 2 for c in cats.values()):
                break
            assert time.monotonic() < deadline, (stats, log_path.read_text())
            time.sleep(0.2)
        status, res = _post(conn, "/api/search", query)
        assert status == 200
        assert sorted(d["document_id"] for d in res["documents"]) == up["document_ids"]
        conn.close()
    finally:
        _stop(proc, log_path)
    log = log_path.read_text()
    assert log.count("sharded serving over 2 shards (2 on this process, 1 ranks)") == 2
    assert ("process group: rank 0 of 1" in log) == coordinator


def test_shard_serving_over_several_processes_is_refused(tmp_path, monkeypatch, capsys):
    """`mesh.shard_serving` with num_processes 2: each rank would answer its
    own requests, while a sharded search is a collective every rank must
    enter. One line on stderr that names the setting and exit 2, before the
    process group forms or the store opens."""
    monkeypatch.setenv("VSTPU_DEVICE", "cpu")
    _, cfg = _config(tmp_path, mesh={
        "shard_serving": True, "devices": 2, "coordinator": f"127.0.0.1:{_free_port()}",
        "num_processes": 2, "process_id": 0,
    })
    cfg["log_level"] = "error"
    rc = entry.run(config_mod.Config.parse(json.dumps(cfg)), WordHashAI())
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 2
    assert len(err) == 1 and "mesh.num_processes 2" in err[0]
    assert not torch.distributed.is_initialized()
    assert not (tmp_path / "store.db").exists()


def test_no_card_and_no_ask_refuses_to_serve(tmp_path, monkeypatch, capsys):
    """VSTPU_DEVICE unset and no CUDA card: one line on stderr that names
    the variable, a non-zero code, and no store opened. VSTPU_DEVICE=cuda
    without a card is refused the same way."""
    _, cfg = _config(tmp_path)
    cfg["log_level"] = "error"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for ask in (None, "cuda"):
        if ask is None:
            monkeypatch.delenv("VSTPU_DEVICE", raising=False)
        else:
            monkeypatch.setenv("VSTPU_DEVICE", ask)
        rc = entry.run(config_mod.Config.parse(json.dumps(cfg)), WordHashAI())
        err = capsys.readouterr().err.strip().splitlines()
        assert rc != 0
        assert len(err) == 1 and "VSTPU_DEVICE" in err[0] and "no CUDA card" in err[0]
        assert not (tmp_path / "store.db").exists()


# ---- snapshots and stores across the two packages

DOCS = [{"name": f"n{i}", "document": {"text": f"w{i % 13} v{i % 7} u{i % 5} item{i}"}}
        for i in range(240)]
QUERIES = ["w3 v2", "u4 w11", "v6 u1 w0", "item17 w4"]


@pytest.fixture
def small_buckets(monkeypatch):
    monkeypatch.setattr(constants, "BUCKET_ROUND", 64)
    monkeypatch.setattr(port_constants, "BUCKET_ROUND", 64)
    torch.set_num_threads(2)


def _write(engine):
    for i in range(0, len(DOCS), 80):
        engine.upload("o", "c", DOCS[i : i + 80])
    assert engine.refresh_centroids(target_cluster_size=40) == {1: True}


def _answers(engine, centroids):
    return [[(h.document_id, h.similarity) for h in engine.search(
        "o", "c", q, count=5, centroids=centroids)] for q in QUERIES]


def _assert_same_answers(a, b):
    for pa, pb in zip(a, b, strict=True):
        assert [d for d, _ in pa] == [d for d, _ in pb]
        np.testing.assert_allclose([s for _, s in pa], [s for _, s in pb], atol=ATOL)


def _spy_restores(monkeypatch, cls):
    hits = []
    real = cls._try_restore_snapshot

    def spy(self, *a, **kw):
        out = real(self, *a, **kw)
        hits.append(out is not None)
        return out

    monkeypatch.setattr(cls, "_try_restore_snapshot", spy)
    return hits


def test_jax_store_and_snapshots_boot_the_port_server(tmp_path, small_buckets, monkeypatch):
    store = Store(str(tmp_path / "store.db"))
    jx = JaxEngine(store, WordHashAI(), snapshot_dir=str(tmp_path / "snaps"))
    _write(jx)
    want = {c: _answers(jx, c) for c in (2, -1)}
    assert jx._state_for(1).ivf.k_clusters > 2
    jx.close()
    store.close()

    restored = _spy_restores(monkeypatch, Engine)
    # the port's Engine on the JAX files: the same clustering, so the same
    # answers at a partial probe too
    store = PortStore(str(tmp_path / "store.db"))
    pt = Engine(store, WordHashAI(), snapshot_dir=str(tmp_path / "snaps"), device="cpu")
    assert restored == [True]
    for c in (2, -1):
        _assert_same_answers(_answers(pt, c), want[c])
    pt.close()
    store.close()

    # the port's server, booted by its entry on the same files (its startup
    # rebuild may re-cluster meanwhile: the exhaustive search is compared)
    _, cfg = _config(tmp_path)
    cfg["log_level"] = "error"
    monkeypatch.setenv("VSTPU_DEVICE", "cpu")
    port = int(cfg["server"]["http_address"].rsplit(":", 1)[1])
    stop, rc = threading.Event(), []
    server = threading.Thread(target=lambda: rc.append(entry.run(
        config_mod.Config.parse(json.dumps(cfg)), WordHashAI(), stop)))
    server.start()
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                got = [_post(conn, "/api/search", {
                    "owner": "o", "category": "c", "text": q, "count": 5, "centroids": -1,
                })[1]["documents"] for q in QUERIES]
                conn.close()
                break
            except ConnectionRefusedError:
                assert server.is_alive() and time.monotonic() < deadline
                time.sleep(0.1)
    finally:
        stop.set()
        server.join(60)
    assert not server.is_alive() and rc == [0]
    assert restored == [True, True]
    _assert_same_answers(
        [[(d["document_id"], d["document_similarity"]) for d in page] for page in got],
        want[-1],
    )


def test_port_store_and_snapshots_boot_the_jax_engine(tmp_path, small_buckets, monkeypatch):
    store = PortStore(str(tmp_path / "store.db"))
    pt = Engine(store, WordHashAI(), snapshot_dir=str(tmp_path / "snaps"), device="cpu")
    _write(pt)
    want = {c: _answers(pt, c) for c in (2, -1)}
    assert pt._state_for(1).ivf.k_clusters > 2
    pt.close()
    store.close()

    restored = _spy_restores(monkeypatch, JaxEngine)
    store = Store(str(tmp_path / "store.db"))
    jx = JaxEngine(store, WordHashAI(), snapshot_dir=str(tmp_path / "snaps"))
    try:
        assert restored == [True]
        for c in (2, -1):
            _assert_same_answers(_answers(jx, c), want[c])
    finally:
        jx.close()
        store.close()
