"""The port's host-path tools (vectorsearch_tpu_torch/tools/host_profile.py,
bench_http_concurrent.py) beside the JAX package's (tools/host_profile.py,
tools/bench_http_concurrent.py) on the CPU at 2,000 rows: host_profile's
engine (packed rows bit-equal, the document map, the top-10 document sets
of the same in-process searches on the JAX tool's centroids, within
torch_parity's tolerance at ties) and its JSON line; bench_http_concurrent's
hermetic corpus, queries and centroids bit-equal in SQL, one sweep point a
package, and main()'s line with the JAX tool's keys (also against a running
server, --external); both tools refuse to
run with no card and no VSTPU_DEVICE. Each JAX tool's module constants are
set before use, and its HTTP port is a free one."""
import importlib.util
import json
import logging
import os

import numpy as np
import pytest
import torch

from vectorsearch_tpu.embed.noop import NoopAI as JaxNoopAI
from vectorsearch_tpu.store import db as jax_db
from vectorsearch_tpu_torch.store import db as port_db
from vectorsearch_tpu_torch.convert import arrays_from_index
from vectorsearch_tpu_torch.device import DEVICE_ENV, NoDeviceError
from vectorsearch_tpu_torch.embed.noop import NoopAI
from vectorsearch_tpu_torch.tools import bench_http_concurrent as bhc
from vectorsearch_tpu_torch.tools import host_profile as hp
from vectorsearch_tpu_torch.tools.http_driver import free_port, serving_app
from torch_parity import ATOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N, ROUNDS = 2_000, 12
HTTPB_K, HTTPB_REQS = 16, 16
FIELDS = ("codes", "scale", "offset", "inv_norm")


def jax_tool(name):
    """tools/<name>.py of the JAX package, as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def cpu_and_log_level(monkeypatch):
    """The port on the CPU; the tools' main() sets the engine's log level,
    which is restored for the tests that follow in this process."""
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    torch.set_num_threads(2)
    log = logging.getLogger("vectorsearch")
    level = log.level
    yield
    log.setLevel(level)


@pytest.fixture(scope="module", autouse=True)
def jax_tools_side_effects():
    """The JAX tools set VSTPU_NOOP_AI (host_profile.build_engine) and
    jax_platforms (on import, and in boot_hermetic); both are put back for
    the test files that follow in this process."""
    import jax

    platforms = jax.config.jax_platforms
    noop = os.environ.get("VSTPU_NOOP_AI")
    yield
    if noop is None:
        os.environ.pop("VSTPU_NOOP_AI", None)
    else:
        os.environ["VSTPU_NOOP_AI"] = noop
    jax.config.update("jax_platforms", platforms)


@pytest.fixture(scope="module")
def host_engines():
    """host_profile's engine from each package at N rows; the port's on the
    JAX engine's centroids and bucket membership."""
    jhp = jax_tool("host_profile")
    jhp.N = N
    jeng, jstore, jcat = jhp.build_engine()
    jivf = jeng._states[jcat.id].ivf
    jpacked, jids, jassign = jivf.export_live_assigned()
    order = np.argsort(jids)
    packed, _, _ = hp.synthetic(N, CPU)
    centroids = arrays_from_index(jivf)["centroids"]
    eng, store, cat = hp.build_engine(packed, centroids, jassign[order], NoopAI(seed=1), CPU)
    yield {"jax": (jeng, jstore, jcat, [np.asarray(a)[order] for a in jpacked], jids[order]),
           "port": (eng, store, cat, packed)}
    for e, s in ((jeng, jstore), (eng, store)):
        e.close()
        s.close()


def test_host_profile_rows_and_doc_map(host_engines):
    jeng, jstore, jcat, jrows, jids = host_engines["jax"]
    eng, store, cat, packed = host_engines["port"]
    np.testing.assert_array_equal(jids, np.arange(1, N + 1))
    for f, want in zip(FIELDS, jrows):
        np.testing.assert_array_equal(np.asarray(getattr(packed, f)), want, err_msg=f)
    assert dict(eng._states[cat.id].doc_map.items()) == dict(
        jeng._states[jcat.id].doc_map.items())
    docs = [(d.id, d.name) for d in store.fetch_documents(range(1, N // 20 + 2))]
    assert docs == [(d.id, d.name) for d in jstore.fetch_documents(range(1, N // 20 + 2))]
    assert len(docs) == max(64, N // 20)


@pytest.mark.parametrize("nprobe", [1, 8, -1])
def test_host_profile_searches_match_jax(host_engines, nprobe):
    """The same texts through both engines: top-10 document sets equal,
    similarities within ATOL, a document outside the other's set only at a
    tie with the tenth similarity."""
    jeng = host_engines["jax"][0]
    eng = host_engines["port"][0]
    assert NoopAI(seed=1).embed(["q0"])[0].tobytes() == JaxNoopAI(seed=1).embed(["q0"])[0].tobytes()
    for i in range(ROUNDS):
        text = f"q{i}"
        got = {h.document_id: h.similarity for h in eng.search("o", "c", text, 10, centroids=nprobe)}
        want = {h.document_id: h.similarity
                for h in jeng.search("o", "c", text, 10, centroids=nprobe)}
        assert len(got) == len(want) == 10, text
        for d in got.keys() & want.keys():
            assert abs(got[d] - want[d]) <= ATOL, (text, d)
        edge = min(want.values())
        for d in got.keys() ^ want.keys():
            assert abs(got.get(d, want.get(d)) - edge) <= ATOL, (text, d, got, want)


def test_host_profile_json_line(monkeypatch, capsys):
    """Both tools' main() at N rows: the JAX tool logs its split (on its own
    free port); the port's prints one JSON line whose phases sum to no
    more than each total and whose HTTP overhead is finite."""
    jhp = jax_tool("host_profile")
    jhp.N, jhp.ROUNDS, jhp.PORT = N, ROUNDS, free_port()
    jhp.main()
    assert "HTTP layer overhead" in capsys.readouterr().err
    monkeypatch.setattr(hp, "N", N)
    monkeypatch.setattr(hp, "ROUNDS", ROUNDS)
    assert hp.main() == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert (line["tool"], line["n"], line["device"]) == ("host_profile", N, "cpu")
    assert line["native_codec"] in ("openmp", "serial", "numpy")
    for nprobe in hp.NPROBES:
        split = line[f"nprobe{nprobe}"]
        parts = split["embed_ms"] + split["dispatch_ms"] + split["sql_fetch_ms"]
        assert 0 < parts <= split["total_ms"]
        assert split["engine_other_ms"] == pytest.approx(split["total_ms"] - parts)
        assert split["device_ms"] is None  # measured on a card only
    http = line["http"]
    assert np.isfinite(http["overhead_ms"]) and http["sequential_ms"] > 0
    assert http["overhead_ms"] == pytest.approx(
        http["sequential_ms"] - min(http["inprocess_pre_ms"], http["inprocess_post_ms"]))


@pytest.fixture
def jax_httpb(monkeypatch):
    mod = jax_tool("bench_http_concurrent")
    for name, v in (("N", N), ("K", HTTPB_K), ("DIM", 768), ("NPROBE", 8)):
        monkeypatch.setattr(mod, name, v)
    return mod


def sql_rows(store):
    with store._lock:
        conn = store._conn
        emb = conn.execute("SELECT id, vector, document_id, centroid_id FROM embeddings "
                           "ORDER BY id").fetchall()
        cents = conn.execute("SELECT id, vector FROM centroids ORDER BY id").fetchall()
    return emb, cents


def sweep_point_ok(r, requests):
    assert r["requests"] == requests
    assert 1 <= r["rows_per_dispatch"] and 1 <= r["dispatches"] <= r["requests"]
    # every request reached the batcher: none failed
    assert round(r["rows_per_dispatch"] * r["dispatches"]) == requests


def test_bench_http_concurrent_corpus_and_sweep_match_jax(jax_httpb, monkeypatch):
    """The hermetic boot of both tools: SQL rows, centroids and assignments
    bit-equal, the queries bit-equal; one sweep point a package (4 clients,
    16 requests) with no error. The JAX store shares one zstd decompressor
    across threads, a reference fault that fails concurrent searches
    (ROADMAP queue 3); its point runs on the port's per-thread contexts,
    which give the same bytes."""
    monkeypatch.setattr(jax_db, "decompress", port_db.decompress)
    base, jeng, cleanup = jax_httpb.boot_hermetic(False)
    try:
        packed, cents, assign, queries = bhc.corpus(N, HTTPB_K, 768)
        eng, store, _ = bhc.boot(packed, cents, assign, queries, CPU)
        try:
            np.testing.assert_array_equal(eng.ai.queries, jeng.ai.queries)
            assert sql_rows(store) == sql_rows(jeng.store)
            with serving_app(eng) as port:
                eng.warmup(nprobes=(8,))
                mine = bhc.run_load("127.0.0.1", port, "scale", "corpus", 4, HTTPB_REQS, 8, eng)
        finally:
            eng.close()
            store.close()
        theirs = jax_httpb.run_load(base, "scale", "corpus", 4, HTTPB_REQS, 8, jeng)
    finally:
        cleanup()
    assert mine["errors"] == 0
    for r in (mine, theirs):
        sweep_point_ok(r, HTTPB_REQS)


def test_bench_http_concurrent_main(monkeypatch, capsys):
    """The port's main() at N rows: one JSON line with the JAX tool's keys,
    mode `cpu`, a sequential pass and one concurrent point without errors,
    from clients in this process and again from a client process."""
    for name, v in (("N", N), ("K", HTTPB_K), ("REQS", HTTPB_REQS), ("CLIENTS", (1, 4))):
        monkeypatch.setattr(bhc, name, v)
    assert bhc.main([]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"mode", "n", "nprobe", "host_cores", "sweep"} <= line.keys()
    assert (line["mode"], line["n"], line["nprobe"], line["device"]) == ("cpu", N, 8, "cpu")
    for key in ("sweep", "sweep_client_process"):
        seq, conc = line[key]
        assert (seq["clients"], conc["clients"]) == (1, 4), key
        for r in line[key]:
            assert r["errors"] == 0, key
            sweep_point_ok(r, HTTPB_REQS)
        assert conc["speedup_vs_seq"] == pytest.approx(conc["qps"] / seq["qps"])


def test_bench_http_concurrent_external(monkeypatch, capsys):
    """--external URL: the sweep against a running server, the batcher's
    counts read from its /api/stats."""
    for name, v in (("REQS", HTTPB_REQS), ("CLIENTS", (1, 4))):
        monkeypatch.setattr(bhc, name, v)
    eng, store, _ = bhc.boot(*bhc.corpus(N, HTTPB_K, 64), CPU)
    try:
        with serving_app(eng) as port:
            assert bhc.main(["--external", f"http://127.0.0.1:{port}"]) == 0
    finally:
        eng.close()
        store.close()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["mode"], line["n"]) == ("external", None)
    for r in line["sweep"]:
        assert r["errors"] == 0
        sweep_point_ok(r, HTTPB_REQS)


@pytest.mark.parametrize("main", [hp.main, lambda: bhc.main([])], ids=["host_profile",
                                                                      "bench_http_concurrent"])
def test_tools_refuse_without_a_card(monkeypatch, main):
    """No card and no VSTPU_DEVICE: NoDeviceError names the missing card
    before any work (never a silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    monkeypatch.delenv(DEVICE_ENV)
    with pytest.raises(NoDeviceError, match="no CUDA card"):
        main()
