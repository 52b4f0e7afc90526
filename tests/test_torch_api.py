"""The port's HTTP API against the JAX app.

Each scenario of tests/test_api.py runs twice on the same requests from
the same standard-library client: against the JAX aiohttp app over the
JAX Engine, and against the port's server (vectorsearch_tpu_torch.api)
over the port's Engine, both with the word-hash embedder. The two
transcripts must agree: status codes; the COOP/COEP, Allow,
Content-Encoding and Transfer-Encoding headers; JSON bodies with equal
ids and names and similarities within 1e-5; other bodies byte for byte.
The scenarios' own assertions hold on both.

Then the cases only the port's server has to show: the 413 body limit,
keep-alive, chunked and pipelined requests, and the decompression cap.
"""
import asyncio
import contextlib
import http.client
import json
import re
import socket
import threading
import time

import pytest
import torch

from vectorsearch_tpu import constants
from vectorsearch_tpu.engine import Engine as JaxEngine
from vectorsearch_tpu.engine import EngineCache as JaxEngineCache
from vectorsearch_tpu.store import Store
from vectorsearch_tpu_torch import constants as port_constants
from vectorsearch_tpu_torch.host import Store as PortStore
from vectorsearch_tpu.store.db import compress, decompress
from vectorsearch_tpu_torch.api import http as port_http
from vectorsearch_tpu_torch.engine import Engine, EngineCache

from test_engine import FRUIT_DOCS, WordHashAI

ATOL = 1e-5
COMPARED_HEADERS = (
    "cross-origin-opener-policy", "cross-origin-embedder-policy", "allow",
    "content-encoding", "transfer-encoding",
)


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    monkeypatch.setattr(constants, "BUCKET_ROUND", 64)
    monkeypatch.setattr(port_constants, "BUCKET_ROUND", 64)
    torch.set_num_threads(2)


def make_engine(kind):
    if kind == "jax":
        return JaxEngine(Store(":memory:"), WordHashAI(), cache=JaxEngineCache(ttl=0.0))
    return Engine(PortStore(":memory:"), WordHashAI(), cache=EngineCache(ttl=0.0),
                  device="cpu")


@contextlib.contextmanager
def serving(kind, engine):
    """The JAX app (production AppRunner settings) or the port's server
    over `engine`, on a free localhost port, on a loop of its own."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    async def boot():
        if kind == "jax":
            from aiohttp import web

            from vectorsearch_tpu.api import build_app as jax_build_app

            runner = web.AppRunner(
                jax_build_app(engine), auto_decompress=False,
                handler_cancellation=True,
            )
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            return site._server.sockets[0].getsockname()[1], runner.cleanup
        server = await port_http.HTTPServer(port_http.build_app(engine)).start(
            "127.0.0.1", 0
        )
        return server.port, server.close

    port, stop = asyncio.run_coroutine_threadsafe(boot(), loop).result(30)
    try:
        yield port
    finally:
        asyncio.run_coroutine_threadsafe(stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()
        engine.close()
        engine.store.close()


def decode(headers, raw):
    if headers.get("content-encoding") == "zstd":
        raw = decompress(raw)
    try:
        return json.loads(raw)
    except ValueError:
        return raw


def request(port, method, path, json_body=None, data=None, headers=None):
    """One request on a fresh connection: an observation dict of the
    status, the compared headers and the decoded body."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        body = data if json_body is None else json.dumps(json_body).encode()
        conn.request(method, path, body=body, headers=dict(headers or {}))
        r = conn.getresponse()
        raw = r.read()
        got = {k.lower(): v for k, v in r.getheaders()}
    finally:
        conn.close()
    obs = {"status": r.status, **{h: got.get(h) for h in COMPARED_HEADERS}}
    obs["body"] = decode(got, raw)
    return obs


def assert_same(a, b, where="body"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (where, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert b == pytest.approx(a, abs=ATOL), (where, a, b)
    else:
        assert a == b, (where, a, b)


# ---- the scenarios of tests/test_api.py: (call, engine) -> transcript


def sc_upload_then_search(call, engine):
    up = call("POST", "/api/upload",
              {"owner": "a", "category": "c", "documents": FRUIT_DOCS})
    assert up["status"] == 200 and len(up["body"]["document_ids"]) == 3
    res = call("POST", "/api/search",
               {"owner": "a", "category": "c", "text": "banana tropical", "count": 2})
    top = res["body"]["documents"][0]
    assert top["name"] == "bananas" and top["document_id"] == up["body"]["document_ids"][1]
    assert 0 < top["document_similarity"] <= 1.01
    return [up, res]


def sc_method_not_allowed(call, engine):
    r = call("PUT", "/api/upload", {})
    assert r["status"] == 405 and r["allow"] == "POST" and "error" in r["body"]
    return [r]


def sc_bad_json(call, engine):
    r = call("POST", "/api/search", data=b"{not json")
    assert r["status"] == 400
    return [r]


def sc_upload_empty_documents_is_400(call, engine):
    r = call("POST", "/api/upload", {"owner": "a", "category": "c", "documents": []})
    assert r["status"] == 400
    return [r]


def sc_zstd_request_and_response(call, engine):
    payload = compress(json.dumps(
        {"owner": "a", "category": "c", "documents": FRUIT_DOCS}).encode())
    up = call("POST", "/api/upload", data=payload,
              headers={"Content-Encoding": "zstd", "Accept-Encoding": "zstd"})
    assert up["status"] == 200 and len(up["body"]["document_ids"]) == 3
    res = call("POST", "/api/search",
               {"owner": "a", "category": "c", "text": "banana", "count": 3},
               headers={"Accept-Encoding": "zstd"})
    assert res["status"] == 200 and res["content-encoding"] == "zstd"
    assert res["body"]["documents"]
    return [up, res]


def sc_categories_and_deletes(call, engine):
    out = [
        call("POST", "/api/upload", {"owner": "a", "category": "c1", "documents": FRUIT_DOCS[:1]}),
        call("POST", "/api/upload", {"owner": "a", "category": "c2", "documents": FRUIT_DOCS[1:2]}),
        call("POST", "/api/categories", {"owner": "a"}),
        call("POST", "/api/delete/category", {"owner": "a", "category": "c1"}),
        call("POST", "/api/categories", {"owner": "a"}),
        call("POST", "/api/delete/owner", {"owner": "a"}),
        call("POST", "/api/categories", {"owner": "a"}),
    ]
    assert out[2]["body"]["category_names"] == ["c1", "c2"]
    assert out[3]["status"] == 200 and out[3]["body"] == {}
    assert out[4]["body"]["category_names"] == ["c2"]
    assert out[5]["status"] == 200 and out[6]["body"]["category_names"] == []
    return out


def sc_delete_document_route(call, engine):
    up = call("POST", "/api/upload", {"owner": "a", "category": "c", "documents": FRUIT_DOCS})
    ids = up["body"]["document_ids"]
    de = call("POST", "/api/delete/document",
              {"owner": "a", "category": "c", "document_id": ids[0]})
    assert de["status"] == 200
    res = call("POST", "/api/search",
               {"owner": "a", "category": "c", "text": "apple orchard", "count": 3})
    assert all(d["document_id"] != ids[0] for d in res["body"]["documents"])
    return [up, de, res]


def sc_chat_stream(call, engine):
    r = call("POST", "/api/chat", {"text": "hello"})
    assert r["status"] == 200 and r["transfer-encoding"] == "chunked"
    assert r["body"] == b"chat reply"
    return [r]


def sc_static_pages(call, engine):
    out = [call("GET", path) for path in ("/", "/api", "/api/openapi.yml")]
    assert all(r["status"] == 200 for r in out)
    return out


def sc_api_console_covers_every_openapi_path(call, engine):
    page, spec = call("GET", "/api"), call("GET", "/api/openapi.yml")
    html, yml = page["body"].decode(), spec["body"].decode()
    spec_paths = re.findall(r"^  (/api/\S+):", yml, re.M)
    assert spec_paths
    for p in spec_paths:
        assert f'path: "{p}"' in html, p
    assert len(re.findall(r'path: "/api/', html)) == len(spec_paths)
    return [page, spec]


def sc_wasm_headers_on_every_route(call, engine):
    out = [call("GET", path) for path in ("/", "/api/stats", "/api/openapi.yml")]
    out.append(call("POST", "/api/search", {"owner": "a", "category": "c", "text": "x"}))
    for r in out:
        assert r["cross-origin-opener-policy"] == "same-origin"
        assert r["cross-origin-embedder-policy"] == "require-corp"
    # the stats bodies describe each engine and device: not compared
    assert set(out[1].pop("body")) >= {"categories", "batcher", "build", "devices"}
    return out


def sc_static_zstd_compression(call, engine):
    r = call("GET", "/", headers={"Accept-Encoding": "zstd"})
    assert r["content-encoding"] == "zstd"
    assert b"<html" in r["body"] or b"<!doctype" in r["body"].lower()
    return [r]


def sc_search_via_get(call, engine):
    r = call("GET", "/api/search", {"owner": "a", "category": "c", "text": "x"})
    assert r["status"] == 200 and r["body"] == {"documents": []}
    return [r]


def sc_delete_rejects_get(call, engine):
    r = call("GET", "/api/delete/owner")
    assert r["status"] == 405
    return [r]


def sc_chat_with_inline_documents(call, engine):
    r = call("POST", "/api/chat", {"text": "q", "documents": [{"inline": "doc"}]})
    assert r["status"] == 200 and r["body"] == b"chat reply"
    assert "inline: doc." in engine.ai.chat_calls[-1][-1]["content"]
    return [r]


def sc_batch_search_route(call, engine):
    up = call("POST", "/api/upload", {"owner": "a", "category": "c", "documents": FRUIT_DOCS})
    ids = up["body"]["document_ids"]
    full = call("POST", "/api/search", {
        "owner": "a", "category": "c", "texts": ["banana tropical", "gearbox road"],
        "count": 2,
    })
    res = full["body"]["results"]
    assert len(res) == 2 and res[0]["documents"][0]["name"] == "bananas"
    assert res[0]["documents"][0]["document_id"] == ids[1]
    assert res[1]["documents"][0]["name"] == "cars"
    assert res[0]["documents"][0]["document"] == {"text": "banana plantation tropical fruit"}
    slim = call("POST", "/api/search", {
        "owner": "a", "category": "c", "texts": ["banana tropical"], "count": 2,
        "include_documents": False,
    })
    doc = slim["body"]["results"][0]["documents"][0]
    assert doc["document"] is None and doc["name"] == "" and doc["document_id"] == ids[1]
    empty = call("POST", "/api/search", {"owner": "a", "category": "c", "texts": []})
    assert empty["status"] == 200 and empty["body"]["results"] == []
    return [up, full, slim, empty]


SCENARIOS = [v for k, v in sorted(globals().items()) if k.startswith("sc_")]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
def test_port_matches_jax_app(scenario):
    transcripts = {}
    for kind in ("jax", "port"):
        engine = make_engine(kind)
        with serving(kind, engine) as port:
            def call(method, path, json_body=None, data=None, headers=None):
                return request(port, method, path, json_body, data, headers)

            transcripts[kind] = scenario(call, engine)
    jx, pt = transcripts["jax"], transcripts["port"]
    assert len(jx) == len(pt)
    for i, (a, b) in enumerate(zip(jx, pt)):
        if a["transfer-encoding"] == "chunked":
            # the JAX app sends a stream's headers before its middleware
            # adds COOP/COEP; the port sends them on every response, as
            # the reference does (main.go:117-125)
            wasm = {h: b[h] for h in COMPARED_HEADERS[:2]}
            assert wasm == {h: None for h in wasm} | {
                "cross-origin-opener-policy": "same-origin",
                "cross-origin-embedder-policy": "require-corp",
            }
            assert all(a[h] is None for h in wasm)
            a = {**a, **wasm}
        assert_same(a, b, f"response {i}")


@pytest.mark.parametrize("kind", ["jax", "port"])
def test_client_disconnect_cancels_engine(kind):
    """A client that disconnects mid-request makes the engine abort
    between stages: no device dispatch for a dead client."""
    engine = make_engine(kind)
    engine.upload("alice", "docs", FRUIT_DOCS)
    d0 = engine._batcher.stats()["dispatches"]
    embed_entered, release = threading.Event(), threading.Event()

    class SlowEmbedAI(WordHashAI):
        def embed(self, inputs, model=None):
            out = super().embed(inputs, model)
            if any("search_query" in s for s in inputs):
                embed_entered.set()
                release.wait(5)  # hold until the client has gone
            return out

    engine.ai = SlowEmbedAI()
    body = json.dumps({"owner": "alice", "category": "docs", "text": "banana"}).encode()
    try:
        with serving(kind, engine) as port:
            with socket.create_connection(("127.0.0.1", port)) as s:
                s.sendall(b"POST /api/search HTTP/1.1\r\nHost: t\r\nContent-Length: %d"
                          b"\r\n\r\n%s" % (len(body), body))
                assert embed_entered.wait(10)
            time.sleep(0.3)  # the close reaches the handler before the embed returns
            release.set()
            time.sleep(0.5)  # the engine thread reaches its cancel check
            assert engine._batcher.stats()["dispatches"] == d0
    finally:
        release.set()


# ---- the port's server only


@pytest.fixture
def port_server():
    engine = make_engine("port")
    with serving("port", engine) as port:
        yield port


def test_body_over_limit_is_413(monkeypatch, port_server):
    """Over MAX_BODY: a Content-Length is refused before the body is
    read, a chunked body as soon as it passes the limit."""
    monkeypatch.setattr(port_http, "MAX_BODY", 1024)
    with socket.create_connection(("127.0.0.1", port_server)) as s:
        s.sendall(b"POST /api/upload HTTP/1.1\r\nHost: t\r\nContent-Length: 2000\r\n\r\n")
        assert s.makefile("rb").readline().startswith(b"HTTP/1.1 413 ")
    conn = http.client.HTTPConnection("127.0.0.1", port_server, timeout=30)
    conn.request("POST", "/api/upload", body=iter([b"x" * 700] * 3), encode_chunked=True,
                 headers={"Transfer-Encoding": "chunked"})
    r = conn.getresponse()
    assert r.status == 413 and "error" in json.loads(r.read())
    conn.close()


def test_body_over_limit_with_a_long_tail_reads_the_413(monkeypatch, port_server):
    """A client that goes on sending after the limit was passed (a 1 MB
    tail) still reads the 413, every time: the server half-closes and
    drains before it closes, so the kernel sends no reset. A malformed
    chunk size with a tail reads its 400 the same way."""
    monkeypatch.setattr(port_http, "MAX_BODY", 1024)
    tail = b"y" * (1 << 20)
    for _ in range(50):
        conn = http.client.HTTPConnection("127.0.0.1", port_server, timeout=30)
        conn.request("POST", "/api/upload", body=iter([b"x" * 700] * 3 + [tail]),
                     encode_chunked=True, headers={"Transfer-Encoding": "chunked"})
        r = conn.getresponse()
        assert r.status == 413 and "error" in json.loads(r.read())
        assert r.getheader("Connection") == "close"
        conn.close()
    for _ in range(10):
        with socket.create_connection(("127.0.0.1", port_server), timeout=30) as s:
            s.sendall(b"POST /api/upload HTTP/1.1\r\nHost: t\r\n"
                      b"Transfer-Encoding: chunked\r\n\r\nzz\r\n" + tail)
            assert s.makefile("rb").readline().startswith(b"HTTP/1.1 400 ")


def test_keep_alive_serves_two_requests_on_one_connection(port_server):
    conn = http.client.HTTPConnection("127.0.0.1", port_server, timeout=30)
    conn.request("POST", "/api/upload", body=json.dumps(
        {"owner": "a", "category": "c", "documents": FRUIT_DOCS}))
    r = conn.getresponse()
    assert r.status == 200 and r.getheader("Connection") == "keep-alive"
    r.read()
    sock = conn.sock
    conn.request("POST", "/api/categories", body=b'{"owner": "a"}')
    r = conn.getresponse()
    assert conn.sock is sock  # the same connection
    assert json.loads(r.read()) == {"category_names": ["c"]}
    conn.close()


def test_chunked_request_body(port_server):
    raw = json.dumps({"owner": "a", "category": "c", "documents": FRUIT_DOCS}).encode()
    conn = http.client.HTTPConnection("127.0.0.1", port_server, timeout=30)
    conn.request("POST", "/api/upload", body=iter([raw[:10], raw[10:50], raw[50:]]),
                 encode_chunked=True, headers={"Transfer-Encoding": "chunked"})
    r = conn.getresponse()
    assert r.status == 200 and json.loads(r.read()) == {"document_ids": [1, 2, 3]}
    conn.close()


def test_pipelined_requests_are_answered_in_order(port_server):
    """Two requests in one write: the second waits in the buffer while the
    first is served (the disconnect watcher reads it) and is answered
    after it."""
    up = json.dumps({"owner": "a", "category": "c", "documents": FRUIT_DOCS}).encode()
    cats = b'{"owner": "a"}'
    with socket.create_connection(("127.0.0.1", port_server)) as s:
        s.sendall(b"POST /api/upload HTTP/1.1\r\nHost: t\r\nContent-Length: %d\r\n\r\n%s"
                  b"POST /api/categories HTTP/1.1\r\nHost: t\r\nContent-Length: %d\r\n\r\n%s"
                  % (len(up), up, len(cats), cats))
        f = s.makefile("rb")

        class Shared:
            """One buffered reader for both responses (a response closes
            its file when its body is read)."""

            readline, read, readinto = f.readline, f.read, f.readinto

            def close(self):
                pass

        class Sock:
            def makefile(self, *a, **k):
                return Shared()

        bodies = []
        for _ in range(2):
            r = http.client.HTTPResponse(Sock())
            r.begin()
            bodies.append(json.loads(r.read()))
    assert bodies == [{"document_ids": [1, 2, 3]}, {"category_names": ["c"]}]


def test_decompressed_body_is_capped(monkeypatch, port_server):
    monkeypatch.setattr(port_http, "MAX_DECOMPRESSED", 4096)
    docs = [{"name": f"d{i}", "document": {"text": "x" * 100}} for i in range(100)]
    payload = compress(json.dumps({"owner": "a", "category": "c", "documents": docs}).encode())
    r = request(port_server, "POST", "/api/upload", data=payload,
                headers={"Content-Encoding": "zstd"})
    assert r["status"] == 400


def test_unknown_path_is_404_with_wasm_headers(port_server):
    r = request(port_server, "GET", "/nowhere")
    assert r["status"] == 404 and r["cross-origin-opener-policy"] == "same-origin"
