"""The port's HTTP/2 TLS listener (vectorsearch_tpu_torch/api/h2.py): the
cases of tests/test_h2.py against the port's server and Engine, driven by
the system curl (nghttp2-backed) as a real h2 client, and the framing
cases on the port's H2Connection. The gateway hop speaks HTTP/1.1 over
asyncio streams to the plaintext listener."""
import asyncio
import json
import shutil
import socket
import subprocess
import threading

import pytest
import torch

from vectorsearch_tpu_torch.api import h2 as h2mod
from vectorsearch_tpu_torch.engine import Engine, EngineCache
from vectorsearch_tpu_torch.host import Store

from test_engine import WordHashAI

pytestmark = pytest.mark.skipif(
    not h2mod.hpack_available(), reason="libnghttp2 not present"
)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def h2_server():
    from vectorsearch_tpu_torch.config import TLSConfig
    from vectorsearch_tpu_torch.api import TLSManager, build_app
    from vectorsearch_tpu_torch.api.http import HTTPServer

    if shutil.which("curl") is None:
        pytest.skip("curl not present")
    torch.set_num_threads(2)
    store = Store(":memory:")
    engine = Engine(store, WordHashAI(), cache=EngineCache(ttl=60.0), device="cpu")
    engine.upload(
        "o", "c",
        [{"name": "a", "document": {"text": "alpha particle physics"}},
         {"name": "b", "document": {"text": "bravo marching band"}}],
    )
    tls_port = _free_port()
    loop = asyncio.new_event_loop()
    state = {}

    async def boot():
        server = await HTTPServer(build_app(engine)).start("127.0.0.1", 0)
        tls = TLSManager(TLSConfig())
        mux = await h2mod.serve_tls_mux(
            "127.0.0.1", tls_port, tls.context(), ("127.0.0.1", server.port)
        )
        state.update(server=server, mux=mux, tls=tls)

    t = threading.Thread(target=loop.run_forever, daemon=True)
    t.start()
    asyncio.run_coroutine_threadsafe(boot(), loop).result(30)
    yield f"https://127.0.0.1:{tls_port}"

    async def shutdown():
        await state["mux"].close()
        await state["server"].close()

    asyncio.run_coroutine_threadsafe(shutdown(), loop).result(timeout=10)
    loop.call_soon_threadsafe(loop.stop)
    t.join(timeout=10)
    state["tls"].close()
    engine.close()
    store.close()


def _curl(url, *args, timeout=30):
    out = subprocess.run(
        ["curl", "-sk", "-w", "\n%{http_version} %{http_code}", *args, url],
        capture_output=True, text=True, timeout=timeout,
    )
    assert out.returncode == 0, out.stderr
    body, _, tail = out.stdout.rpartition("\n")
    version, code = tail.split()
    return body, version, int(code)


def test_h2_search_roundtrip(h2_server):
    body, version, code = _curl(
        h2_server + "/api/search", "--http2",
        "-X", "POST",
        "-d", '{"owner":"o","category":"c","text":"alpha particle","count":1,"centroids":-1}',
    )
    assert version == "2" and code == 200
    docs = json.loads(body)["documents"]
    assert docs and docs[0]["name"] == "a"


def test_h2_upload_then_search(h2_server):
    body, version, code = _curl(
        h2_server + "/api/upload", "--http2",
        "-X", "POST",
        "-d", '{"owner":"o","category":"c","documents":[{"name":"h2doc","document":{"text":"zulu quantum leap"}}]}',
    )
    assert version == "2" and code == 200
    assert json.loads(body)["document_ids"]
    body, version, code = _curl(
        h2_server + "/api/search", "--http2",
        "-X", "POST",
        "-d", '{"owner":"o","category":"c","text":"zulu quantum leap","count":1,"centroids":-1}',
    )
    assert version == "2"
    assert json.loads(body)["documents"][0]["name"] == "h2doc"


def test_h2_wasm_headers_and_static(h2_server):
    out = subprocess.run(
        ["curl", "-sk", "--http2", "-D-", "-o", "/dev/null", h2_server + "/"],
        capture_output=True, text=True, timeout=30,
    )
    head = out.stdout.lower()
    assert "http/2 200" in head
    assert "cross-origin-opener-policy: same-origin" in head


def test_h2_chat_stream(h2_server):
    body, version, code = _curl(
        h2_server + "/api/chat", "--http2",
        "-X", "POST", "-d", '{"text":"hello"}',
    )
    assert version == "2" and code == 200
    assert body == "chat reply"  # WordHashAI streams it in two chunks


def test_http11_pipe_still_serves(h2_server):
    body, version, code = _curl(
        h2_server + "/api/categories", "--http1.1",
        "-X", "POST", "-d", '{"owner":"o"}',
    )
    assert version == "1.1" and code == 200
    assert json.loads(body) == {"category_names": ["c"]}


def test_http11_pipe_body_over_limit_with_a_long_tail_reads_the_413(
        h2_server, monkeypatch):
    """HTTP/1.1 over TLS reaches the app through a byte pipe: after the
    app's 413 the pipe goes on taking what the client sends, so the client
    reads the answer although it is still sending a 1 MB tail."""
    import http.client
    import ssl

    from vectorsearch_tpu_torch.api import http as port_http

    monkeypatch.setattr(port_http, "MAX_BODY", 1024)
    ctx = ssl.create_default_context()
    ctx.check_hostname, ctx.verify_mode = False, ssl.CERT_NONE
    ctx.set_alpn_protocols(["http/1.1"])
    port = int(h2_server.rsplit(":", 1)[1])
    for _ in range(10):
        conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=30, context=ctx)
        conn.request("POST", "/api/upload",
                     body=iter([b"x" * 700] * 3 + [b"y" * (1 << 20)]),
                     encode_chunked=True, headers={"Transfer-Encoding": "chunked"})
        r = conn.getresponse()
        assert r.status == 413 and "error" in json.loads(r.read())
        conn.close()


def test_h2_concurrent_streams(h2_server):
    import concurrent.futures as cf

    def one(i):
        body, version, code = _curl(
            h2_server + "/api/search", "--http2",
            "-X", "POST",
            "-d", '{"owner":"o","category":"c","text":"bravo marching","count":1,"centroids":-1}',
        )
        return version == "2" and code == 200 and json.loads(body)["documents"][0]["name"] == "b"

    with cf.ThreadPoolExecutor(8) as ex:
        assert all(ex.map(one, range(16)))


# ---- unit-level framing tests (no TLS server; drive _frame directly) ----


class _StubWriter:
    def __init__(self):
        self.sent = bytearray()

    def write(self, data):
        self.sent.extend(data)

    async def drain(self):
        pass

    def close(self):
        pass


def _conn_and_codec(upstream=("127.0.0.1", 1)):
    conn = h2mod.H2Connection(None, _StubWriter(), upstream)
    dispatched = []
    conn._dispatch = lambda st: dispatched.append(st)
    return conn, h2mod.HpackCodec(), dispatched


def _req_block(codec, extra=()):
    return codec.encode(
        [(b":method", b"POST"), (b":path", b"/api/search"),
         (b":scheme", b"https"), (b":authority", b"t"), *extra]
    )


def test_h2_trailers_end_stream_dispatches():
    """END_STREAM riding the trailer HEADERS must dispatch the request."""

    async def run():
        conn, codec, dispatched = _conn_and_codec()
        await conn._frame(
            h2mod.HEADERS, h2mod.FLAG_END_HEADERS, 1, _req_block(codec)
        )
        await conn._frame(h2mod.DATA, 0, 1, b'{"x":1}')
        trailer = codec.encode([(b"x-checksum", b"abc")])
        await conn._frame(
            h2mod.HEADERS,
            h2mod.FLAG_END_HEADERS | h2mod.FLAG_END_STREAM, 1, trailer,
        )
        assert len(dispatched) == 1
        assert bytes(dispatched[0].body) == b'{"x":1}'
        assert dispatched[0].end_stream

    asyncio.run(run())


def test_h2_oversize_body_reset_not_dispatched(monkeypatch):
    """A body over MAX_BODY draws RST_STREAM and must NOT dispatch."""
    monkeypatch.setattr(h2mod, "MAX_BODY", 8)

    async def run():
        conn, codec, dispatched = _conn_and_codec()
        await conn._frame(
            h2mod.HEADERS, h2mod.FLAG_END_HEADERS, 1, _req_block(codec)
        )
        await conn._frame(
            h2mod.DATA, h2mod.FLAG_END_STREAM, 1, b"0123456789abcdef"
        )
        assert dispatched == []
        assert 1 not in conn.streams

    asyncio.run(run())


def test_h2_oversize_reset_replenishes_connection_window(monkeypatch):
    """The reset path still replenishes the CONNECTION window, and a
    trailer for the reset stream creates no ghost stream."""
    monkeypatch.setattr(h2mod, "MAX_BODY", 8)

    async def run():
        conn, codec, dispatched = _conn_and_codec()
        sent = []
        orig_send = conn._send

        async def record(ftype, flags, sid, payload=b""):
            sent.append((ftype, sid))
            await orig_send(ftype, flags, sid, payload)

        conn._send = record
        await conn._frame(
            h2mod.HEADERS, h2mod.FLAG_END_HEADERS, 1, _req_block(codec)
        )
        await conn._frame(h2mod.DATA, 0, 1, b"0123456789abcdef")
        assert (h2mod.RST_STREAM, 1) in sent
        assert (h2mod.WINDOW_UPDATE, 0) in sent  # connection replenished
        assert (h2mod.WINDOW_UPDATE, 1) not in sent  # stream is dead
        trailer = codec.encode([(b"x-sum", b"1")])
        await conn._frame(
            h2mod.HEADERS,
            h2mod.FLAG_END_HEADERS | h2mod.FLAG_END_STREAM, 1, trailer,
        )
        assert 1 not in conn.streams
        assert dispatched == []

    asyncio.run(run())


def test_h2_cookie_crumbs_rejoined():
    """Split cookie fields (RFC 7540 8.1.2.5) reach the HTTP/1.1 upstream
    rejoined with '; '; the gateway frames the body by length."""

    async def run():
        heads = []

        async def upstream(reader, writer):
            head = await reader.readuntil(b"\r\n\r\n")
            heads.append(head.decode("latin-1"))
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\n{}")
            await writer.drain()
            writer.close()

        server = await asyncio.start_server(upstream, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        conn, codec, _ = _conn_and_codec(("127.0.0.1", port))
        block = _req_block(
            codec, extra=[(b"cookie", b"a=1"), (b"cookie", b"b=2")]
        )
        await conn._frame(
            h2mod.HEADERS,
            h2mod.FLAG_END_HEADERS | h2mod.FLAG_END_STREAM, 1, block,
        )
        await conn._handle(conn.streams[1])
        server.close()
        await server.wait_closed()
        lines = heads[0].lower().split("\r\n")
        assert "cookie: a=1; b=2" in lines
        assert lines[0] == "post /api/search http/1.1"
        assert "content-length: 0" in lines
        assert conn.w.sent  # HEADERS + DATA went back to the client

    asyncio.run(run())
