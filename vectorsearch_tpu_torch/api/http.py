"""HTTP API of the port (counterpart of vectorsearch_tpu/api/http.py), on
asyncio from the standard library.

Routes (reference main.go:168-178), the same as the JAX app's:
  POST|GET /api/search            -> {"documents": [...]} (or "results")
  POST     /api/upload            -> {"document_ids": [...]}
  POST|GET /api/chat              -> chunked text/plain stream
  POST|GET /api/categories        -> {"category_names": [...]}
  POST|DELETE /api/delete/owner | /api/delete/category | /api/delete/document
  GET      /, /doctools.js, /api, /api/openapi.yml (static), /api/stats

`build_app(engine)` returns the router, a coroutine function from
`Request` to `Response`; `HTTPServer` serves it over HTTP/1.1 (keep-alive,
Content-Length and chunked request bodies, `Expect: 100-continue`), and
the TLS listener (api/h2.py) reaches it through that server.

Behaviour kept from the JAX app: COOP/COEP headers on every response,
streaming zstd request decompression with a cap on the expansion, zstd
responses on upload, search and the static routes, 405 with Allow, 400 on
bad JSON or a non-object body, 500 with {"error": ...}, and a client that
goes away mid-request cancels the handler, which sets the engine's cancel
event so the engine never dispatches for a dead client. Engine calls are
synchronous (device-bound), so they run in the default thread executor.
A body over MAX_BODY is refused with 413; after it, and after the 400 of
a malformed message, the connection is closed lingeringly (`_linger`), so
a client that is still sending the body reads the answer.
"""
from __future__ import annotations

import asyncio
import contextvars
import http
import json
import os
import threading
import time
from urllib.parse import unquote

from .. import constants
from ..engine.engine import RequestCanceled
from ..logger import next_txid, sugar
from ..store.db import HAVE_ZSTD
from ..store.db import compress as zstd_compress
from ..utils import device_memory_stats, profiling

STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")

MAX_BODY = 256 * 1024 * 1024  # the JAX app's client_max_size
# zip-bomb guard on streamed request decompression
MAX_DECOMPRESSED = 1 << 30
MAX_HEAD = 64 * 1024  # request or status line plus headers
KEEPALIVE_S = 75.0  # idle time before a kept-alive connection is closed
# lingering close after an error answered with the body half read: the rest
# is read and dropped for at most this long and this many bytes, so that a
# client still sending reads the answer and not a reset
LINGER_S = 2.0
LINGER_BYTES = 4 * MAX_BODY
_READ = 1 << 16

WASM_HEADERS = {
    # what lets pdfjs/WASM run in the browser UI (SharedArrayBuffer
    # isolation), on every response (reference main.go:117-125)
    "Cross-Origin-Opener-Policy": "same-origin",
    "Cross-Origin-Embedder-Policy": "require-corp",
}


class Request:
    """A parsed request; header names are lower case."""

    __slots__ = ("method", "path", "version", "headers", "body")

    def __init__(self, method, path, version, headers, body=b""):
        self.method = method
        self.path = path
        self.version = version
        self.headers = headers
        self.body = body


class Response:
    """A response: a whole `body`, or `stream`, an async iterator of byte
    chunks sent with chunked transfer encoding."""

    __slots__ = ("status", "headers", "body", "stream")

    def __init__(self, status=200, body=b"", content_type=None, headers=None,
                 stream=None):
        self.status = status
        self.headers = dict(headers or {})
        if content_type:
            self.headers["Content-Type"] = content_type
        self.body = body
        self.stream = stream


class BodyTooLarge(ValueError):
    pass


class BadMessage(ValueError):
    pass


# ---------------------------------------------------------------- HTTP/1.1
# framing, shared by the server and the h2 gateway's upstream client


class BufferedReader:
    """A StreamReader with a buffer of its own, so that bytes read ahead
    (the disconnect watcher reads pipelined requests) are not lost."""

    def __init__(self, reader: asyncio.StreamReader):
        self.reader = reader
        self.buf = bytearray()

    async def fill(self) -> bool:
        """Read more into the buffer; False at EOF."""
        data = await self.reader.read(_READ)
        self.buf += data
        return bool(data)

    async def readuntil(self, sep: bytes, limit: int) -> bytes:
        start = 0
        while True:
            i = self.buf.find(sep, start)
            if i >= 0:
                out = bytes(self.buf[: i + len(sep)])
                del self.buf[: i + len(sep)]
                return out
            if len(self.buf) > limit:
                raise BadMessage("header section too large")
            start = max(0, len(self.buf) - len(sep) + 1)
            if not await self.fill():
                raise asyncio.IncompleteReadError(bytes(self.buf), None)

    async def readexactly(self, n: int) -> bytes:
        if len(self.buf) >= n:
            out = bytes(self.buf[:n])
            del self.buf[:n]
            return out
        out = bytes(self.buf) + await self.reader.readexactly(n - len(self.buf))
        self.buf.clear()
        return out

    async def readsome(self) -> bytes:
        """What is buffered, or the next read; b"" at EOF."""
        if not self.buf and not await self.fill():
            return b""
        out = bytes(self.buf)
        self.buf.clear()
        return out


def _parse_headers(lines: list[bytes]) -> list[tuple[str, str]]:
    out = []
    for line in lines:
        name, sep, value = line.decode("latin-1").partition(":")
        if not sep or not name or name != name.strip():
            raise BadMessage(f"malformed header line {line[:64]!r}")
        out.append((name.lower(), value.strip()))
    return out


async def read_head(reader: BufferedReader) -> tuple[str, list[tuple[str, str]]]:
    """The start line and the headers (names in lower case) of one
    message."""
    raw = await reader.readuntil(b"\r\n\r\n", MAX_HEAD)
    lines = raw[:-4].split(b"\r\n")
    return lines[0].decode("latin-1"), _parse_headers(lines[1:])


async def iter_chunked(reader: BufferedReader):
    """The chunks of a chunked body (RFC 9112 §7.1), trailers consumed."""
    while True:
        line = await reader.readuntil(b"\r\n", MAX_HEAD)
        try:
            size = int(line.split(b";", 1)[0].strip(), 16)
        except ValueError:
            raise BadMessage(f"bad chunk size {line[:32]!r}") from None
        if size < 0:
            raise BadMessage("negative chunk size")
        if size == 0:
            while await reader.readuntil(b"\r\n", MAX_HEAD) != b"\r\n":
                pass
            return
        while size:  # in pieces: a huge chunk must not arrive whole
            piece = await reader.readexactly(min(size, _READ))
            size -= len(piece)
            yield piece
        if await reader.readexactly(2) != b"\r\n":
            raise BadMessage("chunk not followed by CRLF")


def body_framing(headers: dict) -> int | str | None:
    """"chunked", a Content-Length, or None when the message has no body
    framing of its own."""
    if "chunked" in headers.get("transfer-encoding", "").lower():
        return "chunked"
    if "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError:
            raise BadMessage("bad Content-Length") from None
        if n < 0:
            raise BadMessage("negative Content-Length")
        return n
    return None


async def iter_body(reader: BufferedReader, headers: dict, to_eof: bool):
    """The body's bytes as they arrive: chunked, Content-Length, or (a
    response without either, `to_eof`) everything up to EOF."""
    framing = body_framing(headers)
    if framing == "chunked":
        async for chunk in iter_chunked(reader):
            yield chunk
    elif framing is not None:
        left = framing
        while left:
            chunk = await reader.readexactly(min(left, _READ))
            left -= len(chunk)
            yield chunk
    elif to_eof:
        while chunk := await reader.readsome():
            yield chunk


def _reason(status: int) -> str:
    if status == 499:
        return "Client Closed Request"
    try:
        return http.HTTPStatus(status).phrase
    except ValueError:
        return "Unknown"


# ---------------------------------------------------------------- the app


def _json_error(status: int, message: str, **headers) -> Response:
    return Response(
        status, json.dumps({"error": message}).encode(),
        "application/json; charset=utf-8", headers,
    )


def _zstd_decompress(raw: bytes) -> bytes:
    """Streaming decompression of a zstd request body (reference:
    zstdRequestReader, main.go:129-146), capped at MAX_DECOMPRESSED."""
    try:
        import zstandard
    except ImportError:
        from ..store.db import decompress

        return decompress(raw)
    dctx = zstandard.ZstdDecompressor().decompressobj()
    parts = []
    total = 0
    view = memoryview(raw)
    # 1 KB slices: one RLE block expands ~4 B -> 128 KB, so a large slice
    # could balloon to gigabytes in one decompress() call before the cap
    # is checked
    for off in range(0, len(view), 1024):
        part = dctx.decompress(view[off : off + 1024])
        total += len(part)
        if total > MAX_DECOMPRESSED:
            raise ValueError("decompressed body too large")
        if part:
            parts.append(part)
    return b"".join(parts)


def _read_json(request: Request) -> dict:
    body = request.body
    if request.headers.get("content-encoding", "").strip().lower() == "zstd":
        body = _zstd_decompress(body)
    if not body:
        return {}
    req = json.loads(body)
    if not isinstance(req, dict):
        # every API body is a JSON object; a bare string/array would hit
        # req.get(...) in handlers and 500 instead of 400
        raise ValueError("request body must be a JSON object")
    return req


def _accepts_zstd(request: Request) -> bool:
    # without zstandard nothing is compressed: never label zlib as zstd
    return HAVE_ZSTD and "zstd" in request.headers.get("accept-encoding", "").lower()


def _json_response(request: Request, obj, compress=None) -> Response:
    """`compress` (build_app's) marks a route whose responses are
    zstd-compressed for a client that accepts it. The span `http.encode`,
    on the event loop's thread."""
    with profiling.span("http.encode"):
        raw = json.dumps(obj).encode("utf-8")
        headers = {}
        if compress is not None and len(raw) > 64 and _accepts_zstd(request):
            raw, headers = compress(raw), {"Content-Encoding": "zstd"}
    return Response(200, raw, "application/json", headers)


def build_app(engine):
    """The request router over `engine` (the port's Engine): an async
    callable from Request to Response, shared by the HTTP/1.1 server and
    the TLS listener."""
    routes = {}
    # store.db's zstd compress (a context per thread); none without zstandard
    compress = zstd_compress if HAVE_ZSTD else None

    def handler(methods, fn, compressible=False):
        async def wrapped(request: Request) -> Response:
            # the span `http.request`; its spans and the engine's carry the
            # txid (utils/profiling.py)
            txid = next_txid()
            token = profiling.TXID.set(txid)
            try:
                with profiling.span("http.request"):
                    return await respond(request, txid)
            finally:
                profiling.TXID.reset(token)

        async def respond(request: Request, txid: int) -> Response:
            if request.method not in methods:
                # RFC 9110 §15.5.6: Allow lists every supported method
                return _json_error(
                    405, "Invalid request method", Allow=", ".join(methods)
                )
            try:
                # the span `http.parse`, on the event loop's thread
                with profiling.span("http.parse"):
                    req = _read_json(request)
            except Exception:
                return _json_error(400, "Invalid request")
            # client-cancel propagation (reference: ctx.Err() checks at
            # every stage, server/search.go:86-91): a disconnect cancels
            # this coroutine; the engine call keeps running on its executor
            # thread, so the cancel event tells it to abort between stages
            cancel = threading.Event()
            t_submit = time.perf_counter()

            def call():
                # the counter `http.queue_s`: the wait for an executor thread
                profiling.count("http.queue_s", time.perf_counter() - t_submit)
                return fn(req, cancel)

            fut = asyncio.get_running_loop().run_in_executor(
                None, contextvars.copy_context().run, call
            )
            try:
                result = await fut
            except asyncio.CancelledError:
                cancel.set()
                # consume the abandoned future's RequestCanceled
                fut.add_done_callback(
                    lambda f: None if f.cancelled() else f.exception()
                )
                sugar().warning("%d request canceled (499)", txid)
                raise
            except RequestCanceled:
                sugar().warning("%d request canceled by engine (499)", txid)
                return _json_error(499, "Client closed request")
            except (ValueError, KeyError, TypeError) as e:
                sugar().warning("%d bad request: %s", txid, e)
                return _json_error(400, "Invalid request")
            except Exception as e:
                sugar().error("%d request failed: %s", txid, e)
                return _json_error(500, "Request failed")
            return _json_response(
                request, result, compress if compressible else None
            )

        return wrapped

    # ---- search (server/search.go:45-112) ----
    def _hit_dict(h):
        return {
            "name": h.name,
            "external_id": h.external_id,
            "document": h.document,
            "document_id": h.document_id,
            "document_similarity": h.similarity,
        }

    def do_search(req, cancel):
        texts = req.get("texts")
        if texts is not None:
            # batched extension: N queries in one request. Must be a JSON
            # array of strings (a bare string would iterate per character),
            # bounded like count is
            if not isinstance(texts, list) or not all(
                isinstance(t, str) for t in texts
            ):
                raise ValueError("texts must be an array of strings")
            if len(texts) > constants.MAX_QUERY_BATCH:
                raise ValueError(
                    f"texts exceeds {constants.MAX_QUERY_BATCH} queries"
                )
            pages = engine.search_many(
                req.get("owner", ""),
                req.get("category", ""),
                texts,
                count=int(req.get("count", 0) or 0) or 1,
                offset=int(req.get("offset", 0) or 0),
                centroids=int(req.get("centroids", 0) or 0),
                include_documents=bool(req.get("include_documents", True)),
                cancel=cancel,
            )
            return {
                "results": [
                    {"documents": [_hit_dict(h) for h in page]}
                    for page in pages
                ]
            }
        hits = engine.search(
            req.get("owner", ""),
            req.get("category", ""),
            req.get("text", ""),
            count=int(req.get("count", 0) or 0) or 1,
            offset=int(req.get("offset", 0) or 0),
            centroids=int(req.get("centroids", 0) or 0),
            cancel=cancel,
        )
        return {"documents": [_hit_dict(h) for h in hits]}

    # ---- upload (server/upload.go:40-108) ----
    def do_upload(req, cancel):
        docs = req.get("documents") or []
        if not isinstance(docs, list) or not all(
            isinstance(d, dict) for d in docs
        ):
            raise ValueError("documents must be an array of objects")
        ids = engine.upload(
            req.get("owner", ""), req.get("category", ""), docs, cancel=cancel
        )
        return {"document_ids": ids}

    # ---- categories (server/fetch.go:27-97) ----
    def do_categories(req, cancel):
        return {"category_names": engine.fetch_category_names(req.get("owner", ""))}

    # ---- deletes (server/delete.go) ----
    def do_delete_owner(req, cancel):
        engine.delete_owner(req.get("owner", ""))
        return {}

    def do_delete_category(req, cancel):
        engine.delete_category(req.get("owner", ""), req.get("category", ""))
        return {}

    def do_delete_document(req, cancel):
        engine.delete_document(
            req.get("owner", ""),
            req.get("category", ""),
            int(req.get("document_id", 0)),
        )
        return {}

    # ---- chat: chunked text stream (server/chat.go:31-106) ----
    async def chat_handler(request: Request) -> Response:
        txid = next_txid()
        if request.method not in ("POST", "GET"):
            return _json_error(405, "Invalid request method", Allow="POST, GET")
        try:
            req = _read_json(request)
        except Exception:
            return Response(400, b"Invalid request", "text/plain; charset=utf-8")

        async def deltas():
            loop = asyncio.get_running_loop()
            try:
                stream = await loop.run_in_executor(
                    None,
                    lambda: engine.chat(
                        req.get("text", ""),
                        prefix=req.get("prefix", ""),
                        history=req.get("history") or [],
                        document_ids=req.get("document_ids") or [],
                        documents=req.get("documents") or [],
                    ),
                )
                it = iter(stream)
                while True:
                    delta = await loop.run_in_executor(None, next, it, None)
                    if delta is None:
                        break
                    yield delta.encode("utf-8")
            except (asyncio.CancelledError, GeneratorExit):
                sugar().warning("%d chat canceled", txid)
                raise
            except Exception as e:
                # the headers are out: the stream just ends
                sugar().error("%d chat failed: %s", txid, e)

        return Response(200, content_type="text/plain; charset=utf-8",
                        stream=deltas())

    # ---- static UI + API docs (reference: static/static.go, ui/) ----
    # compressed like the reference's "/" FileServer route (main.go:178);
    # raw and compressed bytes are computed once
    def static_handler(name: str, ctype: str):
        with open(os.path.join(STATIC_DIR, name), "rb") as f:
            raw = f.read()
        zbody = compress(raw) if compress is not None and len(raw) > 64 else None

        async def serve(request: Request) -> Response:
            if zbody is not None and _accepts_zstd(request):
                return Response(200, zbody, ctype, {"Content-Encoding": "zstd"})
            return Response(200, raw, ctype)

        return serve

    async def stats(request: Request) -> Response:
        loop = asyncio.get_running_loop()
        data = await loop.run_in_executor(None, engine.stats)
        try:
            data["devices"] = device_memory_stats()
        except Exception as e:
            sugar().warning("device memory stats failed: %s", e)
        if profiling.recording():  # the spans and counters (VSTPU_TRACE_DIR)
            data["trace"] = profiling.snapshot()
        return Response(200, json.dumps(data).encode(),
                        "application/json; charset=utf-8")

    for path, fn in (
        ("/api/search", handler(("POST", "GET"), do_search, compressible=True)),
        ("/api/upload", handler(("POST",), do_upload, compressible=True)),
        ("/api/chat", chat_handler),
        ("/api/categories", handler(("POST", "GET"), do_categories)),
        ("/api/delete/owner", handler(("POST", "DELETE"), do_delete_owner)),
        ("/api/delete/category", handler(("POST", "DELETE"), do_delete_category)),
        ("/api/delete/document", handler(("POST", "DELETE"), do_delete_document)),
    ):
        routes[path] = (None, fn)
    for path, fn in (
        ("/", static_handler("index.html", "text/html")),
        ("/doctools.js", static_handler("doctools.js", "application/javascript")),
        ("/api", static_handler("api.html", "text/html")),
        ("/api/openapi.yml", static_handler("openapi.yml", "text/yaml")),
        ("/api/stats", stats),
    ):
        routes[path] = (("GET", "HEAD"), fn)

    async def app(request: Request) -> Response:
        route = routes.get(request.path)
        if route is None:
            resp = Response(404, b"404: Not Found", "text/plain; charset=utf-8")
        elif route[0] is not None and request.method not in route[0]:
            resp = Response(405, b"405: Method Not Allowed",
                            "text/plain; charset=utf-8",
                            {"Allow": ", ".join(route[0])})
        else:
            resp = await route[1](request)
        resp.headers.update(WASM_HEADERS)
        return resp

    return app


# ---------------------------------------------------------------- server


class HTTPServer:
    """HTTP/1.1 server for the router that build_app returns."""

    def __init__(self, app):
        self.app = app
        self._server: asyncio.Server | None = None
        self._conns: set[asyncio.Task] = set()

    async def start(self, host, port: int) -> "HTTPServer":
        self._server = await asyncio.start_server(self._serve_conn, host, port)
        return self

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        """Stop listening and close every connection, idle or busy."""
        self._server.close()
        for task in list(self._conns):
            task.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        await self._server.wait_closed()

    async def _serve_conn(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        conn = BufferedReader(reader)
        try:
            while await self._one_exchange(conn, writer):
                pass
        except (ConnectionError, asyncio.IncompleteReadError, TimeoutError):
            pass
        except Exception as e:
            sugar().error("http connection failed: %s", e)
        finally:
            self._conns.discard(task)
            writer.close()

    async def _one_exchange(self, conn: BufferedReader, writer) -> bool:
        """Serve one request; False when the connection is done."""
        if not conn.buf and not await asyncio.wait_for(conn.fill(), KEEPALIVE_S):
            return False  # the client closed an idle connection
        try:
            start, header_list = await read_head(conn)
            method, target, version = start.split(" ")
            if not version.startswith("HTTP/1."):
                raise BadMessage(f"unsupported version {version!r}")
            headers = {}
            for name, value in header_list:
                headers[name] = f"{headers[name]}, {value}" if name in headers else value
            framing = body_framing(headers)
            if isinstance(framing, int) and framing > MAX_BODY:
                raise BodyTooLarge()
            if framing and headers.get("expect", "").lower() == "100-continue":
                writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            body = bytearray()
            async for chunk in iter_body(conn, headers, to_eof=False):
                body += chunk
                if len(body) > MAX_BODY:
                    raise BodyTooLarge()
        except BodyTooLarge:
            await _write(writer, _json_error(413, "Request body too large"), False, False)
            await _linger(conn, writer)
            return False
        except (BadMessage, ValueError):
            await _write(writer, Response(400, b"Bad Request", "text/plain"), False, False)
            await _linger(conn, writer)
            return False
        keep = _keep_alive(version, headers)
        request = Request(method, unquote(target.split("?", 1)[0]), version,
                          headers, bytes(body))
        handling = asyncio.ensure_future(self._handle(request))
        watching = asyncio.ensure_future(_watch_eof(conn))
        try:
            await asyncio.wait({handling, watching}, return_when=asyncio.FIRST_COMPLETED)
        finally:
            if not handling.done():
                # the client went away mid-request (or the server is
                # shutting down): cancel the handler, which sets the
                # engine's cancel event
                handling.cancel()
            watching.cancel()
            await asyncio.gather(handling, watching, return_exceptions=True)
        if handling.cancelled():
            return False
        resp = handling.result()
        chunked_ok = version != "HTTP/1.0"
        # an HTTP/1.0 client reads a stream to EOF
        keep = keep and (chunked_ok or resp.stream is None)
        await _write(writer, resp, keep, method == "HEAD", chunked_ok)
        return keep

    async def _handle(self, request: Request) -> Response:
        try:
            return await self.app(request)
        except Exception as e:
            sugar().error("handler for %s failed: %s", request.path, e)
            resp = _json_error(500, "Request failed")
            resp.headers.update(WASM_HEADERS)
            return resp


def _keep_alive(version: str, headers: dict) -> bool:
    conn = headers.get("connection", "").lower()
    if version == "HTTP/1.0":
        return "keep-alive" in conn
    return "close" not in conn


async def _linger(conn: BufferedReader, writer) -> None:
    """Lingering close: the answer is flushed and the write side half
    closed, then the client's input is read and dropped until it ends, or
    LINGER_S or LINGER_BYTES have passed. Closing with input unread makes
    the kernel reset the connection, and a client still sending would lose
    the answer it was just sent."""
    try:
        if writer.can_write_eof():
            writer.write_eof()
        conn.buf.clear()
        left = LINGER_BYTES
        async with asyncio.timeout(LINGER_S):
            while left > 0:
                data = await conn.reader.read(_READ)
                if not data:
                    break
                left -= len(data)
    except (TimeoutError, OSError):
        pass


async def _watch_eof(conn: BufferedReader) -> None:
    """Return when the client closes its side; bytes it sends meanwhile (a
    pipelined request) stay in conn's buffer."""
    while len(conn.buf) < MAX_HEAD:
        if not await conn.fill():
            return
    await asyncio.Event().wait()  # enough read ahead: stop watching


async def _write(writer, resp: Response, keep: bool, head_only: bool,
                 chunked_ok: bool = True) -> None:
    headers = dict(resp.headers)
    headers["Connection"] = "keep-alive" if keep else "close"
    streamed = resp.stream is not None
    if streamed and chunked_ok:
        headers["Transfer-Encoding"] = "chunked"
    elif not streamed:
        headers["Content-Length"] = str(len(resp.body))
    head = [f"HTTP/1.1 {resp.status} {_reason(resp.status)}"]
    head += [f"{k}: {v}" for k, v in headers.items()]
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
    if not streamed:
        if not head_only:
            writer.write(resp.body)
        await writer.drain()
        return
    stream = resp.stream
    try:
        await writer.drain()
        if not head_only:
            async for chunk in stream:
                if chunk:
                    writer.write(b"%x\r\n%s\r\n" % (len(chunk), chunk) if chunked_ok else chunk)
                    await writer.drain()
        if chunked_ok:
            writer.write(b"0\r\n\r\n")
            await writer.drain()
    finally:
        await stream.aclose()
