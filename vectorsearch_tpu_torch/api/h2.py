"""HTTP/2 on the TLS listener (reference: main.go:104-115 configures h2
with NextProtos ["h2", "http/1.1"]). A copy of vectorsearch_tpu/api/h2.py
whose gateway hop speaks HTTP/1.1 over asyncio streams (api/http.py's
framing) instead of an aiohttp client.

No HTTP/2 library is installed in this image, so this module implements
the server side of RFC 7540 directly — connection preface, SETTINGS,
HEADERS/CONTINUATION, DATA with both-direction flow control, PING,
RST_STREAM, GOAWAY — with HPACK (RFC 7541) delegated via ctypes to the
system's battle-tested libnghttp2 (the same codec curl/nghttp2 use; its
header-compression API is public and stable).

Architecture: the TLS port is an ALPN mux in front of the SAME app the
plaintext listener serves:

    TLS accept -> ALPN "h2"       -> H2Connection: each stream becomes an
                                     in-process request to the plaintext
                                     listener (loopback), response DATA
                                     streamed back under flow control
               -> "http/1.1"/none -> transparent byte pipe to the
                                     plaintext listener

so every route, middleware, and streaming behaviour (chat chunks, zstd)
is identical across protocols. The gateway hop is a loopback socket
(~tens of µs) — negligible next to a device dispatch.
"""
from __future__ import annotations

import asyncio
import ctypes
import struct

from ..logger import sugar
from . import http

# ---- frame types (RFC 7540 §6) ----
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE = range(6)
PING, GOAWAY, WINDOW_UPDATE, CONTINUATION = 6, 7, 8, 9

FLAG_ACK = 0x1
FLAG_END_STREAM = 0x1
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5
SETTINGS_MAX_CONCURRENT_STREAMS = 0x3

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
DEFAULT_WINDOW = 65535
MAX_FRAME = 16384
MAX_BODY = 256 * 1024 * 1024  # mirror the h1 listener's client_max_size
# header-block cap: DATA is bounded by MAX_BODY, but an endless
# HEADERS+CONTINUATION fragment stream would grow _hdr_frag without limit
# (one malicious TLS client could OOM a 15 GB-RSS serving process).
# Exceeding it raises -> connection torn down by the frame loop.
MAX_HEADER_BLOCK = 1024 * 1024

# ---- HPACK via libnghttp2 (public nghttp2_hd_* API) ----

_NGHTTP2 = None


class _NV(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.POINTER(ctypes.c_uint8)),
        ("value", ctypes.POINTER(ctypes.c_uint8)),
        ("namelen", ctypes.c_size_t),
        ("valuelen", ctypes.c_size_t),
        ("flags", ctypes.c_uint8),
    ]


def _lib():
    global _NGHTTP2
    if _NGHTTP2 is None:
        lib = ctypes.CDLL("libnghttp2.so.14")
        lib.nghttp2_hd_inflate_new.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        lib.nghttp2_hd_inflate_hd2.restype = ctypes.c_ssize_t
        lib.nghttp2_hd_inflate_hd2.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_NV), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t, ctypes.c_int,
        ]
        lib.nghttp2_hd_inflate_end_headers.argtypes = [ctypes.c_void_p]
        lib.nghttp2_hd_inflate_del.argtypes = [ctypes.c_void_p]
        lib.nghttp2_hd_deflate_new.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t,
        ]
        lib.nghttp2_hd_deflate_del.argtypes = [ctypes.c_void_p]
        lib.nghttp2_hd_deflate_bound.restype = ctypes.c_size_t
        lib.nghttp2_hd_deflate_bound.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_NV), ctypes.c_size_t,
        ]
        lib.nghttp2_hd_deflate_hd.restype = ctypes.c_ssize_t
        lib.nghttp2_hd_deflate_hd.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(_NV), ctypes.c_size_t,
        ]
        _NGHTTP2 = lib
    return _NGHTTP2


def hpack_available() -> bool:
    try:
        _lib()
        return True
    except OSError:
        return False


class HpackCodec:
    """Per-connection HPACK inflater + deflater."""

    _INFLATE_EMIT = 0x02
    _INFLATE_FINAL = 0x01

    def __init__(self):
        lib = _lib()
        self._inf = ctypes.c_void_p()
        if lib.nghttp2_hd_inflate_new(ctypes.byref(self._inf)) != 0:
            raise RuntimeError("nghttp2_hd_inflate_new failed")
        self._def = ctypes.c_void_p()
        if lib.nghttp2_hd_deflate_new(ctypes.byref(self._def), 4096) != 0:
            raise RuntimeError("nghttp2_hd_deflate_new failed")

    def __del__(self):
        try:
            lib = _lib()
            if self._inf:
                lib.nghttp2_hd_inflate_del(self._inf)
            if self._def:
                lib.nghttp2_hd_deflate_del(self._def)
        except Exception:
            pass

    def decode(self, block: bytes) -> list[tuple[bytes, bytes]]:
        lib = _lib()
        buf = (ctypes.c_uint8 * len(block)).from_buffer_copy(block)
        pos, out = 0, []
        nv = _NV()
        flags = ctypes.c_int(0)
        while True:
            flags.value = 0
            consumed = lib.nghttp2_hd_inflate_hd2(
                self._inf, ctypes.byref(nv), ctypes.byref(flags),
                ctypes.cast(
                    ctypes.byref(buf, pos), ctypes.POINTER(ctypes.c_uint8)
                ),
                len(block) - pos, 1,
            )
            if consumed < 0:
                raise ValueError(f"HPACK error {consumed}")
            pos += consumed
            if flags.value & self._INFLATE_EMIT:
                out.append(
                    (
                        ctypes.string_at(nv.name, nv.namelen),
                        ctypes.string_at(nv.value, nv.valuelen),
                    )
                )
            if flags.value & self._INFLATE_FINAL:
                lib.nghttp2_hd_inflate_end_headers(self._inf)
                break
            if consumed == 0 and not (flags.value & self._INFLATE_EMIT):
                raise ValueError("HPACK stall")
        return out

    def encode(self, headers: list[tuple[bytes, bytes]]) -> bytes:
        lib = _lib()
        nva = (_NV * len(headers))()
        keep = []  # keep ctypes buffers alive
        for i, (k, v) in enumerate(headers):
            kb = ctypes.create_string_buffer(k, len(k))
            vb = ctypes.create_string_buffer(v, len(v))
            keep.extend((kb, vb))
            nva[i].name = ctypes.cast(kb, ctypes.POINTER(ctypes.c_uint8))
            nva[i].value = ctypes.cast(vb, ctypes.POINTER(ctypes.c_uint8))
            nva[i].namelen = len(k)
            nva[i].valuelen = len(v)
            nva[i].flags = 0
        bound = lib.nghttp2_hd_deflate_bound(self._def, nva, len(headers))
        out = (ctypes.c_uint8 * bound)()
        n = lib.nghttp2_hd_deflate_hd(self._def, out, bound, nva, len(headers))
        if n < 0:
            raise ValueError(f"HPACK deflate error {n}")
        return bytes(out[:n])


# ---- one h2 connection ----


class _Stream:
    __slots__ = ("sid", "headers", "body", "end_stream", "window", "window_ev")

    def __init__(self, sid: int, initial_window: int):
        self.sid = sid
        self.headers: list[tuple[bytes, bytes]] = []
        self.body = bytearray()
        self.end_stream = False
        self.window = initial_window
        self.window_ev = asyncio.Event()


class H2Connection:
    """Serves one client connection; gateways streams to `upstream`."""

    def __init__(self, reader, writer, upstream: tuple[str, int]):
        self.r = reader
        self.w = writer
        self.upstream = upstream
        self.hpack = HpackCodec()
        self.conn_window = DEFAULT_WINDOW
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = MAX_FRAME
        self.conn_window_ev = asyncio.Event()
        self.streams: dict[int, _Stream] = {}
        self.tasks: dict[int, asyncio.Task] = {}
        self._wlock = asyncio.Lock()
        self._max_sid = 0  # highest client stream id seen (trailer detect)
        self._hdr_stream: int | None = None  # CONTINUATION state
        self._hdr_frag = bytearray()
        self._hdr_end_stream = False
        self._hdr_trailer = False

    async def _send(self, ftype: int, flags: int, sid: int, payload: bytes = b""):
        async with self._wlock:
            self.w.write(
                struct.pack("!I", len(payload))[1:]
                + bytes((ftype, flags))
                + struct.pack("!I", sid & 0x7FFFFFFF)
                + payload
            )
            await self.w.drain()

    async def run(self):
        try:
            preface = await self.r.readexactly(len(PREFACE))
            if preface != PREFACE:
                return
            await self._send(
                SETTINGS, 0, 0,
                struct.pack("!HI", SETTINGS_MAX_CONCURRENT_STREAMS, 256),
            )
            while True:
                head = await self.r.readexactly(9)
                length = int.from_bytes(head[:3], "big")
                ftype, flags = head[3], head[4]
                sid = int.from_bytes(head[5:9], "big") & 0x7FFFFFFF
                payload = await self.r.readexactly(length) if length else b""
                if not await self._frame(ftype, flags, sid, payload):
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except Exception as e:
            sugar().warning("h2 connection error: %s", e)
        finally:
            for t in self.tasks.values():
                t.cancel()
            self.w.close()

    async def _frame(self, ftype, flags, sid, payload) -> bool:
        if self._hdr_stream is not None and ftype != CONTINUATION:
            raise ValueError("expected CONTINUATION")
        if ftype == SETTINGS:
            if flags & FLAG_ACK:
                return True
            for off in range(0, len(payload), 6):
                ident, value = struct.unpack_from("!HI", payload, off)
                if ident == SETTINGS_INITIAL_WINDOW_SIZE:
                    delta = value - self.peer_initial_window
                    self.peer_initial_window = value
                    for st in self.streams.values():
                        st.window += delta
                        st.window_ev.set()
                elif ident == SETTINGS_MAX_FRAME_SIZE:
                    self.peer_max_frame = max(
                        MAX_FRAME, min(value, (1 << 24) - 1)
                    )
            await self._send(SETTINGS, FLAG_ACK, 0)
        elif ftype == WINDOW_UPDATE:
            (inc,) = struct.unpack("!I", payload)
            inc &= 0x7FFFFFFF
            if sid == 0:
                self.conn_window += inc
                self.conn_window_ev.set()
            elif sid in self.streams:
                self.streams[sid].window += inc
                self.streams[sid].window_ev.set()
        elif ftype == HEADERS:
            frag = payload
            pad = 0
            if flags & FLAG_PADDED:
                pad = frag[0]
                frag = frag[1:]
            if flags & FLAG_PRIORITY:
                frag = frag[5:]
            if pad:
                frag = frag[:-pad]
            # HEADERS for a sid we've already seen but no longer track are
            # trailers for a stream WE reset (e.g. oversize body) — the
            # HPACK state must still be consumed, but no new stream may be
            # created for them (a ghost stream would dispatch a spurious
            # upstream request)
            self._hdr_trailer = sid in self.streams or sid <= self._max_sid
            self._max_sid = max(self._max_sid, sid)
            if not self._hdr_trailer:
                self.streams[sid] = _Stream(sid, self.peer_initial_window)
            self._hdr_stream = sid
            self._hdr_frag = bytearray(frag)
            if len(self._hdr_frag) > MAX_HEADER_BLOCK:
                raise ValueError("header block exceeds MAX_HEADER_BLOCK")
            self._hdr_end_stream = bool(flags & FLAG_END_STREAM)
            if flags & FLAG_END_HEADERS:
                self._headers_done()
        elif ftype == CONTINUATION:
            if self._hdr_stream != sid:
                raise ValueError("CONTINUATION on wrong stream")
            self._hdr_frag.extend(payload)
            if len(self._hdr_frag) > MAX_HEADER_BLOCK:
                raise ValueError("header block exceeds MAX_HEADER_BLOCK")
            if flags & FLAG_END_HEADERS:
                self._headers_done()
        elif ftype == DATA:
            st = self.streams.get(sid)
            data = payload
            if flags & FLAG_PADDED:
                pad = data[0]
                data = data[1 : len(data) - pad]
            reset = False
            if st is not None:
                st.body.extend(data)
                if len(st.body) > MAX_BODY:
                    await self._send(
                        RST_STREAM, 0, sid, struct.pack("!I", 0xB)
                    )  # ENHANCE_YOUR_CALM
                    self.streams.pop(sid, None)
                    reset = True  # never dispatch the oversize body
                elif flags & FLAG_END_STREAM:
                    st.end_stream = True
                    self._dispatch(st)
            # replenish both windows (we buffer whole bodies like the h1
            # app). The CONNECTION window must be replenished even on the
            # reset path — skipping it leaks connection flow-control
            # window and eventually wedges every stream on the connection.
            if payload:
                inc = struct.pack("!I", len(payload))
                await self._send(WINDOW_UPDATE, 0, 0, inc)
                if not reset and st is not None:
                    await self._send(WINDOW_UPDATE, 0, sid, inc)
        elif ftype == PING:
            if not flags & FLAG_ACK:
                await self._send(PING, FLAG_ACK, 0, payload)
        elif ftype == RST_STREAM:
            task = self.tasks.pop(sid, None)
            if task:
                task.cancel()
            self.streams.pop(sid, None)
        elif ftype == GOAWAY:
            return False
        # PRIORITY / PUSH_PROMISE / unknown: ignore
        return True

    def _headers_done(self):
        sid = self._hdr_stream
        self._hdr_stream = None
        decoded = self.hpack.decode(bytes(self._hdr_frag))
        if self._hdr_trailer:
            # Trailers: HPACK state consumed, content ignored — but the
            # END_STREAM flag rides the trailer HEADERS (RFC 7540 §8.1),
            # so the request must dispatch here, not on a DATA frame.
            st = self.streams.get(sid)
            if st is not None and self._hdr_end_stream and not st.end_stream:
                st.end_stream = True
                self._dispatch(st)
            return
        st = self.streams[sid]
        st.headers = decoded
        if self._hdr_end_stream:
            st.end_stream = True
            self._dispatch(st)

    def _dispatch(self, st: _Stream):
        self.tasks[st.sid] = asyncio.ensure_future(self._handle(st))

    async def _wait_window(self, st: _Stream):
        while self.conn_window <= 0 or st.window <= 0:
            ev = self.conn_window_ev if self.conn_window <= 0 else st.window_ev
            ev.clear()
            await ev.wait()

    async def _send_data(self, st: _Stream, chunk: bytes, end: bool):
        view = memoryview(chunk)
        while view:
            await self._wait_window(st)
            n = min(len(view), self.peer_max_frame, self.conn_window, st.window)
            self.conn_window -= n
            st.window -= n
            last = end and n == len(view)
            await self._send(
                DATA, FLAG_END_STREAM if last else 0, st.sid, bytes(view[:n])
            )
            view = view[n:]
        if end and not chunk:
            await self._send(DATA, FLAG_END_STREAM, st.sid)

    async def _handle(self, st: _Stream):
        """Gateway one stream to the plaintext listener."""
        try:
            h = dict(st.headers)
            method = h.get(b":method", b"GET").decode()
            path = h.get(b":path", b"/").decode()
            # h2 clients may split cookies into one field per crumb
            # (RFC 7540 §8.1.2.5); rejoin with "; " for the h1 upstream.
            fwd: dict[str, str] = {}
            cookies: list[str] = []
            for k, v in st.headers:
                if k.startswith(b":") or k in (b"connection", b"te"):
                    continue
                if k == b"cookie":
                    cookies.append(v.decode("latin-1"))
                else:
                    fwd[k.decode("latin-1")] = v.decode("latin-1")
            if cookies:
                fwd["cookie"] = "; ".join(cookies)
            host, port = self.upstream
            up_r, up_w = await asyncio.open_connection(host, port)
            try:
                # one request per upstream connection, framed by length
                head = [f"{method} {path} HTTP/1.1", f"Host: {host}:{port}",
                        "Connection: close", f"Content-Length: {len(st.body)}"]
                head += [f"{k}: {v}" for k, v in fwd.items()
                         if k not in ("host", "content-length", "transfer-encoding")]
                up_w.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
                           + bytes(st.body))
                await up_w.drain()
                up = http.BufferedReader(up_r)
                start, resp_headers = await http.read_head(up)
                status = int(start.split(" ", 2)[1])
                out = [(b":status", str(status).encode())]
                for k, v in resp_headers:
                    if k in ("connection", "transfer-encoding", "keep-alive",
                             "upgrade", "proxy-connection"):
                        continue
                    out.append((k.encode("latin-1"), v.encode("latin-1")))
                block = self.hpack.encode(out)
                await self._send(HEADERS, FLAG_END_HEADERS, st.sid, block)
                if method != "HEAD" and status not in (204, 304):
                    async for chunk in http.iter_body(
                        up, dict(resp_headers), to_eof=True
                    ):
                        await self._send_data(st, chunk, end=False)
                await self._send_data(st, b"", end=True)
            finally:
                up_w.close()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            sugar().warning("h2 stream %d failed: %s", st.sid, e)
            try:
                await self._send(RST_STREAM, 0, st.sid, struct.pack("!I", 0x2))
            except Exception:
                pass
        finally:
            self.streams.pop(st.sid, None)
            self.tasks.pop(st.sid, None)


async def _pipe(reader, writer, close=True):
    """Copy reader to writer until EOF; then close the writer unless the
    caller keeps it."""
    try:
        while True:
            data = await reader.read(65536)
            if not data:
                break
            writer.write(data)
            await writer.drain()
    except (ConnectionError, asyncio.CancelledError):
        pass
    finally:
        if close:
            try:
                writer.close()
            except Exception:
                pass


class TLSMux:
    """The TLS listener and the connections it has open."""

    def __init__(self):
        self.server: asyncio.Server | None = None
        self.conns: set[asyncio.Task] = set()

    async def close(self) -> None:
        """Stop listening and close every open connection."""
        self.server.close()
        for task in list(self.conns):
            task.cancel()
        await asyncio.gather(*self.conns, return_exceptions=True)
        await self.server.wait_closed()


async def serve_tls_mux(host, port, ssl_context, upstream: tuple[str, int]):
    """TLS listener that ALPN-muxes h2 to H2Connection and everything else
    through a transparent byte pipe to the plaintext listener. Returns a
    TLSMux; its close() ends the open connections too."""
    mux = TLSMux()

    async def on_conn(reader, writer):
        task = asyncio.current_task()
        mux.conns.add(task)
        try:
            ssl_obj = writer.get_extra_info("ssl_object")
            proto = ssl_obj.selected_alpn_protocol() if ssl_obj else None
            if proto == "h2":
                await H2Connection(reader, writer, upstream).run()
                return
            # http/1.1 (or no ALPN): transparent pipe to the plaintext app
            try:
                up_r, up_w = await asyncio.open_connection(*upstream)
            except OSError:
                writer.close()
                return
            # when the app ends its answers (it half-closes and lingers
            # after a 413 or a 400), what the client still sends goes on to
            # the app for as long as it lingers: TLS has no half-close, and
            # closing here at once would cost the client the answer
            to_app = asyncio.ensure_future(_pipe(reader, up_w))
            from_app = asyncio.ensure_future(_pipe(up_r, writer, close=False))
            try:
                await asyncio.wait({from_app})
                await asyncio.wait({to_app}, timeout=http.LINGER_S)
            finally:
                to_app.cancel()
                from_app.cancel()
                writer.close()
        finally:
            mux.conns.discard(task)

    mux.server = await asyncio.start_server(on_conn, host, port, ssl=ssl_context)
    return mux
