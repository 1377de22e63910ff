"""HTTP/1.1 on asyncio streams: the port's one reader and writer.

The machine with the card has no aiohttp, so every HTTP surface of the port
(the control plane's API and proxy in ``server/app.py``, the engine serve
layers ``engine/llm_serve.py`` and ``engine/echo.py``, the engines' store
client) speaks through this module, on the standard library:

- the server reads one request per connection (request line, headers, a
  ``Content-Length`` or chunked body) and answers it with ``Connection:
  close``: a JSON document, raw bytes, or a stream (``Stream``: the status
  line goes out with the first write; to an HTTP/1.1 request the body is
  framed ``Transfer-Encoding: chunked``, one chunk per write and a last
  chunk when the handler returns, as aiohttp's ``StreamResponse`` frames
  it, so a reader that takes a body only by length or chunks — the C++
  front door, ``native/dataplane.cc`` — reads it whole; to HTTP/1.0 it
  runs until the connection closes);
- the client sends one request per connection and reads a
  ``Content-Length``, chunked or read-to-close body; ``open_stream``
  hands back the reader of a streamed response instead, and ``BodyReader``
  takes its body piece by piece, chunk by chunk when it is chunked.

Header names keep their case and match without it (``Headers``). A client
that hangs up is seen as end of file on the connection (``hangup``); one
that half-closes its side after sending a request would look the same.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable
from urllib.parse import parse_qsl, urlsplit

MAX_BODY = 16 << 20
REASONS = {
    200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
    400: "Bad Request", 401: "Unauthorized", 403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 409: "Conflict", 410: "Gone", 411: "Length Required",
    413: "Payload Too Large", 429: "Too Many Requests", 499: "Client Closed Request",
    500: "Internal Server Error", 501: "Not Implemented", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
}
JSON_TYPE = "application/json; charset=utf-8"
CONNECT_TIMEOUT_S = 10.0  # the reference proxy's sock_connect


class ServerDisconnected(Exception):
    """The server closed or reset the connection before its response was
    whole (aiohttp's ``ServerDisconnectedError``): unlike a refused
    connection, the request may have run."""


class Headers(dict):
    """Header mapping that keeps each name as sent and matches it without
    case (``h.get("content-type")`` finds ``Content-Type``)."""

    def __init__(self, items: Any = ()) -> None:
        super().__init__()
        self._names: dict[str, str] = {}
        for k, v in (items.items() if hasattr(items, "items") else items):
            self[k] = v

    def __setitem__(self, key: str, value: str) -> None:
        old = self._names.get(key.lower())
        if old is not None and old != key:
            super().__delitem__(old)
        self._names[key.lower()] = key
        super().__setitem__(key, value)

    def __getitem__(self, key: str) -> str:
        return super().__getitem__(self._names[key.lower()])

    def __contains__(self, key: object) -> bool:
        return isinstance(key, str) and key.lower() in self._names

    def __delitem__(self, key: str) -> None:
        super().__delitem__(self._names.pop(key.lower()))

    def get(self, key: str, default: Any = None) -> Any:
        name = self._names.get(key.lower())
        return default if name is None else super().__getitem__(name)

    def pop(self, key: str, *default: Any) -> Any:
        name = self._names.pop(key.lower(), None)
        if name is None:
            if default:
                return default[0]
            raise KeyError(key)
        return super().pop(name)


@dataclass
class Request:
    method: str
    path: str
    headers: Headers
    body: bytes
    query_string: str = ""
    remote: str = ""
    # path parameters filled in by the router that matched the request
    match_info: dict[str, str] = field(default_factory=dict)
    # the connection, for a handler that streams its answer or watches for
    # the client hanging up (None for a request built in process)
    reader: asyncio.StreamReader | None = None
    stream: "Stream | None" = None
    version: str = "HTTP/1.1"

    def __post_init__(self) -> None:
        if not isinstance(self.headers, Headers):
            self.headers = Headers(self.headers)

    @property
    def query(self) -> dict[str, str]:
        return dict(parse_qsl(self.query_string, keep_blank_values=True))

    def json(self) -> Any:
        """The body as JSON; raises ValueError when malformed."""
        return json.loads(self.body or b"null")

    def hangup(self) -> asyncio.Task:
        """A task that completes when the client closes its side."""
        return hangup(self.reader)


@dataclass
class Response:
    status: int
    doc: Any = None
    headers: dict[str, str] | None = None
    # a raw body wins over ``doc``; ``content_type`` labels it
    body: bytes | None = None
    content_type: str = JSON_TYPE
    # the handler wrote the response itself (a ``Stream``)
    streamed: bool = False


STREAMED = Response(200, streamed=True)


def hangup(reader: asyncio.StreamReader) -> asyncio.Task:
    async def until_eof() -> None:
        with contextlib.suppress(ConnectionError):
            while await reader.read(4096):
                pass

    return asyncio.ensure_future(until_eof())


def _head(status: int, headers: dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {REASONS.get(status, 'Unknown')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class Stream:
    """One connection's streamed answer. The status line and headers go out
    with the first write (so a handler that fails before it can still
    answer with a plain ``Response``); every write is drained before the
    next. ``chunked``: each write is one chunk (an empty write sends the
    head alone) and ``finish`` sends the last chunk; otherwise the body
    ends when the connection closes."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, chunked: bool = False):
        self._reader = reader
        self._writer = writer
        self.chunked = chunked
        self.started = False
        self.finished = False
        self.status = 200
        self.headers: dict[str, str] = {}

    async def write(self, data: bytes) -> None:
        if not self.started:
            self.started = True
            head = {**self.headers, "Connection": "close"}
            if self.chunked:
                head["Transfer-Encoding"] = "chunked"
            self._writer.write(_head(self.status, head))
        if self.chunked:
            if data:  # an empty chunk would end the body
                self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
        else:
            self._writer.write(data)
        await self._writer.drain()

    async def finish(self) -> None:
        """End a started chunked body (the last chunk); nothing otherwise."""
        if self.started and self.chunked and not self.finished:
            self.finished = True
            self._writer.write(b"0\r\n\r\n")
            await self._writer.drain()

    def hangup(self) -> asyncio.Task:
        return hangup(self._reader)


def encode_response(resp: Response) -> bytes:
    body = resp.body if resp.body is not None else json.dumps(resp.doc).encode()
    head = {"Content-Type": resp.content_type, "Content-Length": str(len(body)), "Connection": "close"}
    for k, v in (resp.headers or {}).items():
        if k.lower() not in ("content-length", "connection", "transfer-encoding"):
            head[k] = v
    return _head(resp.status, head) + body


async def read_head(reader: asyncio.StreamReader) -> tuple[str, Headers]:
    """The first line and the headers of a message."""
    line = await reader.readline()
    headers = Headers()
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.decode("latin-1").partition(":")
        headers[name.strip()] = value.strip()
    return line.decode("latin-1").strip(), headers


def _is_chunked(headers: Headers) -> bool:
    return "chunked" in headers.get("Transfer-Encoding", "").lower()


async def read_chunk(reader: asyncio.StreamReader) -> bytes:
    """The next chunk of a chunked body; b"" after the last chunk (its
    trailers read). Raises ``ValueError`` on a malformed size line and
    ``asyncio.IncompleteReadError`` when the connection ends mid-body."""
    line = await reader.readline()
    if not line.endswith(b"\n"):
        raise asyncio.IncompleteReadError(line, None)
    size = line.split(b";", 1)[0].strip()
    if not size or any(c not in b"0123456789abcdefABCDEF" for c in size):
        raise ValueError(f"bad chunk size line {line[:40]!r}")
    n = int(size, 16)
    if n == 0:
        while (await reader.readline()) not in (b"\r\n", b"\n", b""):
            pass  # trailers
        return b""
    data = await reader.readexactly(n)
    await reader.readexactly(2)  # the chunk's CRLF
    return data


async def _read_chunked(reader: asyncio.StreamReader, limit: int) -> bytes:
    out = bytearray()
    while chunk := await read_chunk(reader):
        out += chunk
        if len(out) > limit:
            raise ValueError(f"chunked body past {limit} bytes")
    return bytes(out)


async def read_request(
    reader: asyncio.StreamReader, max_body: int = MAX_BODY
) -> Request | Response | None:
    """One request off the connection; None for an empty or garbled request
    line, a 413 ``Response`` for a body it will not read (a malformed or
    oversized chunked body included)."""
    first, headers = await read_head(reader)
    parts = first.split()
    if len(parts) != 3:
        return None
    method, target, version = parts
    if _is_chunked(headers):
        try:
            body = await _read_chunked(reader, max_body)
        except ValueError:
            return Response(413, {"error": "bad or oversized chunked body"})
    else:
        try:
            n = int(headers.get("Content-Length", "0") or 0)
        except ValueError:
            n = -1
        if n < 0 or n > max_body:
            return Response(413, {"error": "bad or oversized Content-Length"})
        body = await reader.readexactly(n) if n else b""
    u = urlsplit(target)
    return Request(method.upper(), u.path or "/", headers, body, query_string=u.query, version=version)


async def start_server(
    handler: Callable[[Request], Awaitable[Response]],
    host: str,
    port: int,
    max_body: int = MAX_BODY,
) -> asyncio.AbstractServer:
    """Serve ``handler`` on ``host:port`` (0 = any free port), one request
    per connection."""

    async def on_conn(reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            try:
                req = await read_request(reader, max_body)
            except ValueError:  # a line past the reader's limit
                return
            if req is None:
                return
            if isinstance(req, Request):
                req.reader = reader
                req.stream = Stream(reader, writer, chunked=req.version == "HTTP/1.1")
                peer = writer.get_extra_info("peername")
                req.remote = peer[0] if isinstance(peer, tuple) else ""
                resp = await handler(req)
            else:
                resp = req
            if resp.streamed:
                await req.stream.finish()
            else:
                writer.write(encode_response(resp))
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away
        finally:
            writer.close()

    return await asyncio.start_server(on_conn, host, port)


# -- client ------------------------------------------------------------------


def _request_bytes(method: str, url: str, headers: dict | None, body: bytes) -> tuple[str, int, bytes]:
    u = urlsplit(url)
    target = (u.path or "/") + (f"?{u.query}" if u.query else "")
    head = Headers(headers or {})
    for k in ("Host", "Content-Length", "Connection", "Transfer-Encoding"):
        head.pop(k, None)
    lines = [f"{method} {target} HTTP/1.1", f"Host: {u.hostname}:{u.port or 80}"]
    lines += [f"{k}: {v}" for k, v in head.items()]
    lines += [f"Content-Length: {len(body)}", "Connection: close"]
    return u.hostname or "127.0.0.1", u.port or 80, ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


async def read_body(reader: asyncio.StreamReader, headers: Headers) -> bytes:
    """A chunked body, a ``Content-Length`` body, else the bytes up to the
    close."""
    if _is_chunked(headers):
        return await _read_chunked(reader, 1 << 62)
    n = headers.get("Content-Length")
    if n is not None:
        return await reader.readexactly(int(n))
    return await reader.read()


class BodyReader:
    """A streamed response's body, piece by piece: ``read()`` returns the
    next chunk of a chunked body, else whatever bytes have arrived, and
    b"" at its end."""

    def __init__(self, reader: asyncio.StreamReader, headers: Headers):
        self._reader = reader
        self._chunked = _is_chunked(headers)
        self._done = False

    async def read(self) -> bytes:
        if self._done:
            return b""
        data = await read_chunk(self._reader) if self._chunked else await self._reader.read(65536)
        self._done = not data
        return data


async def open_stream(
    method: str,
    url: str,
    headers: dict | None = None,
    body: bytes = b"",
) -> tuple[int, Headers, asyncio.StreamReader, asyncio.StreamWriter]:
    """Send a request and read its status and headers; the caller reads the
    body off the returned reader and closes the writer. A refused or failed
    connect raises ``ConnectionError``/``OSError``; a connection lost before
    the status line raises ``ServerDisconnected``."""
    host, port, raw = _request_bytes(method, url, headers, body)
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port, limit=1 << 20), CONNECT_TIMEOUT_S
    )
    try:
        writer.write(raw)
        await writer.drain()
        first, rheaders = await read_head(reader)
        parts = first.split(" ", 2)
        if len(parts) < 2 or not parts[1].isdigit():
            raise ServerDisconnected(f"no status line from {host}:{port}")
        return int(parts[1]), rheaders, reader, writer
    except (ConnectionError, asyncio.IncompleteReadError) as e:
        writer.close()
        raise ServerDisconnected(f"{type(e).__name__}: {e}") from e
    except BaseException:
        writer.close()
        raise


async def request(
    method: str,
    url: str,
    headers: dict | None = None,
    body: bytes = b"",
    timeout: float | None = 30.0,
) -> tuple[int, Headers, bytes]:
    """One request, answered whole: (status, headers, body). Errors as
    ``open_stream``'s, and ``asyncio.TimeoutError`` past ``timeout``."""

    async def go() -> tuple[int, Headers, bytes]:
        status, rheaders, reader, writer = await open_stream(method, url, headers, body)
        try:
            return status, rheaders, await read_body(reader, rheaders)
        except (ConnectionError, asyncio.IncompleteReadError) as e:
            raise ServerDisconnected(f"{type(e).__name__}: {e}") from e
        finally:
            writer.close()

    return await asyncio.wait_for(go(), timeout)
