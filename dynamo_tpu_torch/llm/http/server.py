"""A small HTTP/1.1 server on asyncio streams: what the frontend needs of
aiohttp.web, answered as aiohttp answers it.

- Requests: keep-alive (HTTP/1.1 unless `Connection: close`; HTTP/1.0 only
  with `Connection: keep-alive`), `Content-Length` bodies and chunked
  request bodies (aiohttp decodes those too) up to `client_max_size`. A
  larger body is not read: `Request.json()` raises, as aiohttp's raises
  `Request Entity Too Large`, and the connection closes after the answer.
- Routes: an unknown path is `404: Not Found`, a known path with another
  method `405: Method Not Allowed` with `Allow`; a GET route also answers
  HEAD (aiohttp's `add_get`). A request line that does not parse is a 400
  and the connection closes.
- Unary answers carry `Content-Length`; `json_response` writes
  `json.dumps(data)` as `application/json; charset=utf-8`.
- `StreamResponse` writes its head at `prepare()` and each `write()` as one
  HTTP/1.1 chunk, drained before it returns; the handler's return ends the
  body (`0\\r\\n\\r\\n`). From `prepare()` on, a task reads the connection: when
  the peer closes it, the handler task is cancelled at once (so a stream
  whose client left is killed before its next token, not at its next
  write), and a write to the closed peer raises `ConnectionResetError`.
  Bytes a client pipelines meanwhile are kept for the next request.
"""

from __future__ import annotations

import asyncio
import email.utils
import http
import json
import logging
import sys
from typing import Awaitable, Callable, Dict, Optional, Tuple
from urllib.parse import parse_qsl, urlsplit

logger = logging.getLogger(__name__)

SERVER = f"Python/{sys.version_info.major}.{sys.version_info.minor} dynamo-tpu-torch"
MAX_HEAD = 65536  # request line and headers together
KEEPALIVE_S = 75.0  # idle time before a kept-alive connection closes (aiohttp's default)
TOO_LARGE = "Request Entity Too Large"


class Headers(dict):
    """Header names folded to lower case: `get` is case-insensitive."""

    def get(self, key, default=None):
        return super().get(key.lower(), default)

    def __getitem__(self, key):
        return super().__getitem__(key.lower())

    def __contains__(self, key):
        return super().__contains__(key.lower())


class Request:
    def __init__(self, method: str, target: str, version: str, headers: Headers,
                 body: bytes, body_error: Optional[str], conn: "_Connection"):
        self.method = method
        self.version = version
        self.headers = headers
        parts = urlsplit(target)
        self.path = parts.path
        self.query: Dict[str, str] = {}
        for k, v in parse_qsl(parts.query, keep_blank_values=True):
            self.query.setdefault(k, v)
        self._body = body
        self._body_error = body_error
        self._conn = conn

    async def read(self) -> bytes:
        if self._body_error:
            raise ValueError(self._body_error)
        return self._body

    async def json(self):
        return json.loads(await self.read())


class Response:
    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: str = "text/plain; charset=utf-8",
                 headers: Optional[Dict[str, str]] = None):
        self.body = body
        self.status = status
        self.headers = {"Content-Type": content_type, **(headers or {})}


def json_response(data, status: int = 200, headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(json.dumps(data).encode(), status,
                     "application/json; charset=utf-8", headers)


def _head(version: str, status: int, headers: Dict[str, str], close: bool) -> bytes:
    lines = [f"{version} {status} {http.HTTPStatus(status).phrase}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    lines.append(f"Date: {email.utils.formatdate(usegmt=True)}")
    lines.append(f"Server: {SERVER}")
    if close and version == "HTTP/1.1":
        lines.append("Connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class StreamResponse:
    """A response written as it is produced (SSE)."""

    def __init__(self, status: int = 200, headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.headers = dict(headers or {})
        self._conn: Optional[_Connection] = None
        self._chunked = True

    async def prepare(self, request: Request) -> None:
        conn = request._conn
        self._conn = conn
        # HTTP/1.0 has no chunked encoding: the body runs to the close
        self._chunked = request.version == "HTTP/1.1"
        if self._chunked:
            self.headers["Transfer-Encoding"] = "chunked"
        else:
            conn.keep_alive = False
        conn.streaming = True
        conn.writer.write(_head(request.version, self.status, self.headers,
                                not conn.keep_alive))
        await conn.writer.drain()
        conn.watch_peer()

    async def write(self, data: bytes) -> None:
        conn = self._conn
        if conn.peer_gone or conn.writer.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        if not data:
            return
        conn.writer.write(b"%x\r\n%s\r\n" % (len(data), data) if self._chunked else data)
        await conn.writer.drain()

    async def write_eof(self) -> None:
        conn = self._conn
        await conn.stop_watch()
        if self._chunked and not conn.peer_gone and not conn.writer.is_closing():
            conn.writer.write(b"0\r\n\r\n")
            await conn.writer.drain()


Handler = Callable[[Request], Awaitable[object]]


class _Connection:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 max_body: int):
        self.reader = reader
        self.writer = writer
        self.max_body = max_body
        self.buf = bytearray()
        self.keep_alive = True
        self.peer_gone = False
        self.streaming = False  # a StreamResponse's head is on the wire
        self.handler_task: Optional[asyncio.Task] = None
        self._watcher: Optional[asyncio.Task] = None

    async def _fill(self) -> bool:
        data = await self.reader.read(65536)
        self.buf += data
        return bool(data)

    async def _line(self) -> bytes:
        while (i := self.buf.find(b"\r\n")) < 0:
            if len(self.buf) > MAX_HEAD or not await self._fill():
                raise ConnectionError("truncated chunked body")
        line = bytes(self.buf[:i])
        del self.buf[: i + 2]
        return line

    async def _exactly(self, n: int) -> bytes:
        while len(self.buf) < n:
            if not await self._fill():
                raise ConnectionError("truncated body")
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out

    async def read_request(self) -> Optional[Tuple]:
        """(method, target, version, headers, body, body error), None at a
        clean end of the connection, or an int status for a bad request."""
        while (end := self.buf.find(b"\r\n\r\n")) < 0:
            if len(self.buf) > MAX_HEAD:
                return 400
            idle = not self.buf
            try:
                got = await asyncio.wait_for(self._fill(), KEEPALIVE_S if idle else 30.0)
            except asyncio.TimeoutError:
                return None
            if not got:
                return None
        head = bytes(self.buf[:end]).decode("latin-1")
        del self.buf[: end + 4]
        lines = head.split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or parts[2] not in ("HTTP/1.1", "HTTP/1.0") or not parts[0].isalpha():
            return 400
        method, target, version = parts
        headers = Headers()
        for line in lines[1:]:
            name, sep, value = line.partition(":")
            if not sep or not name or name != name.strip():
                return 400
            key = name.lower()
            value = value.strip()
            headers[key] = f"{headers[key]},{value}" if key in headers else value
        conn_hdr = headers.get("connection", "").lower()
        self.keep_alive = ("close" not in conn_hdr if version == "HTTP/1.1"
                           else "keep-alive" in conn_hdr)
        body, error = b"", None
        if headers.get("expect", "").lower() == "100-continue":
            # curl asks before sending a body over 1 KiB
            self.writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await self.writer.drain()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            chunks, size = [], 0
            while True:
                try:
                    n = int((await self._line()).split(b";", 1)[0].strip(), 16)
                except ValueError:
                    return 400
                if n == 0:
                    while await self._line():
                        pass  # trailer fields
                    break
                size += n
                if size > self.max_body:
                    error, self.keep_alive = TOO_LARGE, False
                    break
                chunks.append(await self._exactly(n))
                await self._exactly(2)
            body = b"".join(chunks)
        elif headers.get("content-length"):
            try:
                n = int(headers["content-length"])
            except ValueError:
                return 400
            if n < 0:
                return 400
            if n > self.max_body:
                error, self.keep_alive = TOO_LARGE, False
            else:
                body = await self._exactly(n)
        return method, target, version, headers, (b"" if error else body), error

    def watch_peer(self) -> None:
        """Read the connection while a stream is written: its end is the
        client leaving, and cancels the handler."""

        async def watch():
            try:
                while await self._fill():
                    pass
            except (ConnectionError, OSError):
                pass
            self.peer_gone = True
            self.keep_alive = False
            if self.handler_task is not None and not self.handler_task.done():
                self.handler_task.cancel()

        self._watcher = asyncio.create_task(watch())

    async def stop_watch(self) -> None:
        """End the peer watch; its read is over when this returns, so the
        next request's read does not collide with it."""
        watcher, self._watcher = self._watcher, None
        if watcher is not None:
            watcher.cancel()
            await asyncio.gather(watcher, return_exceptions=True)


class HttpServer:
    """Routes (method, path) to handlers: `add_get` / `add_post` as
    aiohttp's router, `start` binds (port 0 picks one), `stop` closes every
    connection and cancels running handlers."""

    def __init__(self, client_max_size: int = 1024 ** 2):
        self.client_max_size = client_max_size
        self._routes: Dict[str, Dict[str, Handler]] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()

    def add_post(self, path: str, handler: Handler) -> None:
        self._routes.setdefault(path, {})["POST"] = handler

    def add_get(self, path: str, handler: Handler) -> None:
        methods = self._routes.setdefault(path, {})
        methods["GET"] = methods["HEAD"] = handler

    async def start(self, host: str, port: int) -> int:
        self._server = await asyncio.start_server(self._serve, host, port)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        server, self._server = self._server, None
        if server is None:
            return
        server.close()
        for task in list(self._conns):
            task.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        await server.wait_closed()

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        task = asyncio.current_task()
        self._conns.add(task)
        conn = _Connection(reader, writer, self.client_max_size)
        try:
            while conn.keep_alive:
                req = await conn.read_request()
                if req is None:
                    break
                if isinstance(req, int):
                    writer.write(_head("HTTP/1.0", req, {
                        "Content-Type": "text/plain; charset=utf-8",
                        "Content-Length": "15"}, True) + b"400 Bad Request")
                    await writer.drain()
                    break
                await self._dispatch(conn, Request(*req, conn=conn))
        except (ConnectionError, OSError):
            pass  # the peer went away
        except Exception:  # noqa: BLE001 — one broken connection must not stop the server
            logger.exception("HTTP connection failed")
        finally:
            if conn._watcher is not None:
                conn._watcher.cancel()
            self._conns.discard(task)
            writer.close()

    async def _dispatch(self, conn: _Connection, req: Request) -> None:
        methods = self._routes.get(req.path)
        if methods is None:
            resp = Response(b"404: Not Found", 404)
        elif req.method not in methods:
            resp = Response(b"405: Method Not Allowed", 405,
                            headers={"Allow": ",".join(sorted(methods))})
        else:
            conn.handler_task = asyncio.create_task(methods[req.method](req))
            try:
                resp = await conn.handler_task
            except asyncio.CancelledError:
                if conn.peer_gone and not asyncio.current_task().cancelling():
                    conn.keep_alive = False
                    return  # the client left mid-stream; the handler cleaned up
                raise
            except Exception:  # noqa: BLE001 — aiohttp answers an unhandled error with a 500
                logger.exception("handler for %s %s failed", req.method, req.path)
                conn.keep_alive = False
                if conn.streaming:
                    return  # the head is sent: only the close can end it
                resp = Response(b"500 Internal Server Error", 500)
            finally:
                conn.handler_task = None
                conn.streaming = False
        if isinstance(resp, StreamResponse):
            await resp.write_eof()
            return
        headers = dict(resp.headers)
        headers["Content-Length"] = str(len(resp.body))
        conn.writer.write(_head(req.version, resp.status, headers, not conn.keep_alive)
                          + (b"" if req.method == "HEAD" else resp.body))
        await conn.writer.drain()
