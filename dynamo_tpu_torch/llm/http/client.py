"""A small HTTP/1.1 client on asyncio streams: what the planner and its soak
harness need of aiohttp's client.

The reference scrapes the frontend's `/metrics` and drives streamed chat
completions with `aiohttp.ClientSession`; the card's machine has no
aiohttp. `ClientSession` here keeps that shape for the calls those modules
make: `get(url)` and `post(url, json=..., headers=..., timeout=...)`,
each an async context manager over a `ClientResponse` with `status`,
`headers` (case-insensitive), `read()`, `text()`, `json()`,
`raise_for_status()` and `content`, the body's lines as they arrive (an SSE
stream's events). Every request opens its own connection and asks the
server to close it (`Connection: close`); bodies are read by
`Content-Length`, as chunked transfer coding, or to the connection's end.
Errors are `ClientError` (and its `ClientResponseError` for a status >=
400 at `raise_for_status`), or `asyncio.TimeoutError` past `timeout`.
"""

from __future__ import annotations

import asyncio
import json as _json
from typing import AsyncIterator, Dict, Optional
from urllib.parse import urlsplit

from .server import Headers


class ClientError(Exception):
    """A connection that failed or an answer that does not parse."""


class ClientResponseError(ClientError):
    def __init__(self, status: int, reason: str, url: str):
        super().__init__(f"{status}, message={reason!r}, url={url!r}")
        self.status = status


class ClientResponse:
    def __init__(self, url: str, status: int, reason: str, headers: Headers,
                 reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 deadline: Optional[float]):
        self.url = url
        self.status = status
        self.reason = reason
        self.headers = headers
        self._reader = reader
        self._writer = writer
        self._deadline = deadline
        self._body: Optional[bytes] = None

    async def _timed(self, aw):
        if self._deadline is None:
            return await aw
        left = self._deadline - asyncio.get_running_loop().time()
        if left <= 0:
            raise asyncio.TimeoutError()
        return await asyncio.wait_for(aw, left)

    async def _pieces(self) -> AsyncIterator[bytes]:
        """The body as it arrives: decoded chunks, or raw reads."""
        r = self._reader
        if "chunked" in self.headers.get("transfer-encoding", "").lower():
            while True:
                size_line = await self._timed(r.readline())
                if not size_line.endswith(b"\n"):
                    raise ClientError("truncated chunked body")
                try:
                    size = int(size_line.split(b";", 1)[0].strip(), 16)
                except ValueError:
                    raise ClientError(f"bad chunk size {size_line!r}") from None
                if size == 0:
                    while (await self._timed(r.readline())).strip():
                        pass  # trailers
                    return
                data = await self._timed(r.readexactly(size))
                await self._timed(r.readexactly(2))
                yield data
        elif "content-length" in self.headers:
            left = int(self.headers["content-length"])
            while left > 0:
                data = await self._timed(r.read(min(left, 1 << 16)))
                if not data:
                    raise ClientError("truncated body")
                left -= len(data)
                yield data
        else:
            while True:
                data = await self._timed(r.read(1 << 16))
                if not data:
                    return
                yield data

    @property
    def content(self) -> AsyncIterator[bytes]:
        """The body's lines (each with its b"\\n"), as they arrive."""
        return self._lines()

    async def _lines(self) -> AsyncIterator[bytes]:
        buf = b""
        try:
            async for data in self._pieces():
                buf += data
                *lines, buf = buf.split(b"\n")
                for line in lines:
                    yield line + b"\n"
            if buf:
                yield buf
        except asyncio.IncompleteReadError as e:
            raise ClientError("connection closed mid-body") from e

    async def read(self) -> bytes:
        if self._body is None:
            try:
                self._body = b"".join([d async for d in self._pieces()])
            except asyncio.IncompleteReadError as e:
                raise ClientError("connection closed mid-body") from e
        return self._body

    async def text(self, encoding: str = "utf-8") -> str:
        return (await self.read()).decode(encoding, "replace")

    async def json(self):
        return _json.loads(await self.read())

    def raise_for_status(self) -> None:
        if self.status >= 400:
            raise ClientResponseError(self.status, self.reason, self.url)

    def close(self) -> None:
        self._writer.close()


class _Request:
    """An async context manager over one exchange that closes its
    connection on exit."""

    def __init__(self, coro):
        self._coro = coro
        self._resp: Optional[ClientResponse] = None

    async def __aenter__(self) -> ClientResponse:
        self._resp = await self._coro
        return self._resp

    async def __aexit__(self, *exc) -> None:
        if self._resp is not None:
            self._resp.close()


async def _request(method: str, url: str, body: bytes, headers: Dict[str, str],
                   timeout: Optional[float]) -> ClientResponse:
    parts = urlsplit(url)
    if parts.scheme != "http" or not parts.hostname:
        raise ClientError(f"unsupported URL {url!r}")
    port = parts.port or 80
    target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
    loop = asyncio.get_running_loop()
    deadline = None if timeout is None else loop.time() + timeout

    async def exchange():
        try:
            reader, writer = await asyncio.open_connection(parts.hostname, port)
        except OSError as e:
            raise ClientError(f"cannot connect to {parts.hostname}:{port}: {e}") from e
        try:
            head = [f"{method} {target} HTTP/1.1", f"Host: {parts.hostname}:{port}",
                    "Connection: close", f"Content-Length: {len(body)}"]
            head += [f"{k}: {v}" for k, v in headers.items()]
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body)
            await writer.drain()
            try:  # the stream's 64 KiB limit bounds the head
                raw = await reader.readuntil(b"\r\n\r\n")
            except (asyncio.IncompleteReadError, asyncio.LimitOverrunError) as e:
                raise ClientError("no complete answer head") from e
            status_line, *lines = raw.decode("latin-1").split("\r\n")
            try:
                _version, status, *reason = status_line.split(" ", 2)
                status = int(status)
            except ValueError:
                raise ClientError(f"bad status line {status_line!r}") from None
            hdrs = Headers()
            for line in lines:
                if ":" in line:
                    k, v = line.split(":", 1)
                    hdrs[k.strip().lower()] = v.strip()
            return ClientResponse(url, status, reason[0] if reason else "", hdrs,
                                  reader, writer, deadline)
        except BaseException:
            writer.close()
            raise

    try:
        if timeout is None:
            return await exchange()
        return await asyncio.wait_for(exchange(), timeout)
    except ConnectionError as e:
        raise ClientError(str(e)) from e


class ClientSession:
    """aiohttp.ClientSession's shape for GET and POST (`timeout` in seconds,
    the whole exchange's limit, body included)."""

    def __init__(self, timeout: Optional[float] = 300.0):
        self.timeout = timeout

    def get(self, url: str, *, timeout: Optional[float] = None) -> _Request:
        return _Request(_request("GET", url, b"", {},
                                 self.timeout if timeout is None else timeout))

    def post(self, url: str, *, json, headers: Optional[Dict[str, str]] = None,
             timeout: Optional[float] = None) -> _Request:
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        return _Request(_request("POST", url, _json.dumps(json).encode(), hdrs,
                                 self.timeout if timeout is None else timeout))

    async def __aenter__(self) -> "ClientSession":
        return self

    async def __aexit__(self, *exc) -> None:
        pass
