"""System status server: /health, /live, /metrics.

Port of `dynamo_tpu/runtime/system_status.py` (the reference's system status
server and system health), on the standard library: a small HTTP/1.1
responder on asyncio streams, one request a connection, enabled by
DYN_SYSTEM_ENABLED / DYN_SYSTEM_PORT. It answers as the reference's aiohttp
server does: `/health` 200 (ready) or 503 with `{"status", "endpoints"}`
JSON, `/live` 200 `{"status": "live"}`, `/metrics` the registry's
Prometheus text; 404 for another path, 405 for a method other than GET or
HEAD.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Dict, Optional, Tuple

from .metrics import MetricsRegistry

logger = logging.getLogger(__name__)

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
            503: "Service Unavailable"}


class SystemHealth:
    """Endpoint-state-driven health: the process is ready iff every
    registered endpoint is healthy."""

    def __init__(self):
        self._endpoints: Dict[str, bool] = {}

    def set_endpoint_health(self, endpoint_path: str, healthy: bool) -> None:
        self._endpoints[endpoint_path] = healthy

    def remove_endpoint(self, endpoint_path: str) -> None:
        self._endpoints.pop(endpoint_path, None)

    @property
    def healthy(self) -> bool:
        return all(self._endpoints.values()) if self._endpoints else True

    def snapshot(self) -> dict:
        return {
            "status": "healthy" if self.healthy else "unhealthy",
            "endpoints": dict(self._endpoints),
        }


class SystemStatusServer:
    def __init__(self, health: SystemHealth, metrics: Optional[MetricsRegistry] = None,
                 host: str = "0.0.0.0", port: int = 0):
        self.health = health
        self.metrics = metrics
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()

    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(self._serve, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("system status server on %s:%d", self.host, self.port)
        return self.host, self.port

    async def stop(self) -> None:
        # take-then-act: a concurrent stop() must not close twice
        server, self._server = self._server, None
        if server is not None:
            server.close()
            for writer in list(self._conns):
                writer.close()
            await server.wait_closed()

    def _route(self, method: str, path: str) -> Tuple[int, str, bytes]:
        """(status, content type, body) of one request."""
        path = path.split("?", 1)[0]
        if path not in ("/health", "/live", "/metrics"):
            return 404, "text/plain", b"404: Not Found"
        if method not in ("GET", "HEAD"):
            return 405, "text/plain", b"405: Method Not Allowed"
        if path == "/health":
            body = json.dumps(self.health.snapshot()).encode()
            return (200 if self.health.healthy else 503), "application/json", body
        if path == "/live":
            return 200, "application/json", json.dumps({"status": "live"}).encode()
        body = self.metrics.render() if self.metrics is not None else b""
        return 200, "text/plain", body

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._conns.add(writer)
        try:
            request = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 10.0)
            line = request.split(b"\r\n", 1)[0].decode("latin-1")
            parts = line.split()
            if len(parts) != 3 or not parts[2].startswith("HTTP/"):
                status, ctype, body = 400, "text/plain", b"400: Bad Request"
                method = "GET"
            else:
                method = parts[0]
                status, ctype, body = self._route(method, parts[1])
            head = (
                f"HTTP/1.1 {status} {_REASONS[status]}\r\n"
                f"Content-Type: {ctype}; charset=utf-8\r\n"
                f"Content-Length: {len(body)}\r\n"
                "Connection: close\r\n\r\n"
            ).encode()
            writer.write(head if method == "HEAD" else head + body)
            await writer.drain()
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError, ConnectionError):
            pass  # a client that sent no complete request
        except Exception:  # noqa: BLE001 — one bad request must not stop the server
            logger.exception("system status request failed")
        finally:
            self._conns.discard(writer)
            writer.close()
