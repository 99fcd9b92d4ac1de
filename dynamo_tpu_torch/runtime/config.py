"""Layered runtime configuration.

Port of `dynamo_tpu/runtime/config.py` (`_env`, `env_*`, `RuntimeConfig`,
`discovery_address`): defaults <- optional JSON config file <- `DYN_*`
environment variables, env taking precedence. The variable names are the
reference's; its documentation table (`ENV_REGISTRY`) stays with the
reference.

Recognised env prefixes (parity with reference config.rs:214-260):
  DYN_RUNTIME_*   — runtime knobs (worker threads, shutdown timeouts)
  DYN_SYSTEM_*    — system status server (enabled, port)
  DYN_COMPUTE_*   — compute pool sizing
  DYN_HEALTH_CHECK_* — canary health checks
  DYN_DISCOVERY_* — built-in discovery service address
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Optional


def _env(name: str, default: Any = None, cast=str):
    raw = os.environ.get(name)
    if raw is None:
        return default
    if cast is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return cast(raw)


def env_bool(name: str, default: bool = False) -> bool:
    """Canonical bool parsing for registry-typed env vars: truthy spellings
    are exactly 1/true/yes/on (case-insensitive); anything else is False.
    Every `bool`-typed ENV_REGISTRY read must go through this (or _env) so
    the accepted spellings cannot drift between modules."""
    return bool(_env(name, default, bool))


def env_float(name: str, default: float) -> float:
    """Canonical lenient float parsing for registry-typed env vars: unset,
    empty, or unparseable values fall back to the default with a warning
    (a typo'd knob must degrade, not take the process down). One spelling
    shared by every module (the SLA/sched and gate knob surfaces)."""
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    try:
        return float(raw)
    except ValueError:
        import logging

        logging.getLogger(__name__).warning(
            "%s=%r is not a number; using %s", name, raw, default)
        return default


def env_int(name: str, default: int) -> int:
    """Lenient int parsing, same contract as env_float."""
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    try:
        return int(raw)
    except ValueError:
        import logging

        logging.getLogger(__name__).warning(
            "%s=%r is not an integer; using %s", name, raw, default)
        return default


@dataclasses.dataclass
class RuntimeConfig:
    """Process-local runtime configuration (reference: RuntimeConfig config.rs:72)."""

    # asyncio / compute pool
    num_worker_threads: int = 0  # 0 = library default
    max_blocking_threads: int = 4
    # graceful shutdown
    graceful_shutdown_timeout: float = 30.0
    # system status server (reference: DYN_SYSTEM_ENABLED/DYN_SYSTEM_PORT)
    system_enabled: bool = False
    system_host: str = "0.0.0.0"
    system_port: int = 0  # 0 = ephemeral
    # health checks (reference: config.rs:155-167)
    health_check_enabled: bool = False
    health_check_idle_timeout: float = 60.0
    health_check_request_timeout: float = 10.0
    # built-in discovery service ("etcd" role)
    discovery_endpoint: str = "tcp://127.0.0.1:2379"
    # instance-lease TTL: how long after missed keepalives a worker drops
    # out of discovery (reference etcd lease, transports/etcd.rs:43). Raise
    # on heavily-contended hosts where event loops can starve past 10s.
    lease_ttl_s: float = 10.0
    # request-plane bind host for TCP response/request streams
    request_plane_host: str = "127.0.0.1"
    # connect budget for dialing a worker (black-holed address -> StreamLost)
    request_plane_connect_timeout: float = 5.0

    @classmethod
    def from_settings(cls, config_path: Optional[str] = None) -> "RuntimeConfig":
        """Layered load: defaults <- file <- env (reference figment() config.rs:214).
        A YAML file raises: the port reads JSON only (no YAML parser in the
        standard library)."""
        cfg = cls()
        path = config_path or os.environ.get("DYN_RUNTIME_CONFIG")
        if path and Path(path).exists():
            if path.endswith((".yaml", ".yml")):
                raise ValueError(
                    f"runtime config {path}: YAML files are not read by the "
                    "PyTorch/CUDA port; write the same keys as JSON"
                )
            data = json.loads(Path(path).read_text())
            for field in dataclasses.fields(cls):
                if field.name in data:
                    setattr(cfg, field.name, data[field.name])
        # env layer
        cfg.num_worker_threads = _env(
            "DYN_RUNTIME_NUM_WORKER_THREADS", cfg.num_worker_threads, int
        )
        cfg.max_blocking_threads = _env(
            "DYN_RUNTIME_MAX_BLOCKING_THREADS", cfg.max_blocking_threads, int
        )
        cfg.graceful_shutdown_timeout = _env(
            "DYN_RUNTIME_GRACEFUL_SHUTDOWN_TIMEOUT", cfg.graceful_shutdown_timeout, float
        )
        cfg.system_enabled = _env("DYN_SYSTEM_ENABLED", cfg.system_enabled, bool)
        cfg.system_host = _env("DYN_SYSTEM_HOST", cfg.system_host)
        cfg.system_port = _env("DYN_SYSTEM_PORT", cfg.system_port, int)
        if cfg.system_port > 0 and "DYN_SYSTEM_ENABLED" not in os.environ:
            # an explicit port IS the ask (the deploy/metrics prometheus
            # scrape targets it); requiring a second flag to turn the
            # server on makes the gauges silently absent. An explicit
            # DYN_SYSTEM_ENABLED=0 still wins.
            cfg.system_enabled = True
        cfg.health_check_enabled = _env(
            "DYN_HEALTH_CHECK_ENABLED", cfg.health_check_enabled, bool
        )
        cfg.health_check_idle_timeout = _env(
            "DYN_HEALTH_CHECK_IDLE_TIMEOUT", cfg.health_check_idle_timeout, float
        )
        cfg.health_check_request_timeout = _env(
            "DYN_HEALTH_CHECK_REQUEST_TIMEOUT", cfg.health_check_request_timeout, float
        )
        cfg.discovery_endpoint = _env("DYN_DISCOVERY_ENDPOINT", cfg.discovery_endpoint)
        cfg.lease_ttl_s = _env("DYN_LEASE_TTL_S", cfg.lease_ttl_s, float)
        cfg.request_plane_host = _env("DYN_REQUEST_PLANE_HOST", cfg.request_plane_host)
        cfg.request_plane_connect_timeout = _env(
            "DYN_REQUEST_PLANE_CONNECT_TIMEOUT", cfg.request_plane_connect_timeout, float
        )
        return cfg


def discovery_address(cfg: Optional[RuntimeConfig] = None) -> tuple[str, int]:
    """Parse the discovery endpoint into (host, port)."""
    cfg = cfg or RuntimeConfig.from_settings()
    ep = cfg.discovery_endpoint
    if "://" in ep:
        ep = ep.split("://", 1)[1]
    host, _, port = ep.rpartition(":")
    return host or "127.0.0.1", int(port)
