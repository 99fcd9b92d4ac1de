"""Shared retry backoff: exponential with deterministic jitter.

Port of `dynamo_tpu/runtime/backoff.py`, unchanged.

Every reconnect/retry loop in the serving plane (RequestPlaneClient
redials, DiscoveryClient re-watch, Migration retries) uses this one
policy so recovery behavior is uniform and — given a seed — fully
deterministic, which the dynochaos soak tests rely on. Jitter comes from
a seeded `random.Random`, not the global RNG: two processes with the
same seed retry on the same schedule, and a test re-run reproduces the
exact timing it asserted on.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
import zlib
from typing import Awaitable, Callable, Optional, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")


class Backoff:
    """Exponential backoff with deterministic jitter.

    delay(n) = min(max_delay, base * factor**n) * (1 + jitter * U(-1, 1))

    where U is drawn from a Random seeded at construction. `deadline`
    (absolute `time.monotonic()` value) clips every wait so a retry loop
    can never sleep past its request's budget.
    """

    def __init__(
        self,
        base: float = 0.05,
        factor: float = 2.0,
        max_delay: float = 2.0,
        jitter: float = 0.1,
        seed: Optional[int] = None,
    ):
        self.base = base
        self.factor = factor
        self.max_delay = max_delay
        self.jitter = jitter
        self._rng = random.Random(seed)
        self.attempt = 0

    @classmethod
    def seeded(cls, key: str, **kwargs) -> "Backoff":
        """Backoff whose jitter is seeded from a stable string (request id,
        endpoint subject, host:port) — the one idiom every retry loop uses
        so chaos re-runs reproduce their timing."""
        return cls(seed=zlib.crc32(key.encode()), **kwargs)

    def reset(self):
        self.attempt = 0

    def next_delay(self) -> float:
        raw = min(self.max_delay, self.base * (self.factor ** self.attempt))
        self.attempt += 1
        if self.jitter:
            raw *= 1.0 + self.jitter * self._rng.uniform(-1.0, 1.0)
        return max(0.0, raw)

    async def wait(self, deadline: Optional[float] = None) -> bool:
        """Sleep the next delay. Returns False (without sleeping the full
        delay) when `deadline` would be crossed — the caller should stop
        retrying."""
        delay = self.next_delay()
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            if delay >= remaining:
                await asyncio.sleep(remaining)
                return False
        await asyncio.sleep(delay)
        return True


async def retry_async(
    fn: Callable[[], Awaitable[T]],
    *,
    attempts: int,
    backoff: Backoff,
    desc: str = "operation",
    log: Optional[logging.Logger] = None,
) -> T:
    """Bounded retry with backoff: call `fn` up to `attempts` times,
    sleeping the backoff between failures but NEVER after the last one
    (an exhausted retry cycle must not add dead delay to the failing
    path). CancelledError passes straight through; when every attempt
    fails the LAST exception is re-raised for the caller to classify.

    The one retry idiom the planner loop's callers share (metrics scrape,
    connector apply, replica spawn) so attempt accounting and logging
    cannot drift between copies."""
    last: Optional[BaseException] = None
    n = max(1, attempts)
    for attempt in range(n):
        try:
            return await fn()
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — retried, then re-raised
            last = e
            (log or logger).warning(
                "%s failed (attempt %d/%d): %s", desc, attempt + 1, n, e
            )
            if attempt + 1 < n:
                await backoff.wait()
    assert last is not None
    raise last
