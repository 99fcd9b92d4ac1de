"""Cancellation contexts for streaming engines.

Port of `dynamo_tpu/runtime/engine.py:Context`: an engine is any object
with `async def generate(request, context) -> AsyncIterator[response]`;
the context carries the request id, a graceful stop, a hard kill and an
optional deadline down the pipeline.
"""

from __future__ import annotations

import asyncio
import secrets
import time
from typing import Optional


class Context:
    """Cancellation context propagated through the pipeline
    (reference AsyncEngineContext engine.rs:112).

    `stop_generating` = graceful: finish the current token, emit a final
    usage chunk. `kill` = hard: stop streaming immediately. Child contexts
    form a cancellation tree like the reference's token hierarchy.

    A context may carry a `deadline` (absolute `time.monotonic()` value):
    the end-to-end budget for the request. Connect attempts, retry loops
    (migration) and backoff waits clip to it — past the deadline they stop
    retrying and surface a clean error instead of spinning. Children
    inherit the tightest deadline on the parent chain; the deadline also
    crosses the request plane (`deadline_ms` on the wire) so worker-side
    contexts see the same budget.
    """

    def __init__(
        self,
        id: Optional[str] = None,
        parent: Optional["Context"] = None,
        deadline: Optional[float] = None,
    ):
        self._id = id or secrets.token_hex(8)
        self._stopped = asyncio.Event()
        self._killed = asyncio.Event()
        self._parent = parent
        self._deadline = deadline
        self._children: list[Context] = []
        # the worker instance the last routed dial targeted (set by
        # Client.direct): when the stream dies, migration reads this to
        # exclude the dead instance from the retry's re-route
        # (docs/fault_tolerance.md "Request migration")
        self.routed_instance: Optional[int] = None
        if parent is not None:
            parent._children.append(self)

    @property
    def id(self) -> str:
        return self._id

    @property
    def deadline(self) -> Optional[float]:
        """Effective deadline: the tightest on the parent chain."""
        own = self._deadline
        if self._parent is not None:
            inherited = self._parent.deadline
            if inherited is not None and (own is None or inherited < own):
                return inherited
        return own

    def set_deadline(self, seconds_from_now: float) -> "Context":
        self._deadline = time.monotonic() + seconds_from_now
        return self

    def time_remaining(self) -> Optional[float]:
        """Seconds until the deadline (>= 0), or None when unbounded."""
        dl = self.deadline
        return None if dl is None else max(0.0, dl - time.monotonic())

    def deadline_exceeded(self) -> bool:
        dl = self.deadline
        return dl is not None and time.monotonic() >= dl

    def is_stopped(self) -> bool:
        return self._stopped.is_set() or (self._parent is not None and self._parent.is_stopped())

    def is_killed(self) -> bool:
        return self._killed.is_set() or (self._parent is not None and self._parent.is_killed())

    def stop_generating(self):
        self._stopped.set()
        for child in self._children:
            child.stop_generating()

    def kill(self):
        self._killed.set()
        self._stopped.set()
        for child in self._children:
            child.kill()

    async def stopped(self):
        """Wait until stop is requested."""
        await self._wait_event(lambda c: c._stopped)

    async def killed(self):
        """Wait until hard kill is requested."""
        await self._wait_event(lambda c: c._killed)

    async def _wait_event(self, get_event):
        if self._parent is None:
            await get_event(self).wait()
            return
        parent_task = asyncio.create_task(self._parent._wait_event(get_event))
        own_task = asyncio.create_task(get_event(self).wait())
        done, pending = await asyncio.wait(
            [parent_task, own_task], return_when=asyncio.FIRST_COMPLETED
        )
        for task in pending:
            task.cancel()

    def child(self, id: Optional[str] = None) -> "Context":
        return Context(id=id or self._id, parent=self)
