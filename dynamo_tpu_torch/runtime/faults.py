"""dynochaos: deterministic, seeded fault injection for the serving plane.

Port of `dynamo_tpu/runtime/faults.py`, unchanged: the port's request
plane and discovery carry the same injection points.

Dynamo's robustness story — request migration on worker death, canary
health checks, lease-reaped discovery — is only trustworthy if every
failure path is reachable ON DEMAND and proven correct under a seeded
schedule. This module is the single switchboard: named injection points
threaded through the request plane (`request_plane.connect`,
`request_plane.frame`), discovery (`discovery.lease`, `discovery.watch`),
the engines (`engine.step`, `mocker.step`) and the KV data plane
(`kv_transfer.chunk`), each guarded by the pattern

    f = faults.FAULTS
    if f.enabled:
        act = await f.on("point.name")
        ...site-specific handling of `act`...

When no plan is configured, `FAULTS` is the shared `NOOP` pass-through
object (``enabled = False``) installed at import time, so the hot path
pays one attribute load and a falsy branch — behavior is byte-identical
to a build without this module (guarded by a test asserting
``faults.FAULTS is faults.NOOP``).

Configuration (all registered in `runtime/config.py:ENV_REGISTRY`):

  DYN_FAULT_PLAN     the plan string (grammar below); unset -> NOOP
  DYN_FAULT_SEED     RNG seed for probabilistic rules (default 0)
  DYN_FAULT_DISABLE  global kill-switch: force NOOP even with a plan set

Plan grammar — semicolon-separated rules, one per injection point hit
pattern::

    plan  = rule (";" rule)*
    rule  = point [":" spec ("," spec)*]
    spec  = action ["@t=" SECONDS]      e.g.  sever   drop@t=2.0
          | "after=" N                  pass the first N hits, then fire
          | "at=" N                     fire exactly on the Nth hit (1-based)
          | "t=" SECONDS                fire once armed longer than SECONDS
          | "p=" PROB                   fire with seeded probability
          | "times=" N                  fire at most N times (default 1;
                                        p= rules default to unlimited)
          | "delay=" SECONDS            sleep length for the delay action

    Example: request_plane.frame:sever,after=3;discovery.lease:drop@t=2.0

Actions are interpreted by the site: `error` raises :class:`FaultError`
from :meth:`FaultInjector.on`; `delay` sleeps ``delay=`` seconds and
returns; `hang` sleeps effectively forever (the site's timeout must
bound it); everything else (`sever`, `refuse`, `drop`, `partial`, …) is
returned as a string for the site to act on.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

# actions on() resolves itself; all others are returned to the site
_HANG_SECONDS = 3600.0
_UNLIMITED = 1 << 30

#: Canonical injection points: name -> one-line description (actions the
#: site interprets, then where it bites), as the reference lists them.
KNOWN_FAULT_POINTS = {
    "request_plane.connect":
        "`refuse` | `hang` — client dial of a worker's request plane",
    "request_plane.frame":
        "`sever` | `delay` | `hang` — client recv, per data frame; "
        "`sever` kills the whole connection",
    "discovery.lease":
        "`drop` — lease keepalive tick; simulates server-side TTL expiry",
    "discovery.watch":
        "`disconnect` — discovery recv loop; drops the control-plane "
        "connection to exercise the re-watch path",
    "engine.step":
        "`error` — JaxEngine step loop; fail-all then migration",
    "mocker.step":
        "`error` — MockEngine step loop; fail-all",
    "kv_transfer.chunk":
        "`sever` | `delay` — KV data-plane chunk serve; partial transfer",
    "kv_transfer.pull":
        "`sever` | `delay` — peer-side kvbm block pull (cluster KV "
        "fabric onboard); `sever` drops the connection mid-pull and the "
        "admission path falls back to local-tier/recompute, counted",
    "planner.scrape":
        "`error` | `hang` | `delay` — planner's frontend /metrics scrape; "
        "the planner retries with backoff and ages out stale observations",
    "planner.connector":
        "`error` — planner connector set_replicas; the planner retries "
        "with backoff and re-asserts the target next interval",
    "worker.spawn":
        "`error` | `crash` — LocalProcessConnector replica spawn; `error` "
        "fails the exec, `crash` kills the child before it reports ready",
    "worker.kill":
        "`kill` — LocalProcessConnector reconcile tick: SIGKILL a live "
        "managed replica with NO drain (hard worker death); migration "
        "must absorb the lost streams and reconcile respawns the corpse",
    "worker.morph":
        "`error` | `delay` | `hang` | `crash` — engine role-morph stages "
        "(checked mid-drain and again mid-flip); `error` rolls the worker "
        "back to its original role (drained sessions already resumed on "
        "peers), `crash` tears the worker down mid-morph like a SIGKILL "
        "so lease TTL + migration corpse-handling absorb it",
    "kv_transfer.checkpoint":
        "`sever` | `delay` — session-checkpoint push to the peer's G2 "
        "(kvbm/checkpoint.py); `sever` drops the batch (counted) and "
        "quarantines the peer — serving streams never notice",
    "kvbm.offload":
        "`error` | `delay` — kvbm-tier thread store of one offload batch; "
        "`error` drops the batch (counted), streams never notice",
    "kvbm.onboard":
        "`error` | `delay` — tier load at admission onboard; `error` "
        "falls back to full prefill of that span",
    "lora.onboard":
        "`error` | `delay` — adapter-tier host->device onboard at "
        "admission (models/lora_pool.py); `error` refuses the request "
        "with a typed LoraPoolError (counted), `delay` stretches the "
        "cold adapter switch — either way the stream is rejected or "
        "late, never corrupt",
    "gate.admit":
        "`reject` — frontend admission decision (dynogate); forces a "
        "clean 429-with-Retry-After on the hit, exercising the typed "
        "rejection path before tokenization",
}


class FaultError(RuntimeError):
    """An injected fault (action `error`). Typed so tests and callers can
    tell a chaos-induced failure from an organic one."""


class MorphCrash(FaultError):
    """Injected `worker.morph:crash`: the engine raises this out of its
    morph sequence INSTEAD of rolling back, so the worker harness tears
    the process down mid-morph like a SIGKILL — lease lingers to TTL,
    streams sever, and the migration/corpse machinery absorbs it."""


@dataclass
class _Rule:
    point: str
    action: str = "error"
    after: Optional[int] = None
    at: Optional[int] = None
    t: Optional[float] = None
    p: Optional[float] = None
    times: int = 1
    delay: float = 0.05
    # mutable trigger state
    hits: int = 0
    fired: int = 0

    def should_fire(self, elapsed: float, rng: random.Random) -> bool:
        self.hits += 1
        if self.fired >= self.times:
            return False
        if self.after is not None and self.hits <= self.after:
            return False
        if self.at is not None and self.hits != self.at:
            return False
        if self.t is not None and elapsed < self.t:
            return False
        if self.p is not None and rng.random() >= self.p:
            return False
        self.fired += 1
        return True


def parse_plan(plan: str) -> List[_Rule]:
    """Parse a plan string; raises ValueError on malformed rules so a typo
    in DYN_FAULT_PLAN fails loudly at startup, not silently as a no-op."""
    rules: List[_Rule] = []
    for raw in plan.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        point, _, spec = raw.partition(":")
        point = point.strip()
        if not point:
            raise ValueError(f"fault rule missing point name: {raw!r}")
        rule = _Rule(point=point)
        saw_times = False
        for item in filter(None, (s.strip() for s in spec.split(","))):
            if "=" in item and item.split("=", 1)[0] in (
                "after", "at", "t", "p", "times", "delay"
            ):
                key, val = item.split("=", 1)
                try:
                    if key in ("after", "at", "times"):
                        setattr(rule, key, int(val))
                        saw_times = saw_times or key == "times"
                    else:
                        setattr(rule, key, float(val))
                except ValueError as e:
                    raise ValueError(f"bad fault spec {item!r} in {raw!r}") from e
            else:
                # bare action, optionally with @t= sugar: "drop@t=2.0"
                action, _, at_t = item.partition("@t=")
                if "=" in action:
                    # a misspelled key ("atfer=3") must fail loudly, not
                    # silently become a never-matching action
                    raise ValueError(f"unknown fault spec key {item!r} in {raw!r}")
                rule.action = action
                if at_t:
                    try:
                        rule.t = float(at_t)
                    except ValueError as e:
                        raise ValueError(f"bad fault spec {item!r} in {raw!r}") from e
        if rule.p is not None and not saw_times:
            rule.times = _UNLIMITED
        rules.append(rule)
    return rules


class FaultInjector:
    """Compiled fault plan. One instance per process (module-level FAULTS);
    hit counting and the probabilistic RNG are deterministic for a given
    (plan, seed) and hit sequence."""

    enabled = True

    def __init__(self, plan: str, seed: int = 0):
        self.plan = plan
        self.seed = seed
        self._rules: Dict[str, List[_Rule]] = {}
        for rule in parse_plan(plan):
            self._rules.setdefault(rule.point, []).append(rule)
        self._rng = random.Random(seed)
        self._t0 = time.monotonic()
        self.fired_log: List[tuple] = []  # (point, action) in firing order

    def arm(self):
        """Restart the t= clock (configure() calls this)."""
        self._t0 = time.monotonic()

    def check(self, point: str) -> Optional[str]:
        """Count a hit on `point`; return the action to apply, or None.
        Synchronous — for sites that cannot await. EVERY rule on the point
        counts every hit (so at=/after= positions stay exact in multi-rule
        plans); when two rules would fire on the same hit, the first wins
        and the later one keeps its budget for a subsequent hit."""
        rules = self._rules.get(point)
        if not rules:
            return None
        elapsed = time.monotonic() - self._t0
        action = None
        for rule in rules:
            if not rule.should_fire(elapsed, self._rng):
                continue
            if action is None:
                action = rule.action
                self.fired_log.append((point, action))
                logger.warning("dynochaos: firing %s:%s (hit %d)",
                               point, action, rule.hits)
            else:
                rule.fired -= 1  # refund: one action per hit
        return action

    async def on(self, point: str) -> Optional[str]:
        """Count a hit; resolve `error`/`delay`/`hang` actions in place.
        Returns the action name for site-interpreted actions, None if
        nothing fired."""
        act = self.check(point)
        if act is None:
            return None
        if act == "error":
            raise FaultError(f"injected fault at {point}")
        if act == "delay":
            delay = next(
                r.delay for r in self._rules[point] if r.action == "delay"
            )
            await asyncio.sleep(delay)
        elif act == "hang":
            await asyncio.sleep(_HANG_SECONDS)
        return act


class _NoopInjector:
    """Zero-cost pass-through installed when no plan is configured. Sites
    short-circuit on `.enabled` so none of these methods run on the hot
    path; they exist for direct callers."""

    __slots__ = ()
    enabled = False

    def check(self, point: str) -> Optional[str]:
        return None

    async def on(self, point: str) -> Optional[str]:
        return None


NOOP = _NoopInjector()


def _from_env():
    from .config import env_bool

    if env_bool("DYN_FAULT_DISABLE"):
        return NOOP
    plan = os.environ.get("DYN_FAULT_PLAN")
    if not plan:
        return NOOP
    seed = int(os.environ.get("DYN_FAULT_SEED", "0"))
    inj = FaultInjector(plan, seed)
    logger.warning("dynochaos ACTIVE: plan=%r seed=%d", plan, seed)
    return inj


def configure(plan: str, seed: int = 0) -> FaultInjector:
    """Install an active injector (tests / in-proc chaos harnesses)."""
    global FAULTS
    inj = FaultInjector(plan, seed)
    inj.arm()
    FAULTS = inj
    return inj


def reset():
    """Restore the environment-derived injector (NOOP when no plan set)."""
    global FAULTS
    FAULTS = _from_env()


#: The process-wide injector. Import the MODULE and read `faults.FAULTS`
#: at call time (configure()/reset() rebind it); never `from ... import
#: FAULTS`, which would freeze the binding.
FAULTS = _from_env()
