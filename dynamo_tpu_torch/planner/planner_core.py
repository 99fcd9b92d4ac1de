"""SLA planner core: observe → predict → size → adjust.

Port of `dynamo_tpu/planner/planner_core.py`, in the role of the reference's SLA planner
(components/planner/src/dynamo/planner/utils/planner_core.py:221-583):
every `adjustment_interval` seconds it observes frontend metrics (request
rate, ISL/OSL, TTFT/ITL), corrects its performance model against reality
(p/d correction factors), predicts next-interval load, computes how many
prefill and decode replicas meet the TTFT/ITL SLAs from profiled
interpolators, and asks a connector to scale. One deviation: the reference
queries a Prometheus server; here the planner scrapes the frontend's
/metrics endpoint directly and differences counters/histograms between
intervals (same averages, one less moving part).
"""

from __future__ import annotations

import asyncio
import logging
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol, Tuple

from ..runtime.backoff import Backoff, retry_async
from ..runtime.config import _env, env_bool
from ..runtime.metrics import SCHED_EST_DECODE_TOK_S, SCHED_EST_PREFILL_TOK_S
from .load_predictor import BasePredictor, make_predictor
from .perf_interpolation import DecodeInterpolator, PrefillInterpolator

logger = logging.getLogger(__name__)


@dataclass
class SlaArgs:
    ttft: float = 0.5  # target time-to-first-token, seconds
    itl: float = 0.05  # target inter-token latency, seconds
    adjustment_interval: float = 60.0  # seconds between scaling decisions
    prefill_engine_num_chips: int = 1
    decode_engine_num_chips: int = 1
    max_chip_budget: int = 64
    min_endpoint: int = 1
    load_predictor: str = "constant"
    no_correction: bool = False
    # -- loop robustness (docs/autoscaling.md) -------------------------- #
    # metrics scrape: bounded attempts, each under a timeout, backoff
    # between — a hung /metrics endpoint must cost one interval, not the
    # whole loop
    scrape_timeout: float = 5.0
    scrape_retries: int = 3
    # observations older than this never reach the scaling math: on scrape
    # failure the planner HOLDS rather than re-consuming a stale interval
    # average (0 = default of 2.5 × adjustment_interval)
    metrics_max_age: float = 0.0
    # decision governor: a noisy interval must not flap the fleet
    cooldown_intervals: int = 1    # intervals to hold after an applied change
    max_step: int = 2              # max replica delta per decision, per role
    scale_down_stable_intervals: int = 2  # consecutive below-target intervals
    #                                       required before stepping down
    # frontend role (docs/frontend_scaleout.md): with N > 0 every applied
    # worker target also sizes the frontend tier to ceil((p + d) / N)
    # stateless replicas — a monotone function of the governed worker
    # target, so it inherits the governor's cooldown/hysteresis and adds
    # no flapping mode of its own. 0 = frontends not planner-managed.
    workers_per_frontend: int = 0
    # role morphing (docs/autoscaling.md "Role morphing"): under load
    # skew (one role's ask up, the other's down) convert a live worker
    # (engine.morph: drain via tail-migration, flip discovery, re-warm)
    # instead of cold-spawning — effective only when the connector
    # exposes morph_replicas, and only while the priced morph cost beats
    # the cold-spawn cost on time-to-SLA-recovery.
    morph_enabled: bool = True
    morph_cost_s: float = 3.0   # seed morph wall-clock (drain+flip+rewarm)
    spawn_cost_s: float = 30.0  # seed cold-spawn wall-clock (boot+warmup)
    # colocate arm: at sustained floor-level traffic, morph the decode
    # worker to role `both` and retire the dedicated prefill worker.
    colocate: bool = False

    def effective_metrics_max_age(self) -> float:
        return self.metrics_max_age or 2.5 * self.adjustment_interval

    @classmethod
    def from_env(cls, **overrides) -> "SlaArgs":
        """Default args layered with the DYN_PLANNER_* env knobs (all in
        ENV_REGISTRY, rendered to docs/configuration.md); explicit
        keyword overrides win."""
        args = cls(
            scrape_timeout=_env("DYN_PLANNER_SCRAPE_TIMEOUT", cls.scrape_timeout, float),
            scrape_retries=_env("DYN_PLANNER_SCRAPE_RETRIES", cls.scrape_retries, int),
            metrics_max_age=_env(
                "DYN_PLANNER_METRICS_MAX_AGE_S", cls.metrics_max_age, float
            ),
            cooldown_intervals=_env(
                "DYN_PLANNER_COOLDOWN_INTERVALS", cls.cooldown_intervals, int
            ),
            max_step=_env("DYN_PLANNER_MAX_STEP", cls.max_step, int),
            scale_down_stable_intervals=_env(
                "DYN_PLANNER_SCALE_DOWN_STABLE_INTERVALS",
                cls.scale_down_stable_intervals, int,
            ),
            workers_per_frontend=_env(
                "DYN_PLANNER_WORKERS_PER_FRONTEND",
                cls.workers_per_frontend, int,
            ),
            morph_enabled=env_bool("DYN_PLANNER_MORPH", cls.morph_enabled),
            morph_cost_s=_env("DYN_PLANNER_MORPH_COST_S", cls.morph_cost_s, float),
            spawn_cost_s=_env("DYN_PLANNER_SPAWN_COST_S", cls.spawn_cost_s, float),
            colocate=env_bool("DYN_PLANNER_COLOCATE", cls.colocate),
        )
        for k, v in overrides.items():
            setattr(args, k, v)
        return args


@dataclass
class Metrics:
    """Averages observed over the last adjustment interval."""

    num_req: float = math.nan  # requests served in the interval
    isl: float = math.nan
    osl: float = math.nan
    ttft: float = math.nan  # seconds
    itl: float = math.nan  # seconds
    request_duration: float = math.nan  # seconds

    def is_valid(self) -> bool:
        return all(
            not math.isnan(v)
            for v in (self.num_req, self.isl, self.osl, self.ttft, self.itl)
        ) and self.num_req > 0


class MetricsSource(Protocol):
    async def read(self) -> Metrics: ...


class WorkerCounts(Protocol):
    async def count(self) -> tuple[int, int]:
        """(prefill_workers, decode_workers) currently live."""
        ...


class PlannerConnector(Protocol):
    async def set_replicas(self, prefill: int, decode: int,
                           frontend: Optional[int] = None) -> None:
        """`frontend` is only passed when the planner manages the frontend
        tier (SlaArgs.workers_per_frontend > 0); connectors that predate
        the role keep working in the default mode."""
        ...


class RoleEstimates:
    """Planner-side consumer of the per-role marginal-throughput gauges
    workers publish on their metrics topics (sched_est_prefill_tok_s /
    sched_est_decode_tok_s, runtime/metrics.py): folds the freshest
    per-worker values into fleet means so the re-role arm's pricing is
    grounded in observed throughput, not guessed. Advisory — while no
    worker has published, the planner prices from its static seed costs
    (SlaArgs.morph_cost_s / spawn_cost_s) alone."""

    def __init__(self):
        # worker_id -> (prefill_tok_s, decode_tok_s, observed_at)
        self._by_worker: Dict[int, Tuple[float, float, float]] = {}

    def observe(self, worker_id: int, stats: dict,
                now: Optional[float] = None) -> None:
        pf = stats.get(SCHED_EST_PREFILL_TOK_S)
        dc = stats.get(SCHED_EST_DECODE_TOK_S)
        if pf is None and dc is None:
            return
        now = time.monotonic() if now is None else now
        self._by_worker[int(worker_id)] = (
            float(pf or 0.0), float(dc or 0.0), now,
        )

    def fleet_tok_s(self, max_age_s: float = 120.0
                    ) -> Tuple[Optional[float], Optional[float]]:
        """(mean prefill tok/s, mean decode tok/s) over fresh publishes;
        None per side while no worker has reported a warm estimate."""
        now = time.monotonic()
        pfs = [p for p, _d, at in self._by_worker.values()
               if p > 0 and now - at <= max_age_s]
        dcs = [d for _p, d, at in self._by_worker.values()
               if d > 0 and now - at <= max_age_s]
        return (
            sum(pfs) / len(pfs) if pfs else None,
            sum(dcs) / len(dcs) if dcs else None,
        )


@dataclass
class ScaleDecision:
    """One governed planner decision, recorded every interval (including
    holds) — the soak's no-flapping assertion reads this log."""

    at: float  # time.monotonic() when decided
    raw: Optional[Tuple[int, int]]  # model-requested (p, d); None on a hold
    target: Tuple[int, int]  # governed target the connector is held to
    applied: bool  # connector called with a CHANGED target this interval
    reason: str  # scale-up | scale-down | steady | hold:* | connector-error


class Planner:
    def __init__(
        self,
        args: SlaArgs,
        prefill_interpolator: PrefillInterpolator,
        decode_interpolator: DecodeInterpolator,
        metrics_source: MetricsSource,
        workers: WorkerCounts,
        connector: PlannerConnector,
    ):
        self.args = args
        self.prefill_interpolator = prefill_interpolator
        self.decode_interpolator = decode_interpolator
        self.metrics_source = metrics_source
        self.workers = workers
        self.connector = connector

        self.num_req_predictor = make_predictor(args.load_predictor)
        self.isl_predictor = make_predictor(args.load_predictor)
        self.osl_predictor = make_predictor(args.load_predictor)
        self.p_correction_factor = 1.0
        self.d_correction_factor = 1.0
        self.last_metrics = Metrics()
        self._stop = asyncio.Event()
        # decision-governor state: all mutated only from the planner's own
        # loop task (run → make_adjustments), per GUARDED_STATE
        self._target: Optional[Tuple[int, int]] = None  # last applied target
        self._intervals_since_change = 10**9
        # PER-ROLE consecutive below-target ask counters: one role's noisy
        # interval must not pre-arm the other role's scale-down
        self._below_streak = [0, 0]  # [prefill, decode]
        self._observed_at: Optional[float] = None  # monotonic, last GOOD read
        self.decision_log: List[ScaleDecision] = []
        self.scrape_failures = 0  # consecutive; resets on a good read
        # role morphing (docs/autoscaling.md "Role morphing"): observed
        # per-role throughput (fed by the metrics consumer) prices the
        # re-role arm; the colocate streak counts consecutive floor-level
        # intervals before the colocate arm fires.
        self.role_estimates = RoleEstimates()
        self._colocate_streak = 0

    # -- observe -----------------------------------------------------------
    async def observe_metrics(self) -> bool:
        """Scrape the metrics source: bounded attempts under a per-attempt
        timeout, backoff between. Returns False when every attempt failed —
        last_metrics is left untouched and its age keeps growing, so the
        staleness gate (not a NaN average) is what the scaling math sees."""
        try:
            m = await retry_async(
                lambda: asyncio.wait_for(
                    self.metrics_source.read(), timeout=self.args.scrape_timeout
                ),
                attempts=self.args.scrape_retries,
                backoff=Backoff.seeded("planner.scrape", base=0.1, max_delay=1.0),
                desc="metrics scrape", log=logger,
            )
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — scrape must never kill the loop
            self.scrape_failures += 1
            logger.error("metrics scrape exhausted retries: %s", e)
            return False
        self.scrape_failures = 0
        self.last_metrics = m
        self._observed_at = time.monotonic()
        logger.info(
            "observed num_req=%.1f isl=%.1f osl=%.1f ttft=%.3fs itl=%.4fs",
            m.num_req, m.isl, m.osl, m.ttft, m.itl,
        )
        if m.is_valid():
            # an empty/invalid interval must not pollute the predictors
            # (a moving average dragged toward 0 by a quiet minute would
            # scale-to-min the moment traffic resumes)
            self.num_req_predictor.add_data_point(m.num_req)
            self.isl_predictor.add_data_point(m.isl)
            self.osl_predictor.add_data_point(m.osl)
        return True

    def observation_age(self) -> float:
        if self._observed_at is None:
            return math.inf
        return time.monotonic() - self._observed_at

    # -- correct (planner_core.py:383-441) ---------------------------------
    async def update_correction_factors(self) -> None:
        m = self.last_metrics
        if self.args.no_correction or not m.is_valid():
            return
        _, n_decode = await self.workers.count()
        expect_ttft = self.prefill_interpolator.interpolate_ttft(m.isl)
        if expect_ttft > 0:
            self.p_correction_factor = m.ttft / expect_ttft
        concurrency = (
            m.num_req / max(n_decode, 1)
            * m.request_duration / self.args.adjustment_interval
            if not math.isnan(m.request_duration)
            else 1.0
        )
        expect_itl = self.decode_interpolator.interpolate_itl(
            concurrency=concurrency, context_length=m.isl + m.osl / 2
        )
        if expect_itl > 0:
            self.d_correction_factor = m.itl / expect_itl
        logger.info(
            "correction factors: ttft=%.3f itl=%.3f",
            self.p_correction_factor, self.d_correction_factor,
        )

    # -- predict ------------------------------------------------------------
    def predict_load(self) -> tuple[Optional[float], Optional[float], Optional[float]]:
        return (
            self.num_req_predictor.predict_next(),
            self.isl_predictor.predict_next(),
            self.osl_predictor.predict_next(),
        )

    # -- size (planner_core.py:287-380) --------------------------------------
    def compute_replica_requirements(
        self, next_num_req: float, next_isl: float, next_osl: float
    ) -> tuple[int, int]:
        a = self.args
        # prefill: token throughput needed, derated by observed TTFT headroom
        # (queueing shows up as p_correction_factor > 1)
        pred_prefill_thpt = (
            next_num_req * next_isl / a.adjustment_interval
            * min(1.0, self.p_correction_factor)
        )
        per_p_replica = (
            self.prefill_interpolator.interpolate_thpt_per_chip(next_isl)
            * a.prefill_engine_num_chips
        )
        next_p = math.ceil(pred_prefill_thpt / max(per_p_replica, 1e-9))

        # decode: tighten the ITL target by the observed miss ratio, then find
        # the best per-chip throughput that still meets it at predicted context
        corrected_itl = (
            a.itl / self.d_correction_factor
            if self.d_correction_factor > 0
            else a.itl
        )
        thpt_per_chip, _, _ = self.decode_interpolator.find_best_throughput_per_chip(
            itl=corrected_itl, context_length=next_isl + next_osl / 2
        )
        pred_decode_thpt = next_num_req * next_osl / a.adjustment_interval
        next_d = math.ceil(
            pred_decode_thpt / max(thpt_per_chip * a.decode_engine_num_chips, 1e-9)
        )

        next_p = max(next_p, a.min_endpoint)
        next_d = max(next_d, a.min_endpoint)
        # the inputs at full precision and the ask before the chip budget,
        # so a reader can redo the arithmetic from the log
        logger.info(
            "sizing: num_req=%r isl=%r osl=%r p_correction=%r d_correction=%r "
            "-> p=%d d=%d",
            float(next_num_req), float(next_isl), float(next_osl),
            float(self.p_correction_factor), float(self.d_correction_factor),
            next_p, next_d,
        )

        # chip budget: scale down proportionally (planner_core.py:358-380),
        # then walk down to the hard budget (round()/min_endpoint can leave
        # the proportional result one replica over)
        total = next_p * a.prefill_engine_num_chips + next_d * a.decode_engine_num_chips
        if total > a.max_chip_budget:
            scale = a.max_chip_budget / total
            next_p = max(a.min_endpoint, round(next_p * scale))
            next_d = max(
                a.min_endpoint,
                math.floor(
                    (a.max_chip_budget - next_p * a.prefill_engine_num_chips)
                    / a.decode_engine_num_chips
                ),
            )

            def chips() -> int:
                return (next_p * a.prefill_engine_num_chips
                        + next_d * a.decode_engine_num_chips)

            while chips() > a.max_chip_budget and next_p > a.min_endpoint:
                next_p -= 1
            while chips() > a.max_chip_budget and next_d > a.min_endpoint:
                next_d -= 1
            if chips() > a.max_chip_budget:
                logger.warning(
                    "min_endpoint floors alone exceed the chip budget "
                    "(%d chips > %d)", chips(), a.max_chip_budget,
                )
            logger.warning(
                "chip budget %d exceeded (%d); scaled to p=%d d=%d",
                a.max_chip_budget, total, next_p, next_d,
            )
        return next_p, next_d

    # -- govern (hysteresis / cooldown / bounded step) ------------------------
    def _record(self, raw, target, applied, reason) -> ScaleDecision:
        dec = ScaleDecision(time.monotonic(), raw, target, applied, reason)
        self.decision_log.append(dec)
        logger.info(
            "planner decision: raw=%s target=%s applied=%s (%s)",
            raw, target, applied, reason,
        )
        return dec

    def _govern(self, raw: Tuple[int, int], cur: Tuple[int, int]
                ) -> Tuple[Tuple[int, int], str]:
        """Turn the model's raw replica ask into a governed target:

        * bounded step — at most `max_step` replicas per role per decision;
        * scale-down hysteresis — the ask must sit below the current target
          for `scale_down_stable_intervals` CONSECUTIVE intervals before a
          step down (one quiet interval can't shed capacity);
        * cooldown — after any applied change, hold `cooldown_intervals`
          intervals before another (structurally rules out A→B→A flapping
          inside the window).

        Scale-up is only cooldown-gated (never hysteresis-gated): restoring
        SLA outranks fleet stability."""
        a = self.args
        step = max(1, a.max_step)
        govern = [
            max(cur[i] - step, min(cur[i] + step, raw[i])) for i in (0, 1)
        ]
        held_down = False
        for i in (0, 1):
            # per-role streaks: role i steps down only after ITS OWN ask
            # sat below target for scale_down_stable_intervals in a row
            self._below_streak[i] = (
                self._below_streak[i] + 1 if raw[i] < cur[i] else 0
            )
            if govern[i] < cur[i] and \
                    self._below_streak[i] < a.scale_down_stable_intervals:
                govern[i] = cur[i]
                held_down = True
        p, d = govern
        if (p, d) == cur:
            return cur, ("hold:hysteresis" if held_down else "steady")
        # `<=`, not `<`: _intervals_since_change was already incremented for
        # THIS interval, so cooldown_intervals=N must hold decisions on the
        # N intervals after a change (with `<` the default of 1 held none)
        if self._intervals_since_change <= a.cooldown_intervals:
            return cur, "hold:cooldown"
        if p > cur[0] or d > cur[1]:
            # mixed asks (one role up, one down) classify as scale-up; the
            # down half already passed its own hysteresis gate above
            return (p, d), "scale-up"
        return (p, d), "scale-down"

    async def _apply_target(self, target: Tuple[int, int]) -> bool:
        """Push a target through the connector with bounded retries: a
        transient connector failure (fault plan, spawn blip, discovery
        reset) must not strand the replica count — on final failure the
        target is NOT committed, so the next interval re-decides and
        re-asserts it."""
        kwargs = {}
        if self.args.workers_per_frontend > 0:
            # frontend tier rides every applied worker target: stateless
            # replicas sized to the fleet (docs/frontend_scaleout.md)
            kwargs["frontend"] = max(
                1, math.ceil(sum(target) / self.args.workers_per_frontend)
            )
        try:
            await retry_async(
                lambda: self.connector.set_replicas(*target, **kwargs),
                attempts=3,
                backoff=Backoff.seeded("planner.connector", base=0.1, max_delay=1.0),
                desc=f"connector set_replicas{target}", log=logger,
            )
            return True
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — surfaced in the log, retried next interval
            logger.error("connector failed after retries: %s", e)
            return False

    # -- re-role (docs/autoscaling.md "Role morphing") ------------------------
    def _plan_re_role(self, cur: Tuple[int, int], target: Tuple[int, int]
                      ) -> Tuple[int, Optional[str], Optional[str]]:
        """Under genuine load skew — the governed target moves one role UP
        and the other DOWN — convert live workers (morph) instead of
        cold-spawning, when the priced morph beats a spawn on
        time-to-SLA-recovery. Returns (k, from_role, to_role): k morphs to
        request, (0, None, None) when the spawn/kill path should run as
        usual. The governor already bounded and hysteresis-gated both
        deltas, so the morph count inherits every stability property."""
        a = self.args
        if not a.morph_enabled:
            return 0, None, None
        if getattr(self.connector, "morph_replicas", None) is None:
            return 0, None, None
        dp, dd = target[0] - cur[0], target[1] - cur[1]
        if dp == 0 or dd == 0 or (dp > 0) == (dd > 0):
            return 0, None, None  # not a skew: plain scale handles it
        if a.morph_cost_s >= a.spawn_cost_s:
            # priced out: a morph (drain + flip + re-warm) recovers SLA in
            # morph_cost_s vs spawn_cost_s for a cold replica — when that
            # inverts, spawning wins and the arm stands down
            return 0, None, None
        est_p, est_d = self.role_estimates.fleet_tok_s()
        logger.info(
            "re-role priced: morph=%.1fs beats spawn=%.1fs "
            "(observed prefill=%s decode=%s tok/s)",
            a.morph_cost_s, a.spawn_cost_s,
            f"{est_p:.0f}" if est_p else "cold",
            f"{est_d:.0f}" if est_d else "cold",
        )
        k = min(abs(dp), abs(dd))
        if dp > 0:
            return k, "decode", "prefill"
        return k, "prefill", "decode"

    async def _apply_morph(self, from_role: str, to_role: str, k: int) -> bool:
        """Push k re-roles through the connector with bounded retries —
        the same uncommitted-on-failure contract as _apply_target: on
        final failure nothing is committed and the next interval
        re-decides (the connector's own morph rollback restored any
        half-flipped worker to its original role)."""
        try:
            await retry_async(
                lambda: self.connector.morph_replicas(from_role, to_role, k),
                attempts=3,
                backoff=Backoff.seeded("planner.connector", base=0.1, max_delay=1.0),
                desc=f"connector morph_replicas {from_role}->{to_role} x{k}",
                log=logger,
            )
            return True
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — surfaced in the log, re-decided next interval
            logger.error("connector morph failed after retries: %s", e)
            return False

    async def _maybe_colocate(self, raw: Tuple[int, int],
                              cur: Tuple[int, int]) -> bool:
        """Colocate arm (DYN_PLANNER_COLOCATE): after the raw ask has sat
        at the min_endpoint floor for scale_down_stable_intervals
        consecutive intervals (outside cooldown), morph the decode worker
        to role `both` and retire the dedicated prefill worker — one
        worker serves both roles at low traffic. The connector's
        colocate() returns False when already colocated (no-op)."""
        a = self.args
        colocate = getattr(self.connector, "colocate", None)
        if not a.colocate or colocate is None:
            self._colocate_streak = 0
            return False
        if raw[0] > a.min_endpoint or raw[1] > a.min_endpoint:
            self._colocate_streak = 0
            return False
        self._colocate_streak += 1
        if self._colocate_streak < a.scale_down_stable_intervals:
            return False
        if self._intervals_since_change <= a.cooldown_intervals:
            return False
        try:
            did = await colocate()
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — retried next interval
            logger.warning("connector colocate failed: %s", e)
            return False
        if not did:
            return False
        # a colocation is a scale event on BOTH roles
        self._intervals_since_change = 0
        self._colocate_streak = 0
        self._record(raw, cur, True, "re-role:colocate")
        return True

    # -- adjust ---------------------------------------------------------------
    async def make_adjustments(self) -> Optional[tuple[int, int]]:
        if self._target is None:
            self._target = await self.workers.count()
        cur = self._target
        self._intervals_since_change += 1
        floor = self.args.min_endpoint
        if cur[0] < floor or cur[1] < floor:
            # cold start (or below-floor fleet): bring the fleet up to the
            # min_endpoint floor WITHOUT waiting for traffic — with zero
            # workers no model serves, so no request ever arrives and a
            # traffic-gated planner would deadlock at zero forever
            target = (max(cur[0], floor), max(cur[1], floor))
            if not await self._apply_target(target):
                self._record(None, cur, False, "connector-error")
                return None
            self._target = target
            self._intervals_since_change = 0
            self._record(None, target, True, "bootstrap:min-endpoint")
            return target
        if self.observation_age() > self.args.effective_metrics_max_age():
            # scrapes kept failing: the last averages are stale — hold the
            # current target rather than steer the fleet on old data
            self._record(None, cur, False, "hold:stale-metrics")
            return None
        if not self.last_metrics.is_valid():
            # first interval / zero-request interval: hold the last
            # decision (never scale-to-min on a quiet minute)
            self._record(None, cur, False, "hold:no-traffic")
            return None
        await self.update_correction_factors()
        num_req, isl, osl = self.predict_load()
        if num_req is None or isl is None or osl is None:
            self._record(None, cur, False, "hold:no-prediction")
            return None
        raw = self.compute_replica_requirements(num_req, isl, osl)
        target, reason = self._govern(raw, cur)
        if target == cur:
            if await self._maybe_colocate(raw, cur):
                return cur
            self._record(raw, cur, False, reason)
            return None
        self._colocate_streak = 0
        # re-role arm: under skew, morph live workers across roles instead
        # of cold-spawning; any residual delta beyond the morphed pairs
        # still rides the plain spawn/kill path. A failed step commits
        # nothing — the next interval re-decides and re-asserts.
        k, from_role, to_role = self._plan_re_role(cur, target)
        if k:
            if not await self._apply_morph(from_role, to_role, k):
                self._record(raw, cur, False, "connector-error")
                return None
            reason = f"re-role:{from_role}->{to_role}"
            if abs(target[0] - cur[0]) != k or abs(target[1] - cur[1]) != k:
                if not await self._apply_target(target):
                    self._record(raw, cur, False, "connector-error")
                    return None
                reason += "+scale"
        elif not await self._apply_target(target):
            self._record(raw, cur, False, "connector-error")
            return None
        self._target = target
        # an applied morph counts as a scale event on BOTH roles — the
        # shared cooldown window structurally rules out A→B→A re-role
        # flapping just as it does for plain scaling
        self._intervals_since_change = 0
        for i in (0, 1):
            if target[i] < cur[i]:
                # an applied step down re-arms that role's hysteresis:
                # further shedding needs fresh consecutive confirmation
                self._below_streak[i] = 0
        self._record(raw, target, True, reason)
        return target

    async def _reconcile_connector(self) -> None:
        """Connectors that manage real processes expose reconcile(): re-
        assert the committed target every interval so a replica that died
        (or a spawn that failed mid-apply) is replaced without waiting for
        the next load-driven decision."""
        reconcile = getattr(self.connector, "reconcile", None)
        if reconcile is None or self._target is None:
            return
        try:
            await reconcile()
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — retried next interval
            logger.warning("connector reconcile failed: %s", e)

    async def run(self) -> None:
        """Planner loop: sleep interval, observe, adjust — until stop()."""
        while not self._stop.is_set():
            try:
                await asyncio.wait_for(
                    self._stop.wait(), timeout=self.args.adjustment_interval
                )
                break
            except asyncio.TimeoutError:
                pass
            try:
                await self.observe_metrics()
                await self.make_adjustments()
                await self._reconcile_connector()
            except Exception:  # noqa: BLE001 — planner must survive blips
                logger.exception("planner iteration failed")

    def stop(self) -> None:
        self._stop.set()
