"""SLA plumbing: targets, policy selection, and deadline math.

`DYN_SCHED_POLICY` selects the step-scheduling policy:

  fifo  (default) — the legacy behavior, bit-for-bit: prefill candidates
        sort by admission order, the chunk cap is static, no deferral.
        The escape hatch stays default-off-safe. Sole exception: the
        batch-kind anti-starvation guard (policy.py:pick_batch_kind) is
        a fairness bug fix active under both policies — it only changes
        behavior in mixed-kind traffic that would otherwise starve.
  sla   — the StepPlanner (policy.py): EDF prefill ordering against TTFT
        deadlines, ITL-budgeted chunk sizing, starvation guard.

`DYN_SLA_TTFT_MS` / `DYN_SLA_ITL_MS` are the targets the sla policy
spends. Per-request `priority` (nvext.priority -> PreprocessedRequest ->
_Slot) scales the TTFT target: each +1 halves it, each -1 doubles it, so
deadlines — not queue position — encode urgency.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)


def _env_float(name: str, default: float) -> float:
    """Lenient float parsing for an env knob: unset, empty or unparseable
    values fall back to the default with a warning (a typo'd knob must
    degrade, not take the process down)."""
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("%s=%r is not a number; using %s", name, raw, default)
        return default

POLICIES = ("fifo", "sla")

#: dispatches a candidate may be skipped (by kind filtering or EDF
#: reordering) before the starvation guard forces it through
STARVE_DISPATCHES = 16


@dataclasses.dataclass(frozen=True)
class SlaConfig:
    policy: str = "fifo"
    ttft_target_ms: float = 2000.0
    itl_target_ms: float = 0.0  # 0 = no ITL budget
    starve_dispatches: int = STARVE_DISPATCHES

    @classmethod
    def from_env(
        cls,
        policy: Optional[str] = None,
        ttft_target_ms: Optional[float] = None,
        itl_target_ms: Optional[float] = None,
    ) -> "SlaConfig":
        """Explicit (EngineConfig/CLI) values win; env fills the rest."""
        if policy is None:
            policy = os.environ.get("DYN_SCHED_POLICY") or "fifo"
        policy = policy.strip().lower()
        if policy not in POLICIES:
            # an unknown policy must not take the serving path down — the
            # legacy behavior is the safe spelling of "I don't know"
            logger.warning(
                "DYN_SCHED_POLICY=%r unknown (want one of %s); using fifo",
                policy, "/".join(POLICIES),
            )
            policy = "fifo"
        if ttft_target_ms is None:
            ttft_target_ms = _env_float("DYN_SLA_TTFT_MS", 2000.0)
        if itl_target_ms is None:
            itl_target_ms = _env_float("DYN_SLA_ITL_MS", 0.0)
        return cls(
            policy=policy,
            ttft_target_ms=max(float(ttft_target_ms), 1.0),
            itl_target_ms=max(float(itl_target_ms), 0.0),
        )

    def deadline(self, arrival_s: float, priority: int = 0) -> float:
        """TTFT deadline (monotonic seconds) for a request that arrived at
        `arrival_s`: arrival + target, halved per +1 priority."""
        target_s = (self.ttft_target_ms / 1000.0) * (0.5 ** int(priority))
        return arrival_s + target_s
