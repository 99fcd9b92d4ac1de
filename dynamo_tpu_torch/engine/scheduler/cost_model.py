"""Online per-shape step-time model.

Fed by the engine's existing `_timed` dispatch instrumentation: every
device dispatch reports (kind, bucket, lanes, seconds) and the model keeps
an EWMA per shape key. The step planner reads predictions on the event
loop while observations land on the device-executor thread, so
the table is lock-guarded (GUARDED_STATE: `CostModel._ewma`).

Shape keys mirror the engine's bounded compile-variant space:

  ("prefill", bucket, lanes)  — batched chunked prefill dispatches
  ("block", K, B)             — fused K-step decode blocks
  ("block_lora"/"block_guided", ...) — the variant dispatch kinds

An unknown shape predicts by scaling the nearest same-kind observation by
token volume (bucket * lanes); a kind never observed predicts None — the
planner treats "unknown" as "no constraint" rather than guessing.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

Key = Tuple[str, int, int]


class CostModel:
    def __init__(self, alpha: float = 0.25):
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        # key -> (ewma_seconds, n_observations)
        self._ewma: Dict[Key, Tuple[float, int]] = {}

    def observe(self, kind: str, bucket: int, lanes: int, seconds: float) -> None:
        """One dispatch landed: fold its wall time into the shape's EWMA.
        Runs on the device-executor thread (the `_timed` wrapper)."""
        if seconds < 0:
            return
        key = (kind, int(bucket), int(lanes))
        with self._lock:
            cur = self._ewma.get(key)
            if cur is None:
                self._ewma[key] = (float(seconds), 1)
            else:
                val, n = cur
                # the first few samples move fast (warmup/compile outliers
                # wash out), then settle at alpha
                a = max(self.alpha, 1.0 / (n + 1)) if n < 8 else self.alpha
                self._ewma[key] = (val + a * (float(seconds) - val), n + 1)

    def predict(self, kind: str, bucket: int, lanes: int) -> Optional[float]:
        """Predicted seconds for one dispatch of this shape; None when the
        kind has never been observed."""
        key = (kind, int(bucket), int(lanes))
        with self._lock:
            cur = self._ewma.get(key)
            if cur is not None:
                return cur[0]
            # nearest same-kind shape, scaled by token volume
            want = max(int(bucket) * int(lanes), 1)
            best = None
            for (k, b, l), (val, _n) in self._ewma.items():
                if k != kind:
                    continue
                have = max(b * l, 1)
                d = abs(have - want)
                if best is None or d < best[0]:
                    best = (d, val, have)
            if best is None:
                return None
            _, val, have = best
            return val * (want / have)

    def per_token(self, kind: str) -> Optional[float]:
        """Mean observed seconds per token across this kind's shapes
        (observation-weighted) — the queue-drain rate estimate behind
        `estimated local TTFT` in the disagg router."""
        with self._lock:
            num = den = 0.0
            for (k, b, l), (val, n) in self._ewma.items():
                if k != kind:
                    continue
                toks = max(b * l, 1)
                num += (val / toks) * n
                den += n
            return (num / den) if den else None

    def snapshot(self) -> Dict[str, float]:
        """Shape table for stats/debugging: {"kind bxl": ewma_ms}."""
        with self._lock:
            return {
                f"{k} {b}x{l}": round(val * 1000.0, 3)
                for (k, b, l), (val, _n) in sorted(self._ewma.items())
            }

    def n_observations(self) -> int:
        with self._lock:
            return sum(n for _, n in self._ewma.values())
