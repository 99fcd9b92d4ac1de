"""SLA-aware prefill/decode step scheduler (host-side policy, stdlib only).

Owns every "what runs this step" decision of the engine step loop: which
waiting/partial slots get prefill chunks, how large the chunk budget is,
and whether prefill defers to protect the decode ITL budget. Port of
`dynamo_tpu/engine/scheduler/`.
"""

from .cost_model import CostModel
from .policy import MixedPlan, PrefillPlan, StepPlanner
from .sla import SlaConfig

__all__ = ["CostModel", "MixedPlan", "PrefillPlan", "SlaConfig", "StepPlanner"]
