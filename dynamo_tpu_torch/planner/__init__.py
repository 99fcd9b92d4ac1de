"""SLA-driven autoscaling planner (reference: components/planner), ported
from `dynamo_tpu/planner`.

Observe frontend metrics → predict load → size prefill/decode replica
counts from profiled interpolators → scale via a connector. See
planner_core.py for the loop, profiler.py for the sweep that produces the
interpolation profiles, connector.py for scaling backends.
"""

from .connector import (
    DiscoveryWorkerCounts,
    LocalProcessConnector,
    NoopConnector,
    NoopMorphConnector,
    VirtualConnector,
)
from .load_predictor import (
    ARPredictor,
    ConstantPredictor,
    MovingAveragePredictor,
    make_predictor,
)
from .metrics_source import FrontendMetricsSource
from .perf_interpolation import DecodeInterpolator, PrefillInterpolator
from .planner_core import Metrics, Planner, ScaleDecision, SlaArgs

__all__ = [
    "ARPredictor",
    "ConstantPredictor",
    "DecodeInterpolator",
    "DiscoveryWorkerCounts",
    "FrontendMetricsSource",
    "LocalProcessConnector",
    "Metrics",
    "MovingAveragePredictor",
    "NoopConnector",
    "NoopMorphConnector",
    "Planner",
    "PrefillInterpolator",
    "ScaleDecision",
    "SlaArgs",
    "VirtualConnector",
    "make_predictor",
]
