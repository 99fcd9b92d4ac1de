"""Load predictors for the SLA planner.

Port of `dynamo_tpu/planner/load_predictor.py`, in the role of the reference's planner load predictors
(components/planner/src/dynamo/planner/utils/load_predictor.py:36-177):
each wraps a sliding window of observed per-interval load (request rate,
ISL, OSL) and predicts the next interval. The reference offers
Constant/ARIMA/Prophet; here the ARIMA/Prophet roles are played by a
dependency-free least-squares AR(p) model (statsmodels/prophet are not in
the image, and an AR fit captures the same short-horizon trend the planner
actually consumes).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional

import numpy as np


class BasePredictor(ABC):
    def __init__(self, minimum_data_points: int = 5):
        self.minimum_data_points = minimum_data_points
        self.data_buffer: List[float] = []

    def add_data_point(self, value: float) -> None:
        if value is None or (isinstance(value, float) and np.isnan(value)):
            return
        self.data_buffer.append(float(value))

    def get_last_value(self) -> Optional[float]:
        return self.data_buffer[-1] if self.data_buffer else None

    @abstractmethod
    def predict_next(self) -> Optional[float]: ...


class ConstantPredictor(BasePredictor):
    """Next load = last observed load."""

    def predict_next(self) -> Optional[float]:
        return self.get_last_value()


class MovingAveragePredictor(BasePredictor):
    """Next load = mean of the last `window_size` observations."""

    def __init__(self, window_size: int = 10, minimum_data_points: int = 1):
        super().__init__(minimum_data_points)
        self.window_size = window_size

    def predict_next(self) -> Optional[float]:
        if not self.data_buffer:
            return None
        w = self.data_buffer[-self.window_size :]
        return float(np.mean(w))


class ARPredictor(BasePredictor):
    """Least-squares AR(p) one-step-ahead forecast over a sliding window
    (the ARIMA role, load_predictor.py:79-117, without statsmodels)."""

    def __init__(
        self, order: int = 3, window_size: int = 100, minimum_data_points: int = 5
    ):
        super().__init__(minimum_data_points)
        self.order = order
        self.window_size = window_size

    def add_data_point(self, value: float) -> None:
        super().add_data_point(value)
        if len(self.data_buffer) > self.window_size:
            self.data_buffer = self.data_buffer[-self.window_size :]

    def predict_next(self) -> Optional[float]:
        n = len(self.data_buffer)
        if n == 0:
            return None
        if n < max(self.minimum_data_points, self.order + 1):
            return self.get_last_value()
        x = np.asarray(self.data_buffer, np.float64)
        p = self.order
        # design matrix of lagged values + intercept
        rows = n - p
        X = np.ones((rows, p + 1))
        for i in range(p):
            X[:, i + 1] = x[i : i + rows]
        y = x[p:]
        coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        pred = coef[0] + float(np.dot(coef[1:], x[-p:]))
        # an AR fit on a short noisy window can extrapolate wildly; clamp to
        # a sane band around the observed range (planner safety)
        lo, hi = float(x.min()), float(x.max())
        span = max(hi - lo, abs(hi) * 0.1, 1e-9)
        return float(np.clip(pred, lo - span, hi + span))


PREDICTORS = {
    "constant": ConstantPredictor,
    "moving-average": MovingAveragePredictor,
    "ar": ARPredictor,
    # reference names, mapped to the closest native predictor
    "arima": ARPredictor,
    "prophet": ARPredictor,
}


def make_predictor(kind: str, **kwargs) -> BasePredictor:
    if kind not in PREDICTORS:
        raise ValueError(f"unknown predictor {kind!r}; choose from {sorted(PREDICTORS)}")
    return PREDICTORS[kind](**kwargs)
