"""Perf interpolators over pre-deployment profiling sweeps.

Port of `dynamo_tpu/planner/perf_interpolation.py`, in the role of the
reference's planner interpolators
(components/planner/src/dynamo/planner/utils/perf_interpolation.py:23-194):
PrefillInterpolator maps ISL -> TTFT and throughput/chip from a 1-D sweep;
DecodeInterpolator maps (kv_usage, context_length) -> ITL and
throughput/chip from a 2-D sweep, with reverse lookup ("best throughput
whose ITL meets the SLA"). npz field names match the reference's raw_data
format (prefill_isl/prefill_ttft/prefill_thpt_per_gpu; x_kv_usage/
y_context_length/z_itl/z_thpt_per_gpu/max_kv_tokens) so profiles are
interchangeable — "gpu" in those names reads "chip" here. The profiles
themselves come from planner/profiler.py sweeping the port's forwards.

The surfaces are scipy's (cubic `interp1d`; cubic Clough-Tocher
`griddata` with a nearest fill), as the reference's are, so both packages
give the same values for the same raw_data. scipy is imported inside the
two constructors only: nothing that imports the planner loads it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


class PrefillInterpolator:
    """ISL -> (TTFT seconds, prefill throughput tok/s/chip)."""

    def __init__(
        self,
        profile_results_dir: Optional[str] = None,
        raw_data: Optional[dict] = None,
    ):
        if profile_results_dir:
            fn = os.path.join(
                profile_results_dir, "selected_prefill_interpolation", "raw_data.npz"
            )
            with np.load(fn) as d:
                raw_data = {k: d[k] for k in d.files}
        if raw_data is None:
            raise ValueError("need profile_results_dir or raw_data")
        self.prefill_isl = np.asarray(raw_data["prefill_isl"], np.float64)
        self.prefill_ttft = np.asarray(raw_data["prefill_ttft"], np.float64) / 1000.0
        self.prefill_thpt_per_chip = np.asarray(
            raw_data["prefill_thpt_per_gpu"], np.float64
        )
        import scipy.interpolate

        self.min_isl = float(self.prefill_isl.min())
        self.max_isl = float(self.prefill_isl.max())
        kind = "cubic" if len(self.prefill_isl) >= 4 else "linear"
        self._ttft = scipy.interpolate.interp1d(
            self.prefill_isl, self.prefill_ttft, kind=kind
        )
        self._thpt = scipy.interpolate.interp1d(
            self.prefill_isl, self.prefill_thpt_per_chip, kind=kind
        )

    def interpolate_ttft(self, isl: float) -> float:
        return float(self._ttft(np.clip(isl, self.min_isl, self.max_isl)))

    def interpolate_thpt_per_chip(self, isl: float) -> float:
        return float(self._thpt(np.clip(isl, self.min_isl, self.max_isl)))


class DecodeInterpolator:
    """(kv_usage in [0,1], context_length) -> (ITL seconds, decode
    throughput tok/s/chip) on a precomputed grid."""

    def __init__(
        self,
        profile_results_dir: Optional[str] = None,
        resolution: int = 100,
        raw_data: Optional[dict] = None,
    ):
        if profile_results_dir:
            fn = os.path.join(
                profile_results_dir, "selected_decode_interpolation", "raw_data.npz"
            )
            with np.load(fn) as d:
                raw_data = {k: d[k] for k in d.files}
        if raw_data is None:
            raise ValueError("need profile_results_dir or raw_data")
        self.x_kv_usage = np.asarray(raw_data["x_kv_usage"], np.float64)
        self.y_context_length = np.asarray(raw_data["y_context_length"], np.float64)
        self.z_itl = np.asarray(raw_data["z_itl"], np.float64)
        self.z_thpt_per_chip = np.asarray(raw_data["z_thpt_per_gpu"], np.float64)
        self.max_kv_tokens = float(np.asarray(raw_data["max_kv_tokens"]).reshape(-1)[0])

        import scipy.interpolate

        self.resolution = resolution
        self.xi = np.linspace(0, 1, resolution)
        self.yi = np.linspace(0, float(self.y_context_length.max()), resolution)
        X, Y = np.meshgrid(self.xi, self.yi)
        pts = (self.x_kv_usage, self.y_context_length)
        griddata = scipy.interpolate.griddata
        self.itl_grid = self._grid(griddata, pts, self.z_itl, X, Y) / 1000.0  # ms -> s
        self.thpt_grid = self._grid(griddata, pts, self.z_thpt_per_chip, X, Y)

    @staticmethod
    def _grid(griddata, pts, z, X, Y) -> np.ndarray:
        method = "cubic" if len(z) >= 16 else "linear"
        g = griddata(pts, z, (X, Y), method=method)
        nan = np.isnan(g)
        if np.any(nan):
            g[nan] = griddata(pts, z, (X, Y), method="nearest")[nan]
        return g

    def _idx(self, concurrency: float, context_length: float) -> Tuple[int, int]:
        kv_usage = concurrency * context_length / self.max_kv_tokens
        ix = int(np.clip(round(kv_usage * (self.resolution - 1)), 0, self.resolution - 1))
        iy = int(
            np.clip(
                round((context_length - self.yi[0]) / (self.yi[1] - self.yi[0])),
                0,
                self.resolution - 1,
            )
        )
        return ix, iy

    def interpolate_itl(self, concurrency: float, context_length: float) -> float:
        ix, iy = self._idx(concurrency, context_length)
        return float(self.itl_grid[iy, ix])

    def interpolate_thpt_per_chip(
        self, concurrency: float, context_length: float
    ) -> float:
        ix, iy = self._idx(concurrency, context_length)
        return float(self.thpt_grid[iy, ix])

    def find_best_throughput_per_chip(
        self, itl: float, context_length: float
    ) -> Tuple[float, float, float]:
        """Highest-kv-load grid point whose ITL still meets the SLA; returns
        (thpt/chip, itl, kv_usage). Linear scan — interpolated ITL need not
        be monotonic in load."""
        iy = int(
            np.clip(
                round((context_length - self.yi[0]) / (self.yi[1] - self.yi[0])),
                0,
                self.resolution - 1,
            )
        )
        for ix in range(self.resolution - 1, -1, -1):
            if self.itl_grid[iy, ix] <= itl:
                return (
                    float(self.thpt_grid[iy, ix]),
                    float(self.itl_grid[iy, ix]),
                    float(self.xi[ix]),
                )
        return (
            float(self.thpt_grid[iy, 0]),
            float(self.itl_grid[iy, 0]),
            float(self.xi[0]),
        )
