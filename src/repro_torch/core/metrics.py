"""The paper's three per-point streaming performance metrics (§4.2).

Counterpart of ``repro/core/metrics.py``.  For input tuple i with
completing compression record r = record(i):

- compression ratio  = |r| / |reconstruct(r)|   (|r| in units of one y-value)
- reconstruction latency = time(r) - i          (in number of input tuples)
- approximation error = |y'_i - y_i|            (0 for singleton records)

plus the aggregate statistics the paper plots: mean, 25th/75th percentiles,
1.5-IQR whiskers and extremes (box plots of Figures 12-15).

:class:`BatchedPointMetrics` holds the three metrics as ``(S, T)`` float64
tensors on the device that computed them.  The box-plot summary is
reporting, not the hot path: it copies the metrics to the host and runs the
reference's numpy code (:func:`batched_summary`, copied as it is), so the
port's summaries equal the reference's to the last bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

METRIC_NAMES = ("ratio", "latency", "error")


def batched_summary(v: np.ndarray) -> Dict[str, np.ndarray]:
    """Box-plot statistics of one metric over (S, T) rows, vectorized.

    Returns ``mean / q25 / q75 / whisker_lo / whisker_hi / min / max`` as
    ``(S,)`` float arrays (the paper's Figures 12-15 aggregates).  The
    whiskers are the extreme values within 1.5 IQR of the quartiles.
    """
    v = np.asarray(v, np.float64)
    if v.size == 0:
        nan = np.full(v.shape[0], math.nan)
        return {k: nan for k in ("mean", "q25", "q75", "whisker_lo",
                                 "whisker_hi", "min", "max")}
    q25, q75 = np.percentile(v, [25, 75], axis=1)
    iqr = q75 - q25
    lo_b, hi_b = q25 - 1.5 * iqr, q75 + 1.5 * iqr
    lo_w = np.where(v >= lo_b[:, None], v, np.inf).min(axis=1)
    hi_w = np.where(v <= hi_b[:, None], v, -np.inf).max(axis=1)
    return {
        "mean": v.mean(axis=1),
        "q25": q25,
        "q75": q75,
        "whisker_lo": lo_w,
        "whisker_hi": hi_w,
        "min": v.min(axis=1),
        "max": v.max(axis=1),
    }


@dataclasses.dataclass
class PointMetrics:
    """Per-point metric arrays over one evaluated stream (host numpy)."""

    ratio: np.ndarray     # bytes(record)/record-coverage, in y-value units
    latency: np.ndarray   # tuples between input and reconstructability
    error: np.ndarray     # |y' - y|

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name in METRIC_NAMES:
            stats = batched_summary(getattr(self, name)[None, :])
            out[name] = {k: float(s[0]) for k, s in stats.items()}
        return out


@dataclasses.dataclass
class BatchedPointMetrics:
    """Per-point metric tensors over an (S, T) stream batch (float64).

    Produced by :func:`repro_torch.core.protocol_engine.batched_point_metrics`
    on the device of its inputs.
    """

    ratio: torch.Tensor     # (S, T)
    latency: torch.Tensor   # (S, T)
    error: torch.Tensor     # (S, T)

    @property
    def n_streams(self) -> int:
        return self.ratio.shape[0]

    def _host(self, name: str) -> np.ndarray:
        return getattr(self, name).cpu().numpy()

    def stream(self, s: int) -> PointMetrics:
        return PointMetrics(ratio=self.ratio[s].cpu().numpy(),
                            latency=self.latency[s].cpu().numpy(),
                            error=self.error[s].cpu().numpy())

    def summary(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Per-stream box-plot statistics: {metric: {stat: (S,) array}}."""
        return {name: batched_summary(self._host(name))
                for name in METRIC_NAMES}

    def pooled_summary(self) -> Dict[str, Dict[str, float]]:
        """Statistics over all streams pooled (the paper's multi-file
        aggregation)."""
        out = {}
        for name in METRIC_NAMES:
            stats = batched_summary(self._host(name).reshape(1, -1))
            out[name] = {k: float(s[0]) for k, s in stats.items()}
        return out
