"""Batched end-to-end evaluation of (PLA method x protocol) combinations.

Counterpart of ``repro/core/evaluate.py:evaluate_batched``, the pipeline
behind the paper's Figures 12-16 and Table 3: segment an ``(S, T)`` batch,
build the §5 protocol descriptors and byte counts, and compute the three
§4.2 metrics.  This slice of the port covers the two O(1)-state methods,
so the Table-2 combinations Sw, A1, A2 and A3 run; the others raise the
reference's ``no batched segmenter`` error.

The 13 combinations of Table 2:

=====  ============  =============
Key    Method        Protocol
=====  ============  =============
A1-A3  angle         twostreams / singlestream / singlestreamv
C1-C3  disjoint      twostreams / singlestream / singlestreamv
L1-L3  linear        twostreams / singlestream / singlestreamv
Sw     swing         implicit
Sl     disjoint      implicit   (SlideFilter == optimal disjoint output)
C      continuous    implicit
M      mixed         implicit
=====  ============  =============
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ops import reconstruct_error_cuda
from . import pla
from .metrics import BatchedPointMetrics
from .protocol_engine import batched_point_metrics, protocol_nbytes
from .types import POINT_BYTES

__all__ = ["COMBINATIONS", "METHOD_KNOT_KINDS", "BATCHED_SEGMENTERS",
           "PROTOCOL_CAPS", "BatchedEvalResult", "evaluate_batched"]

# Batched (S, T) segmenters of this slice.
BATCHED_SEGMENTERS = pla.SEGMENTERS

# Knot convention of each method's SegmentOutput, as understood by the
# protocol engine: SwingFilter emits joint knots, continuous a connected
# polyline with one-segment-deferred emission, mixed a joint/disjoint mix,
# the rest disjoint knots.
METHOD_KNOT_KINDS = {
    "swing": "joint",
    "continuous": "continuous",
    "mixed": "mixed",
}

# Table 2 of the paper.
COMBINATIONS: Dict[str, Tuple[str, str]] = {
    "A1": ("angle", "twostreams"),
    "A2": ("angle", "singlestream"),
    "A3": ("angle", "singlestreamv"),
    "C1": ("disjoint", "twostreams"),
    "C2": ("disjoint", "singlestream"),
    "C3": ("disjoint", "singlestreamv"),
    "L1": ("linear", "twostreams"),
    "L2": ("linear", "singlestream"),
    "L3": ("linear", "singlestreamv"),
    "Sw": ("swing", "implicit"),
    "Sl": ("disjoint", "implicit"),
    "C": ("continuous", "implicit"),
    "M": ("mixed", "implicit"),
}

# Max points per segment each protocol supports (drives the method's
# ``max_run``): one unsigned byte for the single/two-stream counters, a fair
# signed-byte split for the V variant, unbounded for the implicit protocol.
# A copy of repro/core/protocols.py:PROTOCOL_CAPS.
PROTOCOL_CAPS = {
    "implicit": None,
    "twostreams": 256,
    "singlestream": 256,
    "singlestreamv": 127,
}


@dataclasses.dataclass
class BatchedEvalResult:
    """One (method x protocol) evaluated over a whole (S, T) batch.

    ``metrics`` holds float64 ``(S, T)`` tensors on the evaluation's device;
    the per-stream totals are host numpy arrays.
    """

    method: str
    protocol: str
    eps: np.ndarray               # scalar or (S,), float32
    n_streams: int
    n_points: int
    metrics: BatchedPointMetrics
    overall_ratio: np.ndarray     # (S,)
    n_records: np.ndarray         # (S,) int

    def summary(self) -> Dict:
        s = self.metrics.summary()
        s["overall_ratio"] = self.overall_ratio
        return s


def evaluate_batched(method_name: str, proto_name: str, y, eps, *,
                     max_run: Optional[int] = None,
                     reconstruct: str = "lines",
                     check_eps: bool = True,
                     device=None) -> BatchedEvalResult:
    """Evaluate one (method x protocol) pair over an (S, T) stream batch.

    Streams live on the index grid (``ts = 0..T-1``).  ``eps`` may be a
    scalar or a per-stream ``(S,)`` array.  Everything runs on ``device``
    (default ``"cuda"``; pass ``"cpu"`` for the kernels' plain versions).

    ``reconstruct`` selects the approximation-error path: ``"lines"``
    evaluates the fitted lines in float64 (bit-equal to the reference),
    ``"kernel"`` runs the fused reconstruction+error kernel and carries
    its float32 rounding.
    """
    if method_name not in BATCHED_SEGMENTERS:
        raise ValueError(f"no batched segmenter for {method_name!r}; "
                         f"have {sorted(BATCHED_SEGMENTERS)}")
    if reconstruct not in ("lines", "kernel"):
        raise ValueError(f"reconstruct must be lines|kernel; {reconstruct!r}")
    dev = resolve_device(device)
    y = torch.as_tensor(y, device=dev).to(torch.float32)
    S, T = y.shape
    cap = PROTOCOL_CAPS[proto_name]
    max_run = max_run or cap or 256
    if cap is not None and max_run > cap:
        raise ValueError(
            f"max_run={max_run} exceeds the {proto_name!r} counter cap "
            f"({cap} points): the byte accounting would describe an "
            f"unencodable wire format")
    knot_kind = METHOD_KNOT_KINDS.get(method_name, "disjoint")
    eps_t = torch.as_tensor(eps, dtype=torch.float32, device=dev)
    seg = BATCHED_SEGMENTERS[method_name](y, eps_t, max_run=max_run)
    abs_err = None
    if reconstruct == "kernel":
        _, abs_err = reconstruct_error_cuda(seg, y)
    pm = batched_point_metrics(seg, y, proto_name, knot_kind,
                               eps=eps_t if check_eps else None,
                               abs_err=abs_err)
    nbytes, n_records = protocol_nbytes(seg, proto_name, knot_kind)
    return BatchedEvalResult(
        method=method_name, protocol=proto_name,
        eps=eps_t.cpu().numpy(), n_streams=S, n_points=T, metrics=pm,
        overall_ratio=nbytes.cpu().numpy().astype(np.float64)
        / (POINT_BYTES * T),
        n_records=n_records.cpu().numpy())
