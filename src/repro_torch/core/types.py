"""Core datatypes for streaming Piecewise Linear Approximation (PLA).

Nomenclature follows Duvignau et al. 2018 (itself adopted from Luo et al.
ICDE'15):

- the *input stream* is a sequence of tuples ``(t_i, y_i)`` with strictly
  increasing ``t_i``;
- a *PLA method* turns the input stream into a stream of *PLA records*
  (joint knots ``(t, y)`` / disjoint knots ``(t, y', y'')``) such that the
  reconstructed value at every input timestamp differs from the true value
  by less than ``eps`` (the L-inf guarantee);
- a *streaming protocol* turns PLA records / fitted segments into
  *compression records* — the units that are actually stored or transmitted
  — and provides the reconstruction algorithm.

Byte accounting (paper §6.2): every y-value, timestamp, slope and intercept
costs 8 bytes (double precision); segment-length counters cost 1 byte.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

# Size constants (bytes), per the paper's evaluation setup (§6.2).
VALUE_BYTES = 8     # one y-value / timestamp / coefficient, double precision
COUNTER_BYTES = 1   # segment-length counter n (1 byte => n <= 256)
POINT_BYTES = VALUE_BYTES  # size of one raw y-value of the input stream


@dataclasses.dataclass
class Line:
    """A line ``y = a * t + b``."""

    a: float
    b: float

    def __call__(self, t: float) -> float:
        return self.a * t + self.b

    @staticmethod
    def through(p: Sequence[float], q: Sequence[float]) -> "Line":
        """Line through two points with distinct t-coordinates."""
        (t0, y0), (t1, y1) = p, q
        a = (y1 - y0) / (t1 - t0)
        return Line(a, y0 - a * t0)


@dataclasses.dataclass
class Segment:
    """One fitted approximation segment produced by a PLA method.

    Covers input indices ``[i0, i1)``; its line reconstructs those points.
    ``finalized_at`` is the input index whose *processing* fixed the line
    (the break-up point index, or the last index at end-of-stream) — the
    earliest time any protocol may emit information about this segment.
    """

    i0: int
    i1: int
    line: Line
    finalized_at: int

    @property
    def n(self) -> int:
        return self.i1 - self.i0


@dataclasses.dataclass
class JointKnot:
    """PLA record (t, y): shared endpoint of two consecutive segments."""

    t: float
    y: float
    emitted_at: int  # input index at which the knot is fully known

    fields: int = 2

    @property
    def bytes(self) -> int:
        return 2 * VALUE_BYTES


@dataclasses.dataclass
class DisjointKnot:
    """PLA record (t, y', y''): segment j ends at (t,y'), j+1 starts (t,y'').

    ``y2`` (= y'') depends on the *next* segment's line, hence is generally
    known later than ``(t, y1)``; the implicit protocol streams the two
    parts separately using the sign trick of Luo et al.
    """

    t: float
    y1: float
    y2: Optional[float]
    emitted_at_first: int   # when (t, y') is known
    emitted_at_second: int  # when y'' is known (completion time)

    fields: int = 3

    @property
    def bytes(self) -> int:
        return 3 * VALUE_BYTES


@dataclasses.dataclass
class CompressionRecord:
    """A unit of the compressed stream, as accounted by the metrics.

    ``covers`` are the input indices whose reconstruction this record
    *completes* (paper: ``reconstruct(r)``); ``emitted_at`` is ``time(r)``,
    the input index after whose processing the record is fully available on
    the reconstruction side.  ``values`` are the reconstructed y-values for
    ``covers`` (same order).
    """

    kind: str            # 'segment' | 'singleton' | 'burst' | 'joint' | 'disjoint'
    nbytes: float
    fields: float
    emitted_at: int
    covers: range
    values: List[float]
    # Codec metadata (segments only): the line coefficients and first
    # covered timestamp, so records can be packed to actual bytes.
    meta_line: Optional[tuple] = None   # (a, b)
    meta_t0: Optional[float] = None


@dataclasses.dataclass
class MethodOutput:
    """Everything a PLA method produces on a finite input stream."""

    segments: List[Segment]
    # Knot stream for the implicit protocol.  For joint-knot methods this is
    # a list of JointKnot; for disjoint methods, DisjointKnot (first entry is
    # by convention a JointKnot marking the start of segment 0); MixedPLA
    # interleaves both kinds.
    knots: List[object]

    def reconstruct(self, ts: Sequence[float]) -> List[float]:
        """Reconstruct the full stream from fitted segments (oracle view)."""
        out: List[float] = []
        for seg in self.segments:
            for i in range(seg.i0, seg.i1):
                out.append(seg.line(ts[i]))
        return out
