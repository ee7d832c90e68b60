"""Protocol and metrics engine (paper §5 + §4.2, batched) in PyTorch.

Counterpart of ``repro/core/protocol_engine.py`` for this slice of the port.
It consumes the ``(S, T)`` :class:`~repro_torch.core.pla.SegmentOutput` of
the batched segmenters and computes, for all ``S`` streams at once and on
their device:

- the record structure of the four §5 protocols (implicit / twostreams /
  singlestream / singlestreamv) as per-point descriptor tensors, including
  the SingleStreamV burst packing with the signed-byte counter semantics
  preserved (bursts split at 127);
- the three per-point §4.2 metrics, finished in float64;
- per-stream wire byte totals, and, on the host, the actual wire bytes
  (:func:`encode_batch`, a numpy copy of the reference's vectorized codecs).

Knot kinds: ``"joint"`` (SwingFilter) and ``"disjoint"``.  The
``"continuous"`` and ``"mixed"`` kinds come with their segmenters in a later
slice and raise :class:`NotImplementedError` here.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..kernels.common import fma_f32
from .metrics import BatchedPointMetrics
from .pla import SegmentOutput
from .types import COUNTER_BYTES, VALUE_BYTES

__all__ = [
    "ENGINE_PROTOCOLS", "KNOT_KINDS", "PROTOCOL_MIN_SEG",
    "ProtocolPointDescriptors",
    "protocol_descriptors", "protocol_point_metrics", "protocol_nbytes",
    "metrics_from_descriptors", "descriptors_point_metrics",
    "batched_point_metrics", "encode_batch",
]

ENGINE_PROTOCOLS = ("implicit", "twostreams", "singlestream",
                    "singlestreamv")

# Minimum run length for a segment record; shorter runs flush as
# singletons / bursts (paper §5.2).
PROTOCOL_MIN_SEG = {"twostreams": 4, "singlestream": 3, "singlestreamv": 3}

# Per-point record kinds.
KIND_SEGMENT = 1
KIND_SINGLETON = 2
KIND_BURST = 3

_SEG_BYTES = {  # segment-record wire cost per protocol
    "twostreams": 3 * VALUE_BYTES + COUNTER_BYTES,      # (t0, n, a, b) = 25
    "singlestream": 2 * VALUE_BYTES + COUNTER_BYTES,    # (n, a, b) = 17
    "singlestreamv": 2 * VALUE_BYTES + COUNTER_BYTES,   # (n, a, b) = 17
}
_SINGLE_BYTES = {
    "twostreams": VALUE_BYTES,                  # bare value on stream 2
    "singlestream": VALUE_BYTES + COUNTER_BYTES,  # (1, y) = 9
}

KNOT_KINDS = ("joint", "disjoint", "continuous", "mixed")
_PORTED_KNOT_KINDS = ("joint", "disjoint")


def _check_knot_kind(knot_kind: str) -> None:
    if knot_kind not in KNOT_KINDS:
        raise ValueError(f"knot_kind must be one of {KNOT_KINDS}; "
                         f"{knot_kind!r}")
    if knot_kind not in _PORTED_KNOT_KINDS:
        raise NotImplementedError(
            f"knot_kind {knot_kind!r} comes with the continuous and mixed "
            f"segmenters in a later slice of the port; this one has "
            f"{_PORTED_KNOT_KINDS}")


class ProtocolPointDescriptors(NamedTuple):
    """Per-point record structure of one protocol over ``(S, T)`` streams.

    For input point ``i`` with completing record ``r = record(i)``
    (paper §4.2): ``rec_bytes[i] = |r|`` in bytes, ``rec_len[i] =
    |reconstruct(r)|``, ``emit[i] = time(r)``.  ``kind`` is one of
    ``KIND_SEGMENT / KIND_SINGLETON / KIND_BURST``; ``head`` marks the
    first point of each record (summing ``rec_bytes`` over heads gives the
    stream's wire size).  ``seg_end / a / v`` describe the covering
    *segment*'s anchored line ``y(t) = v + a*(t - seg_end)``.
    """

    kind: torch.Tensor       # (S, T) int32
    head: torch.Tensor       # (S, T) bool
    rec_bytes: torch.Tensor  # (S, T) int32
    rec_len: torch.Tensor    # (S, T) int32
    emit: torch.Tensor       # (S, T) int32
    seg_end: torch.Tensor    # (S, T) int32 — end of covering segment
    seg_start: torch.Tensor  # (S, T) int32
    seg_len: torch.Tensor    # (S, T) int32
    a: torch.Tensor          # (S, T) — covering segment's slope
    v: torch.Tensor          # (S, T) — covering segment's value at seg_end


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    """Suffix minimum along time."""
    return torch.cummin(x.flip(1), dim=1).values.flip(1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx, axis=1)``; gather wants int64 indices."""
    return x.gather(1, idx.long())


def _segment_geometry(seg: SegmentOutput):
    """Per-point covering-segment tensors from (S, T) break events."""
    brk = seg.breaks.to(torch.bool).clone()
    S, T = brk.shape
    brk[:, T - 1] = True  # canonical form: stream end breaks
    pos = torch.arange(T, dtype=torch.int32, device=brk.device).expand(S, T)
    # Next break at-or-after t (the covering segment's end).
    e = _rev_cummin(torch.where(brk, pos, T - 1))
    # Last break strictly before t; the segment starts one past it.
    cm = torch.cummax(torch.where(brk, pos, -1), dim=1).values
    prevb = torch.cat([torch.full((S, 1), -1, dtype=torch.int32,
                                  device=brk.device), cm[:, :-1]], dim=1)
    start = prevb + 1
    n = e - start + 1
    # The processing of e+1 decides the break => earliest emission time.
    fin = torch.clamp(e + 1, max=T - 1)
    return pos, e, start, n, fin, _take(seg.a, e), _take(seg.v, e)


def protocol_descriptors(seg: SegmentOutput, protocol: str,
                         knot_kind: str = "disjoint",
                         burst_cap: int = 127) -> ProtocolPointDescriptors:
    """Vectorize one §5 protocol over an ``(S, T)`` segmentation.

    ``knot_kind`` only matters for ``implicit``: ``"joint"`` (SwingFilter)
    knots cost 2 fields, ``"disjoint"`` knots 3 (streamed in two parts;
    the stream's closing knot is joint, hence 2).
    """
    if protocol not in ENGINE_PROTOCOLS:
        raise ValueError(f"unknown protocol {protocol!r}; "
                         f"have {sorted(ENGINE_PROTOCOLS)}")
    _check_knot_kind(knot_kind)
    pos, e, start, n, fin, a_pt, v_pt = _segment_geometry(seg)
    S, T = pos.shape
    i32 = torch.int32
    at_start = pos == start

    def full(value):
        return torch.full((S, T), value, dtype=i32, device=pos.device)

    if protocol == "implicit":
        if knot_kind == "joint":
            nbytes = full(2 * VALUE_BYTES)
        else:
            # Interior segments terminate on a 3-field disjoint knot; the
            # last segment's right knot is the closing joint knot (2).
            nbytes = torch.where(e == T - 1, 2 * VALUE_BYTES,
                                 3 * VALUE_BYTES).to(i32)
        return ProtocolPointDescriptors(
            kind=full(KIND_SEGMENT), head=at_start, rec_bytes=nbytes,
            rec_len=n, emit=fin, seg_end=e, seg_start=start, seg_len=n,
            a=a_pt, v=v_pt)

    long = n >= PROTOCOL_MIN_SEG[protocol]
    seg_bytes = _SEG_BYTES[protocol]

    if protocol in ("twostreams", "singlestream"):
        return ProtocolPointDescriptors(
            kind=torch.where(long, KIND_SEGMENT, KIND_SINGLETON).to(i32),
            head=torch.where(long, at_start, True),
            rec_bytes=torch.where(long, seg_bytes,
                                  _SINGLE_BYTES[protocol]).to(i32),
            rec_len=torch.where(long, n, 1), emit=fin,
            seg_end=e, seg_start=start, seg_len=n, a=a_pt, v=v_pt)

    # singlestreamv: short-run points buffer into bursts.  A maximal run of
    # buffered points spans consecutive short segments; it flushes when the
    # next segment record is emitted, at ``burst_cap`` values, or at end of
    # stream.
    single = ~long
    # Start of the maximal singleton run containing t.
    run_start = torch.cummax(torch.where(~single, pos + 1, 0), dim=1).values
    c = pos - run_start                       # index within the run
    b_start = run_start + torch.div(c, burst_cap,
                                    rounding_mode="floor") * burst_cap
    # First non-singleton position after t (T when the run hits the end).
    nxt_ns = _rev_cummin(torch.where(~single, pos, T))
    b_last = torch.minimum(b_start + burst_cap - 1, nxt_ns - 1)
    m = b_last - b_start + 1

    def fin_at(idx):
        return _take(fin, torch.clamp(idx, 0, T - 1))

    # Cap-filled bursts flush while their last point's segment is being
    # scattered; partial bursts wait for the next segment record (or the
    # end of the stream, where fin[T-1] == T-1).
    emit_burst = torch.where(m == burst_cap, fin_at(b_last),
                             fin_at(torch.clamp(nxt_ns, max=T - 1)))
    return ProtocolPointDescriptors(
        kind=torch.where(long, KIND_SEGMENT, KIND_BURST).to(i32),
        head=torch.where(long, at_start, torch.remainder(c, burst_cap) == 0),
        rec_bytes=torch.where(long, seg_bytes,
                              COUNTER_BYTES + VALUE_BYTES * m).to(i32),
        rec_len=torch.where(long, n, m),
        emit=torch.where(long, fin, emit_burst),
        seg_end=e, seg_start=start, seg_len=n, a=a_pt, v=v_pt)


def protocol_point_metrics(seg: SegmentOutput, y: torch.Tensor,
                           protocol: str, knot_kind: str = "disjoint",
                           burst_cap: int = 127
                           ) -> Tuple[torch.Tensor, ...]:
    """The §4.2 per-point metrics as float32 ``(S, T)`` tensors.

    Returns ``(ratio, latency, error)``; see
    :func:`metrics_from_descriptors`.
    """
    d = protocol_descriptors(seg, protocol, knot_kind, burst_cap)
    return metrics_from_descriptors(d, y)


def metrics_from_descriptors(d: ProtocolPointDescriptors, y: torch.Tensor
                             ) -> Tuple[torch.Tensor, ...]:
    """The float32 §4.2 metric expressions over precomputed descriptors.

    ``ratio = |r| / |reconstruct(r)|`` in y-value units, ``latency =
    time(r) - i`` in tuples, ``error = |y'_i - y_i|`` (0 for
    singleton/burst points, which ship exact values).  ``y' = v + a * dt``
    is one fused multiply-add, the contraction XLA makes in the reference.
    """
    pos = torch.arange(y.shape[1], dtype=torch.int32,
                       device=y.device)[None, :]
    ratio = (d.rec_bytes.float() / VALUE_BYTES) / d.rec_len.float()
    latency = (d.emit - pos).float()
    y_hat = fma_f32(d.a, (pos - d.seg_end).to(d.a.dtype), d.v)
    error = torch.where(d.kind == KIND_SEGMENT, (y_hat - y).abs(),
                        torch.zeros_like(y))
    return ratio, latency, error


def protocol_nbytes(seg: SegmentOutput, protocol: str,
                    knot_kind: str = "disjoint", burst_cap: int = 127
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-stream ``(record_bytes, n_records)`` wire accounting (int32).

    ``record_bytes`` sums each record once (at its head); dividing by
    ``VALUE_BYTES * T`` gives the whole-stream compression ratio.  The
    implicit protocol's byte-level codec adds one opening joint knot
    (``2 * VALUE_BYTES``) on top of the per-record accounting.
    """
    d = protocol_descriptors(seg, protocol, knot_kind, burst_cap)
    nbytes = torch.where(d.head, d.rec_bytes, 0).sum(dim=1, dtype=torch.int32)
    n_records = d.head.sum(dim=1, dtype=torch.int32)
    return nbytes, n_records


# ---------------------------------------------------------------------------
# Float64 finish: the legacy-exact metrics
# ---------------------------------------------------------------------------

def batched_point_metrics(seg: SegmentOutput, ys, protocol: str,
                          knot_kind: str = "disjoint", *,
                          eps=None, burst_cap: int = 127,
                          y_hat=None, abs_err=None) -> BatchedPointMetrics:
    """Batched §4.2 metrics, bit-equal to the reference's float64 finish.

    ``y_hat`` optionally substitutes a device reconstruction for the line
    evaluation, and ``abs_err`` a device ``|y' - y|`` surface (the second
    output of :func:`repro_torch.kernels.ops.reconstruct_error_cuda`);
    errors then carry that path's float32 rounding.
    """
    d = protocol_descriptors(seg, protocol, knot_kind, burst_cap)
    return descriptors_point_metrics(d, ys, eps=eps, y_hat=y_hat,
                                     abs_err=abs_err)


def descriptors_point_metrics(d: ProtocolPointDescriptors, ys, *,
                              eps=None, y_hat=None, abs_err=None
                              ) -> BatchedPointMetrics:
    """The float64 finish of :func:`batched_point_metrics`.

    It runs in torch float64 on the descriptors' device: every expression
    is a chain of separate eager operations, each rounded once, exactly as
    the reference's numpy finish rounds them.  ``eps`` (scalar or
    per-stream ``(S,)``) checks the max-error guarantee with the
    reference's float32-engine slack.
    """
    f64 = torch.float64
    dev = d.kind.device
    ys = torch.as_tensor(ys, device=dev).to(f64)
    S, T = ys.shape
    pos = torch.arange(T, dtype=f64, device=dev)[None, :]
    ratio = (d.rec_bytes.to(f64) / VALUE_BYTES) / d.rec_len.to(f64)
    latency = d.emit.to(f64) - pos
    is_seg = d.kind == KIND_SEGMENT
    if abs_err is not None:
        abs_err = abs_err.to(f64)
    elif y_hat is not None:
        abs_err = (y_hat.to(f64) - ys).abs()
    else:
        a64, v64, e64 = d.a.to(f64), d.v.to(f64), d.seg_end.to(f64)
        y_line = a64 * pos + (v64 - a64 * e64)   # Line(A, B) evaluation
        abs_err = (y_line - ys).abs()
    error = torch.where(is_seg, abs_err, 0.0)
    if eps is not None:
        eps_row = torch.as_tensor(eps, device=dev).to(f64).reshape(-1)
        eps_row = eps_row.expand(S)
        bad = error > eps_row[:, None] * (1 + 1e-4) + 1e-5
        if bool(bad.any()):
            s, i = (int(x) for x in torch.nonzero(bad)[0])
            raise ValueError(
                f"max-error guarantee violated at stream {s} point {i}: "
                f"err={float(error[s, i]):.3e} > eps={float(eps_row[s]):.3e}")
    return BatchedPointMetrics(ratio=ratio, latency=latency, error=error)


# ---------------------------------------------------------------------------
# Vectorized byte-level encoders (host numpy; the reference's codecs)
# ---------------------------------------------------------------------------

def _put_f64(buf: np.ndarray, offs: np.ndarray, vals: np.ndarray) -> None:
    """Scatter little-endian float64 values at per-record byte offsets."""
    if len(offs) == 0:
        return
    b = np.ascontiguousarray(vals, "<f8").view(np.uint8).reshape(-1, 8)
    buf[offs[:, None] + np.arange(8)] = b


def _row_lines(brk_row, a_row, v_row, t0: float, dt: float):
    """Per-segment (ends, starts, n, A, B) with the legacy float64 math:
    ``A = a/dt``; ``B = v - a*e - A*t0`` (e on the index grid)."""
    ends = np.flatnonzero(brk_row)
    if len(ends) == 0 or ends[-1] != len(brk_row) - 1:
        ends = np.append(ends, len(brk_row) - 1)
    starts = np.concatenate([[0], ends[:-1] + 1])
    n = ends - starts + 1
    a64 = np.asarray(a_row, np.float64)[ends]
    v64 = np.asarray(v_row, np.float64)[ends]
    A = a64 / dt
    B = v64 - a64 * ends - A * t0
    return ends, starts, n, A, B


def _encode_row(protocol: str, brk_row, a_row, v_row, ys_row,
                knot_kind: str, t0: float, dt: float, burst_cap: int):
    T = len(ys_row)
    ends, starts, n, A, B = _row_lines(brk_row, a_row, v_row, t0, dt)
    ys64 = np.asarray(ys_row, np.float64)
    t_of = lambda i: t0 + dt * np.asarray(i, np.float64)  # noqa: E731

    if protocol == "implicit":
        K = len(ends)
        t_end = t_of(ends[-1])
        if knot_kind == "joint":
            # One joint knot per segment end, on the segment's line; the
            # opening knot is the raw first point (SwingFilter's origin).
            ts_k = np.concatenate([[t_of(0)], t_of(ends)])
            ys_k = np.concatenate([[ys64[0]], A * t_of(ends) + B])
            return np.stack([ts_k, ys_k], 1).ravel().astype("<f8").tobytes()
        head = np.array([t_of(0), A[0] * t_of(0) + B[0]])
        if K == 1:
            body = np.empty(0)
        else:
            tb = t_of(starts[1:])
            y1 = A[:-1] * tb + B[:-1]
            y2 = A[1:] * tb + B[1:]
            body = np.stack([-tb, y1, y2], 1).ravel()
        tail = np.array([t_end, A[-1] * t_end + B[-1]])
        return np.concatenate([head, body, tail]).astype("<f8").tobytes()

    long = n >= PROTOCOL_MIN_SEG[protocol]
    n_cap = 127 if protocol == "singlestreamv" else 256
    if int(n[long].max(initial=0)) > n_cap:
        raise ValueError(
            f"{protocol}: segment of {int(n[long].max())} points exceeds "
            f"the {n_cap}-point counter range — segment with "
            f"max_run=PROTOCOL_CAPS[{protocol!r}]")
    seg_id = np.searchsorted(ends, np.arange(T))
    long_pt = long[seg_id]

    if protocol == "twostreams":
        kl = np.flatnonzero(long)
        seg_buf = np.zeros(25 * len(kl), np.uint8)
        offs = 25 * np.arange(len(kl))
        _put_f64(seg_buf, offs, t_of(starts[kl]))
        seg_buf[offs + 8] = (n[kl] - 1).astype(np.uint8)
        _put_f64(seg_buf, offs + 9, A[kl])
        _put_f64(seg_buf, offs + 17, B[kl])
        single_buf = ys64[~long_pt].astype("<f8").tobytes()
        return seg_buf.tobytes(), single_buf

    if protocol == "singlestream":
        head_pt = np.flatnonzero(np.where(long_pt,
                                          np.arange(T) == starts[seg_id],
                                          True))
        is_seg = long_pt[head_pt]
        sizes = np.where(is_seg, 17, 9)
        offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        buf = np.zeros(int(sizes.sum()), np.uint8)
        buf[offs] = np.where(is_seg, n[seg_id[head_pt]] - 1, 0) \
            .astype(np.uint8)
        _put_f64(buf, offs[is_seg] + 1, A[seg_id[head_pt[is_seg]]])
        _put_f64(buf, offs[is_seg] + 9, B[seg_id[head_pt[is_seg]]])
        _put_f64(buf, offs[~is_seg] + 1, ys64[head_pt[~is_seg]])
        return buf.tobytes()

    # singlestreamv
    pos = np.arange(T)
    run_start = np.maximum.accumulate(np.where(long_pt, pos + 1, 0))
    c = pos - run_start
    head_pt = np.flatnonzero(np.where(long_pt, pos == starts[seg_id],
                                      c % burst_cap == 0))
    is_seg = long_pt[head_pt]
    nxt_ns = np.minimum.accumulate(np.where(long_pt, pos, T)[::-1])[::-1]
    b_last = np.minimum(head_pt + burst_cap - 1, nxt_ns[head_pt] - 1)
    m = np.where(is_seg, 0, b_last - head_pt + 1)
    sizes = np.where(is_seg, 17, 1 + 8 * m)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    buf = np.zeros(int(sizes.sum()), np.uint8)
    buf[offs] = np.where(is_seg, n[seg_id[head_pt]],
                         -m).astype(np.int8).view(np.uint8)
    _put_f64(buf, offs[is_seg] + 1, A[seg_id[head_pt[is_seg]]])
    _put_f64(buf, offs[is_seg] + 9, B[seg_id[head_pt[is_seg]]])
    # Burst payloads: each buffered point writes its exact value at
    # head_offset + 1 + 8 * (its index within the burst).
    sp = np.flatnonzero(~long_pt)
    if len(sp):
        r = np.searchsorted(head_pt, sp, "right") - 1
        _put_f64(buf, offs[r] + 1 + 8 * (sp - head_pt[r]), ys64[sp])
    return buf.tobytes()


def encode_batch(seg: SegmentOutput, ys, protocol: str,
                 knot_kind: str = "disjoint", *, t0: float = 0.0,
                 dt: float = 1.0, burst_cap: int = 127) -> List:
    """Wire-encode every stream of an (S, T) segmentation.

    Returns one ``bytes`` per stream (``(seg_bytes, singleton_bytes)``
    pairs for ``twostreams``).  The events and values are copied to the
    host once; the codecs are the reference's numpy ones.
    """
    if protocol not in ENGINE_PROTOCOLS:
        raise ValueError(f"unknown protocol {protocol!r}")
    _check_knot_kind(knot_kind)
    brk = seg.breaks.to(torch.bool).cpu().numpy()
    a = seg.a.cpu().numpy()
    v = seg.v.cpu().numpy()
    ys = ys.cpu().numpy() if isinstance(ys, torch.Tensor) else np.asarray(ys)
    return [_encode_row(protocol, brk[s], a[s], v[s], ys[s], knot_kind,
                        t0, dt, burst_cap) for s in range(brk.shape[0])]
