"""Batched streaming PLA on the CUDA kernels: the port of ``core/jax_pla.py``.

This slice covers the two O(1)-state methods, Swing and Angle (paper §3.1),
plus reconstruction and the fixed-slot record form.

The reference has two engines, a jnp ``lax.scan`` and the Pallas kernels.
The port has one, the kernel: on a CUDA tensor the segmenters launch
``kernels/csrc/{swing,angle}.cu``; on a CPU tensor they run the kernels'
plain PyTorch versions, which repeat the same arithmetic step by step.

Output (:class:`SegmentOutput`) is dense and shape-static, as in the
reference: ``breaks (S, T) bool`` marks the last point of each segment, and
``a, v (S, T) float32`` hold the segment's slope and its value *at* the
break position (the anchored form ``y(t) = v + a * (t - t_break)``), set at
break positions and 0 elsewhere.

Streaming: :func:`init_state` / :func:`step_chunk` / :func:`flush` push a
stream in chunks of any size.  The packed kernel carry threads through the
launches, so the concatenated output is bit-identical to the offline call,
which is itself one launch of the whole stream with the flush folded in as
a forced break on one padding step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..device import resolve_device
from ..kernels.angle import angle_cuda, angle_init_carry
from ..kernels.common import (assemble_segments, fma_f32, pad_streams,
                              stream_major)
from ..kernels.reconstruct import recon_cuda
from ..kernels.swing import swing_cuda, swing_init_carry

__all__ = ["SegmentOutput", "swing_segment", "angle_segment", "SEGMENTERS",
           "SegmenterState", "init_state", "step_chunk", "flush",
           "STREAMING_METHODS", "MAX_STREAM_T", "propagate_lines",
           "PLARecords", "to_records", "records_to_events",
           "decode_records"]

# One SegmenterState holds at most 2^24 points over its lifetime, as in the
# reference: positions stay absolute across flushes for record bookkeeping,
# and the reconstruction distance ``cd`` is exact in float32 only below
# 2^24.  step_chunk raises past it.
MAX_STREAM_T = 1 << 24

# method -> (kernel wrapper, fresh carry)
_KERNELS = {
    "swing": (swing_cuda, swing_init_carry),
    "angle": (angle_cuda, angle_init_carry),
}
STREAMING_METHODS = tuple(_KERNELS)
# Reference methods whose kernels come with later slices of the port.
_LATER = ("disjoint", "linear", "continuous", "mixed")


class SegmentOutput(NamedTuple):
    breaks: torch.Tensor  # (S, T) bool — segment ends here
    a: torch.Tensor       # (S, T) — slope, set at break positions
    v: torch.Tensor       # (S, T) — line value AT the break position


def _kernel(method: str):
    if method in _KERNELS:
        return _KERNELS[method]
    if method in _LATER:
        raise NotImplementedError(
            f"method {method!r} has no CUDA kernel yet: this slice of the "
            f"port covers {sorted(_KERNELS)}")
    raise ValueError(f"unknown method {method!r}; have {sorted(_KERNELS)}")


def _eps_vector(eps, n_streams: int, device) -> torch.Tensor:
    """Scalar or per-stream ε -> contiguous float32 ``(S,)`` on device."""
    e = torch.as_tensor(eps, dtype=torch.float32, device=device)
    return e.expand(n_streams).contiguous()


def _segment_offline(method: str, y: torch.Tensor, eps,
                     max_run: int) -> SegmentOutput:
    kernel, init_carry = _kernel(method)
    if y.dim() != 2 or y.shape[1] < 1:
        raise ValueError(f"y must be (S, T) with T >= 1; got {tuple(y.shape)}")
    y = y.to(torch.float32)
    S, T = y.shape
    brk, a, v, _ = kernel(pad_streams(y), _eps_vector(eps, S, y.device),
                          init_carry(S, y.device), max_run=max_run, t_real=T)
    return SegmentOutput(*assemble_segments(brk, a, v, T))


def swing_segment(y: torch.Tensor, eps, max_run: int = 256
                  ) -> SegmentOutput:
    """Batched SwingFilter (paper §3.1) of ``(S, T)`` streams.

    ``eps`` may be a scalar or per stream ``(S,)``.  The wedge origin is
    the previous segment's chosen end point (the joint knot), so
    consecutive segment lines are connected.
    """
    return _segment_offline("swing", y, eps, max_run)


def angle_segment(y: torch.Tensor, eps, max_run: int = 256
                  ) -> SegmentOutput:
    """Batched Angle (greedy wedge from the extreme-line crossing).

    ``eps`` may be a scalar or per stream ``(S,)``.
    """
    return _segment_offline("angle", y, eps, max_run)


# method -> offline (S, T) segmenter.  ``evaluate.BATCHED_SEGMENTERS`` and
# ``kernels.ops.KERNEL_SEGMENTERS`` are this table.
SEGMENTERS = {
    "swing": swing_segment,
    "angle": angle_segment,
}


# ---------------------------------------------------------------------------
# Streaming (chunked) API
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SegmenterState:
    """Host-side handle for a chunked segmentation in progress.

    ``carry`` is the packed kernel state ``(C, S)`` (None before the first
    point and after a flush); ``t`` counts consumed points and ``emitted``
    finalized event columns (``emitted == t`` right after a flush).
    """

    method: str
    n_streams: int
    max_run: int
    eps: torch.Tensor         # (S,) float32, on the state's device
    t: int = 0
    emitted: int = 0
    carry: Optional[torch.Tensor] = None


def init_state(method: str, n_streams: int, eps, *, max_run: int = 256,
               device=None) -> SegmenterState:
    """Fresh streaming state for ``n_streams`` rows (no data consumed).

    Runs where ``eps`` lives when it is a tensor, else on ``device``
    (default ``"cuda"``).
    """
    _kernel(method)
    if isinstance(eps, torch.Tensor) and device is None:
        dev = eps.device
    else:
        dev = resolve_device(device)
    return SegmenterState(method=method, n_streams=n_streams,
                          max_run=max_run,
                          eps=_eps_vector(eps, n_streams, dev))


def step_chunk(state: SegmenterState, y_chunk
               ) -> tuple[SegmenterState, SegmentOutput]:
    """Consume ``y_chunk: (S, n)``; return the newly finalized events.

    The output has width ``n`` (``n - 1`` for the first chunk of a stream:
    processing position ``t`` can only decide that a segment ended at
    ``t - 1``) and covers absolute positions
    ``[state.emitted, state.emitted + width)``.
    """
    device = state.eps.device
    y = torch.as_tensor(y_chunk, dtype=torch.float32, device=device)
    if y.dim() != 2 or y.shape[0] != state.n_streams:
        raise ValueError(f"chunk must be ({state.n_streams}, n); "
                         f"got {tuple(y.shape)}")
    n = y.shape[1]
    if n == 0:
        raise ValueError("chunk must contain at least one point")
    if state.t + n > MAX_STREAM_T:
        raise ValueError(
            f"stream would reach {state.t + n} points on this "
            f"SegmenterState, past the 2^24-point limit (absolute positions "
            f"and reconstruction distances stop being exact in float32).  "
            f"Start a fresh state (init_state) to rebase time — flush() "
            f"does NOT rebase, positions stay absolute for record "
            f"bookkeeping.")
    kernel, init_carry = _kernel(state.method)
    fresh = state.carry is None
    carry = init_carry(state.n_streams, device) if fresh else state.carry
    brk, a, v, carry = kernel(y.t().contiguous(), state.eps, carry,
                              max_run=state.max_run, t_real=-1)
    lo = 1 if fresh else 0   # a stream's first row finalizes nothing
    out = SegmentOutput(stream_major(brk[lo:], torch.bool),
                        stream_major(a[lo:]), stream_major(v[lo:]))
    return dataclasses.replace(state, t=state.t + n,
                               emitted=state.emitted + n - lo,
                               carry=carry), out


def flush(state: SegmenterState) -> tuple[SegmenterState, SegmentOutput]:
    """Close the trailing run: one forced-break event at position t-1.

    One kernel launch over a single padding step with the break forced at
    its row 0; the event reads only the carry, exactly as the offline
    launch's forced break does.  The returned state has no carry, so the
    next :func:`step_chunk` starts a fresh stream at position ``state.t``.
    """
    if state.carry is None:
        raise ValueError("flush with no open run (no data since last flush)")
    kernel, _ = _kernel(state.method)
    pad = torch.zeros((1, state.n_streams), dtype=torch.float32,
                      device=state.eps.device)
    brk, a, v, _ = kernel(pad, state.eps, state.carry,
                          max_run=state.max_run, t_real=0)
    out = SegmentOutput(stream_major(brk, torch.bool), stream_major(a),
                        stream_major(v))
    return dataclasses.replace(state, carry=None,
                               emitted=state.emitted + 1), out


# ---------------------------------------------------------------------------
# Reconstruction and record framing
# ---------------------------------------------------------------------------

def time_major_events(seg: SegmentOutput):
    """``SegmentOutput`` -> contiguous time-major ``(brk int8, a, v)``."""
    return (seg.breaks.t().to(torch.int8).contiguous(),
            seg.a.t().to(torch.float32).contiguous(),
            seg.v.t().to(torch.float32).contiguous())


def propagate_lines(seg: SegmentOutput) -> torch.Tensor:
    """Per-point reconstruction: each point uses the line of the segment
    that ends at the next break at-or-after it, evaluated in the anchored
    form ``v + a * (t - t_break)`` by the reverse-walk kernel.

    As in the reference, the walk starts from the last column's line, so a
    row without a closing break extends that line.
    """
    brk_t, a_t, v_t = time_major_events(seg)
    carry = torch.stack([a_t[-1], v_t[-1], torch.zeros_like(a_t[-1])])
    out, _ = recon_cuda(brk_t, a_t, v_t, carry)
    return stream_major(out)


class PLARecords(NamedTuple):
    """Fixed-slot record form for shape-static storage.

    ``seg_end[s, k]`` = absolute index of the last point of segment k
    (padded by repeating the final segment); lines are anchored there:
    ``y(t) = v[k] + a[k] * (t - seg_end[k])``.  ``count`` = true number of
    segments (capped at K); ``overflow`` = row had more than K segments
    (its tail is covered by extending slot K-1's line).
    """

    seg_end: torch.Tensor   # (S, K) int32
    a: torch.Tensor         # (S, K)
    v: torch.Tensor         # (S, K)
    count: torch.Tensor     # (S,) int32
    overflow: torch.Tensor  # (S,) bool


def _records_pad(idx, ak, vk, count, k_max: int, t_len: int) -> PLARecords:
    """Slots past the last real segment repeat it; overflow rows pin slot
    K-1 to t_len-1."""
    kk = torch.arange(k_max, device=idx.device)[None, :]
    last = torch.clamp(count.long() - 1, 0, k_max - 1)[:, None]
    src = torch.minimum(kk, last)
    idx = idx.gather(1, src)
    ak = ak.gather(1, src)
    vk = vk.gather(1, src)
    overflow = count > k_max
    idx[:, k_max - 1] = torch.where(overflow, t_len - 1, idx[:, k_max - 1])
    return PLARecords(idx, ak, vk, torch.clamp(count, max=k_max), overflow)


def to_records(seg: SegmentOutput, k_max: int) -> PLARecords:
    breaks, a, v = seg
    S, T = a.shape
    brk = breaks.to(torch.bool)
    count = brk.sum(dim=1, dtype=torch.int32)
    # Rank of each break within its row; the first k_max land in slots,
    # everything else in a spill column that is cut off.
    rank = torch.cumsum(brk, dim=1) - 1
    slot = torch.where(brk & (rank < k_max), rank, k_max)
    pos = torch.arange(T, device=a.device).expand(S, T)
    idx = torch.full((S, k_max + 1), T - 1, dtype=torch.int64,
                     device=a.device).scatter_(1, slot, pos)[:, :k_max]
    out = _records_pad(idx, a.gather(1, idx), v.gather(1, idx), count,
                       k_max, T)
    return out._replace(seg_end=out.seg_end.to(torch.int32))


def records_to_events(rec: PLARecords, t_len: int) -> SegmentOutput:
    """Expand canonical fixed-slot records back to ``(S, T)`` events.

    The inverse of :func:`to_records` for non-overflowed rows; rows whose
    last segment ends early (overflow) extend that segment's line.
    """
    S, K = rec.seg_end.shape
    dev = rec.a.device
    valid = torch.arange(K, device=dev)[None, :] < rec.count[:, None]
    slot = torch.where(valid, rec.seg_end.long(), t_len)  # invalid: spilled
    breaks = torch.zeros((S, t_len + 1), dtype=torch.bool, device=dev)
    breaks.scatter_(1, slot, True)
    a = torch.zeros((S, t_len + 1), dtype=rec.a.dtype, device=dev)
    a.scatter_(1, slot, rec.a)
    v = torch.zeros((S, t_len + 1), dtype=rec.v.dtype, device=dev)
    v.scatter_(1, slot, rec.v)
    breaks, a, v = breaks[:, :t_len], a[:, :t_len], v[:, :t_len]
    last = torch.clamp(rec.count.long() - 1, 0, K - 1)[:, None]
    last_end = rec.seg_end.gather(1, last)[:, 0]
    last_a = rec.a.gather(1, last)[:, 0]
    last_v = rec.v.gather(1, last)[:, 0]
    open_tail = last_end < t_len - 1
    breaks[:, t_len - 1] = True
    dist = (t_len - 1 - last_end).to(rec.v.dtype)
    a[:, t_len - 1] = torch.where(open_tail, last_a, a[:, t_len - 1])
    v[:, t_len - 1] = torch.where(open_tail, fma_f32(last_a, dist, last_v),
                                  v[:, t_len - 1])
    return SegmentOutput(breaks.contiguous(), a.contiguous(),
                         v.contiguous())


def decode_records(rec: PLARecords, t_len: int) -> torch.Tensor:
    """Reconstruct ``(S, t_len)`` values from fixed-slot records."""
    S, K = rec.seg_end.shape
    t = torch.arange(t_len, dtype=torch.int32,
                     device=rec.a.device).expand(S, t_len).contiguous()
    j = torch.searchsorted(rec.seg_end.contiguous(), t, side="left")
    j = torch.clamp(j, 0, K - 1)
    dt = (t - rec.seg_end.gather(1, j)).to(rec.a.dtype)  # <= 0, small
    return fma_f32(rec.a.gather(1, j), dt, rec.v.gather(1, j))
