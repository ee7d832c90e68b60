"""Public ``(S, T)`` wrappers around the CUDA kernels.

Counterpart of ``repro/kernels/ops.py`` for this slice of the port.  These
take the natural ``(S, T)`` stream layout, transpose to the kernels'
time-major layout at the boundary, and return the structures of
:mod:`repro_torch.core.pla`.  On CPU tensors every kernel runs its plain
PyTorch version.

The segmenters are :mod:`repro_torch.core.pla`'s own: the port has one
engine, the kernel, so ``swing_segment_cuda is pla.swing_segment``.
"""

from __future__ import annotations

import torch

from ..core import pla
from ..core.pla import PLARecords, SegmentOutput, time_major_events
from .common import stream_major
from .reconstruct import recon_cuda, recon_err_cuda

__all__ = ["swing_segment_cuda", "angle_segment_cuda", "reconstruct_cuda",
           "reconstruct_error_cuda", "reconstruct_records_cuda",
           "KERNEL_SEGMENTERS"]

swing_segment_cuda = pla.swing_segment
angle_segment_cuda = pla.angle_segment
KERNEL_SEGMENTERS = pla.SEGMENTERS


def reconstruct_cuda(seg: SegmentOutput) -> torch.Tensor:
    """Per-point reconstruction of ``(S, T)`` streams by the reverse walk.

    The walk starts from a zero carry: every segmentation ends each row
    with a break, so the start never shows.
    """
    out, _ = recon_cuda(*time_major_events(seg))
    return stream_major(out)


def reconstruct_error_cuda(seg: SegmentOutput, y: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused per-point reconstruction and ``|y' - y|`` of ``(S, T)`` streams.

    One kernel pass returns ``(y_hat, |y_hat - y|)``: the reconstruction
    and the §4.2 approximation-error surface the batched protocol metrics
    consume (singleton/burst masking happens protocol-side).
    """
    brk_t, a_t, v_t = time_major_events(seg)
    y_t = y.t().to(torch.float32).contiguous()
    out, err, _ = recon_err_cuda(brk_t, a_t, v_t, y_t)
    return stream_major(out), stream_major(err)


def reconstruct_records_cuda(rec: PLARecords, t_len: int) -> torch.Tensor:
    """Reconstruct ``(S, t_len)`` values from fixed-slot records through
    the reverse-walk kernel (the device alternative to
    :func:`repro_torch.core.pla.decode_records`)."""
    return reconstruct_cuda(pla.records_to_events(rec, t_len))
