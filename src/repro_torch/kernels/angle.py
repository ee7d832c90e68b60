"""Angle segmentation (paper §3.1): CUDA kernel and plain version.

Counterpart of ``repro/kernels/angle.py``.  O(1) state per stream: the
wedge origin (the crossing of the two extreme lines through the first two
error segments) plus the feasible slope interval.  The kernel is
``csrc/angle.cu``.

Carry rows (ANGLE_STATE_ROWS = 8, all f32; see kernels/common.py):
0 started, 1 phase, 2 p0y, 3 od, 4 oy, 5 slo, 6 shi, 7 run_len.  Relative
state only, so a resumed launch needs no host-side shift.
"""

from __future__ import annotations

import torch

from .common import BIG, fma_f32, launch_segmenter

__all__ = ["ANGLE_STATE_ROWS", "angle_init_carry", "angle_plain",
           "launch_angle", "angle_cuda"]

ANGLE_STATE_ROWS = 8


def angle_init_carry(n_streams: int, device="cpu") -> torch.Tensor:
    """Packed fresh-stream carry (started = 0, empty wedge)."""
    c = torch.zeros((ANGLE_STATE_ROWS, n_streams), dtype=torch.float32,
                    device=device)
    c[5] = -BIG
    c[6] = BIG
    return c


def angle_plain(y_t: torch.Tensor, eps: torch.Tensor, carry: torch.Tensor,
                *, max_run: int, t_real: int):
    """The kernel's arithmetic as a Python loop over time (any device)."""
    T, S = y_t.shape
    started = carry[0] != 0
    phase = carry[1].to(torch.int32)
    p0y, od, oy, slo, shi = (carry[r] for r in range(2, 7))
    run_len = carry[7].to(torch.int32)
    brk_t = torch.empty((T, S), dtype=torch.int8, device=y_t.device)
    a_t = torch.empty((T, S), dtype=torch.float32, device=y_t.device)
    v_t = torch.empty_like(a_t)
    for t in range(T):
        yt = y_t[t]
        first = ~started
        ph1 = phase == 1
        # Phase 0 -> 1: origin from p0 (offset 0) and this point (offset 1).
        amax = (yt + eps) - (p0y - eps)
        amin = (yt - eps) - (p0y + eps)
        da = amax - amin
        flat = da.abs() < 1e-30
        das = torch.where(flat, 1.0, da)
        ox_rel = torch.where(flat, 0.5, 2.0 * eps / das)
        oy_new = fma_f32(amax, ox_rel, p0y - eps)
        od_new0 = 1.0 - ox_rel
        # Phase 1: wedge update; the origin sits od steps behind t.
        dts = torch.where(od == 0, 1.0, od)
        n1 = (yt - eps - oy) / dts
        n2 = (yt + eps - oy) / dts
        t_slo = torch.maximum(slo, torch.minimum(n1, n2))
        t_shi = torch.minimum(shi, torch.maximum(n1, n2))
        brk = ((ph1 & (~(t_slo <= t_shi) | (run_len >= max_run)))
               | (t == t_real)) & ~first
        a = torch.where(ph1, 0.5 * (slo + shi), 0.0)
        v = torch.where(ph1, fma_f32(a, od - 1.0, oy), p0y)
        brk_t[t] = brk
        a_t[t] = torch.where(brk, a, 0.0)
        v_t[t] = torch.where(brk, v, 0.0)
        # Commit the next state.
        restart = brk | first
        go0 = ~ph1 & ~brk & ~first
        phase = torch.where(restart, 0, 1).to(torch.int32)
        p0y = torch.where(restart, yt, p0y)
        od = torch.where(go0, od_new0 + 1.0,
                         torch.where(restart, 0.0, od + 1.0))
        oy = torch.where(go0, oy_new, oy)
        slo = torch.where(go0, amin, torch.where(brk, -BIG, t_slo))
        shi = torch.where(go0, amax, torch.where(brk, BIG, t_shi))
        run_len = torch.where(restart, 1, run_len + 1)
        started = torch.ones_like(started)
    carry_out = torch.stack([started.float(), phase.float(), p0y, od, oy,
                             slo, shi, run_len.float()])
    return brk_t, a_t, v_t, carry_out


def launch_angle(y_t: torch.Tensor, eps: torch.Tensor, carry: torch.Tensor,
                 *, max_run: int, t_real: int):
    """Kernel entry: CUDA tensors only, else raises."""
    return launch_segmenter("angle", ANGLE_STATE_ROWS, y_t, eps, carry,
                            max_run=max_run, t_real=t_real)


def angle_cuda(y_t: torch.Tensor, eps: torch.Tensor, carry: torch.Tensor,
               *, max_run: int = 256, t_real: int = -1):
    """Angle on time-major ``y_t (T, S)`` with per-stream ``eps (S,)``.

    Returns ``(brk int8, a, v)`` event arrays ``(T, S)`` and the carry
    after the launch.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel or raises.
    """
    if y_t.device.type == "cpu":
        return angle_plain(y_t, eps, carry, max_run=max_run, t_real=t_real)
    return launch_angle(y_t, eps, carry, max_run=max_run, t_real=t_real)
