"""SwingFilter segmentation (paper §3.1): CUDA kernel and plain version.

Counterpart of ``repro/kernels/swing.py``.  A slope wedge runs through a
fixed origin, the previous segment's chosen endpoint, so knots are joint;
O(1) state per stream.  The kernel is ``csrc/swing.cu``.

Carry rows (SWING_STATE_ROWS = 6, all f32; see kernels/common.py):
0 started, 1 od, 2 oy, 3 slo, 4 shi, 5 run_len.  Relative state only, so a
resumed launch needs no host-side shift.
"""

from __future__ import annotations

import torch

from .common import BIG, fma_f32, launch_segmenter

__all__ = ["SWING_STATE_ROWS", "swing_init_carry", "swing_plain",
           "launch_swing", "swing_cuda"]

SWING_STATE_ROWS = 6


def swing_init_carry(n_streams: int, device="cpu") -> torch.Tensor:
    """Packed fresh-stream carry (started = 0, empty wedge)."""
    c = torch.zeros((SWING_STATE_ROWS, n_streams), dtype=torch.float32,
                    device=device)
    c[3] = -BIG
    c[4] = BIG
    return c


def swing_plain(y_t: torch.Tensor, eps: torch.Tensor, carry: torch.Tensor,
                *, max_run: int, t_real: int):
    """The kernel's arithmetic as a Python loop over time (any device)."""
    T, S = y_t.shape
    started = carry[0] != 0
    od, oy, slo, shi = (carry[r] for r in range(1, 5))
    run_len = carry[5].to(torch.int32)
    brk_t = torch.empty((T, S), dtype=torch.int8, device=y_t.device)
    a_t = torch.empty((T, S), dtype=torch.float32, device=y_t.device)
    v_t = torch.empty_like(a_t)
    for t in range(T):
        yt = y_t[t]
        first = ~started
        dts = torch.where(od == 0, 1.0, od)
        n1 = (yt - eps - oy) / dts
        n2 = (yt + eps - oy) / dts
        t_slo = torch.maximum(slo, torch.minimum(n1, n2))
        t_shi = torch.minimum(shi, torch.maximum(n1, n2))
        brk = (~(t_slo <= t_shi) | (run_len >= max_run) | (t == t_real)) \
            & ~first
        a = 0.5 * (slo + shi)
        v = fma_f32(a, od - 1.0, oy)
        brk_t[t] = brk
        a_t[t] = torch.where(brk, a, 0.0)
        v_t[t] = torch.where(brk, v, 0.0)
        b_lo = yt - eps - v
        b_hi = yt + eps - v
        od = torch.where(first, 1.0, torch.where(brk, 2.0, od + 1.0))
        oy = torch.where(brk, v, torch.where(first, yt, oy))
        slo = torch.where(brk, torch.minimum(b_lo, b_hi),
                          torch.where(first, -BIG, t_slo))
        shi = torch.where(brk, torch.maximum(b_lo, b_hi),
                          torch.where(first, BIG, t_shi))
        run_len = torch.where(brk | first, 1, run_len + 1)
        started = torch.ones_like(started)
    carry_out = torch.stack([started.float(), od, oy, slo, shi,
                             run_len.float()])
    return brk_t, a_t, v_t, carry_out


def launch_swing(y_t: torch.Tensor, eps: torch.Tensor, carry: torch.Tensor,
                 *, max_run: int, t_real: int):
    """Kernel entry: CUDA tensors only, else raises."""
    return launch_segmenter("swing", SWING_STATE_ROWS, y_t, eps, carry,
                            max_run=max_run, t_real=t_real)


def swing_cuda(y_t: torch.Tensor, eps: torch.Tensor, carry: torch.Tensor,
               *, max_run: int = 256, t_real: int = -1):
    """Swing on time-major ``y_t (T, S)`` with per-stream ``eps (S,)``.

    Returns ``(brk int8, a, v)`` event arrays ``(T, S)`` and the carry
    after the launch.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel or raises.
    """
    if y_t.device.type == "cpu":
        return swing_plain(y_t, eps, carry, max_run=max_run, t_real=t_real)
    return launch_swing(y_t, eps, carry, max_run=max_run, t_real=t_real)
