"""Segment events -> dense reconstruction: CUDA kernels and plain versions.

Counterpart of ``repro/kernels/reconstruct.py``.  A reverse walk: each point
takes the line of the segment ending at the next break at-or-after it,
``y' = v - a * d`` with ``(a, v, d)`` carried.  Two kernels share the walk
(``csrc/reconstruct.cu``): plain reconstruction, and the fused
reconstruct-plus-``|y' - y|`` variant that feeds the §4.2 error metric.

Carry rows (RECON_STATE_ROWS = 3, all f32): 0 ca (slope), 1 cv (value at the
anchor), 2 cd (distance to the anchor).  The carry propagates *backward* in
time, so a chunked reconstruction pushes suffix slabs first: launch the
latest slab with a zero carry, then hand its carry-out to the slab before
it.  ``cd`` is a distance, so no host-side shift is needed.
"""

from __future__ import annotations

import torch

from .common import (RECON_ARGTYPES, RECON_ERR_ARGTYPES, check_cuda_args,
                     fma_f32, launch)

__all__ = ["RECON_STATE_ROWS", "recon_init_carry", "recon_plain",
           "recon_err_plain", "launch_recon", "launch_recon_err",
           "recon_cuda", "recon_err_cuda"]

RECON_STATE_ROWS = 3


def recon_init_carry(n_streams: int, device="cpu") -> torch.Tensor:
    return torch.zeros((RECON_STATE_ROWS, n_streams), dtype=torch.float32,
                       device=device)


def _walk_plain(brk_t, a_t, v_t, carry, y_t=None):
    T, S = a_t.shape
    ca, cv, cd = carry[0], carry[1], carry[2]
    out = torch.empty((T, S), dtype=torch.float32, device=a_t.device)
    err = torch.empty_like(out) if y_t is not None else None
    for t in range(T - 1, -1, -1):
        b = brk_t[t] != 0
        ca = torch.where(b, a_t[t], ca)
        cv = torch.where(b, v_t[t], cv)
        cd = torch.where(b, 0.0, cd)
        r = fma_f32(-ca, cd, cv)
        out[t] = r
        if err is not None:
            err[t] = (r - y_t[t]).abs()
        cd = cd + 1.0
    return out, err, torch.stack([ca, cv, cd])


def recon_plain(brk_t, a_t, v_t, carry):
    """The reverse walk as a Python loop over time: ``(out, carry_out)``."""
    out, _, carry_out = _walk_plain(brk_t, a_t, v_t, carry)
    return out, carry_out


def recon_err_plain(brk_t, a_t, v_t, y_t, carry):
    """The fused walk as a Python loop: ``(out, |out - y|, carry_out)``."""
    return _walk_plain(brk_t, a_t, v_t, carry, y_t)


def _event_args(brk_t, a_t, v_t, carry):
    S = a_t.shape[1] if a_t.dim() == 2 else -1
    return ([("brk_t", brk_t, torch.int8), ("a_t", a_t, torch.float32),
             ("v_t", v_t, torch.float32)],
            [("carry", carry, torch.float32, (RECON_STATE_ROWS, S))])


def launch_recon(brk_t, a_t, v_t, carry):
    """Kernel entry of ``_recon_kernel``: CUDA tensors only, else raises."""
    T, S = check_cuda_args(*_event_args(brk_t, a_t, v_t, carry))
    out = torch.empty_like(a_t)
    carry_out = torch.empty_like(carry)
    launch("recon", "reconstruct", "recon_launch", RECON_ARGTYPES,
           (brk_t, a_t, v_t, carry, out, carry_out, T, S), a_t.device)
    return out, carry_out


def launch_recon_err(brk_t, a_t, v_t, y_t, carry):
    """Kernel entry of ``_recon_err_kernel``: CUDA tensors only."""
    tm, others = _event_args(brk_t, a_t, v_t, carry)
    T, S = check_cuda_args(tm + [("y_t", y_t, torch.float32)], others)
    out = torch.empty_like(a_t)
    err = torch.empty_like(a_t)
    carry_out = torch.empty_like(carry)
    launch("recon_err", "reconstruct", "recon_err_launch",
           RECON_ERR_ARGTYPES,
           (brk_t, a_t, v_t, y_t, carry, out, err, carry_out, T, S),
           a_t.device)
    return out, err, carry_out


def recon_cuda(brk_t, a_t, v_t, carry=None):
    """Time-major ``(T, S)`` events -> ``(out, carry_out)``.

    ``carry=None`` starts from the stream tail (zero carry); pass the
    carry-out of the later slab to reconstruct the slab before it.  A CPU
    tensor runs the plain version; a CUDA tensor launches or raises.
    """
    if carry is None:
        carry = recon_init_carry(a_t.shape[1], a_t.device)
    if a_t.device.type == "cpu":
        return recon_plain(brk_t, a_t, v_t, carry)
    return launch_recon(brk_t, a_t, v_t, carry)


def recon_err_cuda(brk_t, a_t, v_t, y_t, carry=None):
    """Time-major events + values -> ``(out, |out - y|, carry_out)``.

    Same carry contract as :func:`recon_cuda`; the error output feeds the
    batched approximation-error metric without a second pass.
    """
    if carry is None:
        carry = recon_init_carry(a_t.shape[1], a_t.device)
    if a_t.device.type == "cpu":
        return recon_err_plain(brk_t, a_t, v_t, y_t, carry)
    return launch_recon_err(brk_t, a_t, v_t, y_t, carry)
