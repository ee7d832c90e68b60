"""Shared plumbing of the PLA CUDA kernels and their plain versions.

Counterpart of ``repro/kernels/common.py``.  What carries over from the
Pallas contract:

- **Layout.** Kernels take streams **time-major**, ``(T, S)``: at each step
  a warp reads 32 neighbouring streams in one coalesced transaction.  The
  public functions (:mod:`repro_torch.kernels.ops`,
  :mod:`repro_torch.core.pla`) take the natural ``(S, T)`` layout and
  transpose at the boundary.
- **Carry.** Every kernel owns a packed float32 carry ``(C, S)``, one row
  per scalar of per-stream state (integer rows stored as exact small
  floats).  It is read at the start of a launch and written at the end, so
  chunked launches resume bit-exactly.  Row 0 of every segmenter carry is
  ``started``, which replaces a ``t == 0`` special case: a resumed launch
  never re-runs first-point initialisation.  Row layouts are documented per
  kernel module (``*_STATE_ROWS``).  All state is relative to the current
  step, so no host-side shift is needed between launches.
- **Events.** While processing local time ``t`` a segmenter may decide that
  the current segment ended at ``t-1``; it writes that event at row ``t``.
  A forced break at ``t == t_real`` (``-1`` disables it) closes the trailing
  run through the same path.  :func:`pad_streams` adds the one time step
  the forced break needs and :func:`assemble_segments` shifts the events
  into the ``(S, T)`` form.

What does not carry over: the ``(S/BS, T/BT)`` grid.  A CUDA kernel here is
one thread per stream with the whole time loop inside the thread, so no
input is padded to a block multiple; the kernels mask the ragged edge.

Each kernel module holds three things: the wrapper (``*_cuda``), which runs
the kernel on a CUDA tensor and the plain version on a CPU tensor; the plain
PyTorch version (``*_plain``), a Python loop over time, vectorised over
streams; and the kernel entry (``launch_*``), which checks its arguments,
launches and counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Sequence, Tuple

import torch

from . import build

__all__ = ["BIG", "LAUNCHES", "reset_launches", "fma_f32", "pad_streams",
           "assemble_segments", "stream_major", "check_cuda_args",
           "launch", "launch_segmenter"]

BIG = 3.4e38

# Launches of each kernel since the last reset_launches(): counted by the
# kernel entries where they launch, and nowhere else.
LAUNCHES: Dict[str, int] = {"swing": 0, "angle": 0, "recon": 0,
                            "recon_err": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a * b + c`` in float32 with one rounding, as ``__fmaf_rn`` does.

    The plain versions use it at the sites where the kernels call
    ``__fmaf_rn``.  The product of two float32 values is exact in float64;
    the float64 sum is then rounded *to odd* (an inexact result whose last
    bit is even moves one ulp toward the exact sum, found with TwoSum), and
    a round-to-odd value with 29 spare bits rounds to the correctly rounded
    float32 result.
    """
    p = a.double() * b.double()
    c64 = c.double()
    r = p + c64
    z = r - p
    err = (p - (r - z)) + (c64 - z)
    even = (r.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(r, math.inf), err)
    r = torch.where((err != 0) & even, torch.nextafter(r, toward), r)
    return r.float()


def pad_streams(y: torch.Tensor) -> torch.Tensor:
    """``(S, T)`` streams -> time-major ``(T + 1, S)``.

    The extra step repeats the final value: the offline launch forces a
    break at ``t == T`` there, so the trailing run flushes through the
    regular event path.
    """
    S, T = y.shape
    y_t = torch.empty((T + 1, S), dtype=torch.float32, device=y.device)
    y_t[:T] = y.t()
    y_t[T] = y[:, -1]
    return y_t


def stream_major(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Time-major ``(n, S)`` -> contiguous ``(S, n)`` in one copy."""
    out = torch.empty((x.shape[1], x.shape[0]), dtype=dtype or x.dtype,
                      device=x.device)
    return out.copy_(x.t())


def assemble_segments(ev_brk, ev_a, ev_v, T: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Offline events ``(T + 1, S)`` -> ``(breaks, a, v)``, each ``(S, T)``.

    An event at row ``t`` means "a segment ended at ``t - 1``"; the forced
    break at row ``T`` closes the trailing run, so rows ``1..T`` cover break
    positions ``0..T-1`` completely.
    """
    return (stream_major(ev_brk[1:T + 1], torch.bool),
            stream_major(ev_a[1:T + 1]), stream_major(ev_v[1:T + 1]))


def check_cuda_args(time_major: Sequence[Tuple[str, torch.Tensor,
                                               torch.dtype]],
                    others: Sequence[Tuple[str, torch.Tensor, torch.dtype,
                                           Tuple[int, ...]]]
                    ) -> Tuple[int, int]:
    """Validate a kernel entry's tensors before their pointers go to C.

    ``time_major`` tensors must share one ``(T, S)`` shape; ``others`` carry
    their expected shape.  Every tensor must be a contiguous CUDA tensor of
    its dtype on one device.  Returns ``(T, S)``.
    """
    T, S = time_major[0][1].shape
    device = time_major[0][1].device
    if S < 1:
        raise ValueError("a kernel launch needs at least one stream")
    checks = [(n, x, dt, (T, S)) for n, x, dt in time_major] + list(others)
    for name, x, dtype, shape in checks:
        if x.device.type != "cuda" or x.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device}; "
                             f"got {x.device} (CPU tensors go through the "
                             f"plain version via the *_cuda wrappers)")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}; got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}; "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return T, S


def launch(counter: str, source: str, symbol: str, argtypes: Sequence,
           args: Sequence, device: torch.device) -> None:
    """Call a kernel's C entry on the current stream; raise on its error.

    ``args`` are the entry's arguments without the trailing stream; tensors
    are passed by ``data_ptr()``.  The launch is counted only once the entry
    reports success.
    """
    fn = build.function(source, symbol, argtypes)
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    code = fn(*c_args, stream)
    if code != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with "
                           f"cudaError_t {code}")
    LAUNCHES[counter] += 1


# C signatures: pointers and the stream as c_void_p, so ctypes never cuts
# a 64-bit address to a 32-bit int.
_P, _I = ctypes.c_void_p, ctypes.c_int
SEGMENTER_ARGTYPES = (_P,) * 7 + (_I,) * 4 + (_P,)
RECON_ARGTYPES = (_P,) * 6 + (_I,) * 2 + (_P,)
RECON_ERR_ARGTYPES = (_P,) * 8 + (_I,) * 2 + (_P,)


def launch_segmenter(name: str, rows: int, y_t: torch.Tensor,
                     eps: torch.Tensor, carry: torch.Tensor, *,
                     max_run: int, t_real: int):
    """Launch the ``csrc/<name>.cu`` segmenter on time-major ``y_t (T, S)``.

    ``eps`` is per stream ``(S,)``, ``carry`` the packed ``(rows, S)``
    state.  Returns the events ``(brk int8, a, v)``, each ``(T, S)``, and
    the carry after the launch.  CUDA tensors only: this is the kernel
    entry.
    """
    T, S = check_cuda_args(
        [("y_t", y_t, torch.float32)],
        [("eps", eps, torch.float32, (y_t.shape[1],)),
         ("carry", carry, torch.float32, (rows, y_t.shape[1]))])
    brk = torch.empty((T, S), dtype=torch.int8, device=y_t.device)
    a = torch.empty((T, S), dtype=torch.float32, device=y_t.device)
    v = torch.empty_like(a)
    carry_out = torch.empty_like(carry)
    launch(name, name, f"{name}_launch", SEGMENTER_ARGTYPES,
           (y_t, eps, carry, brk, a, v, carry_out, T, S, int(max_run),
            int(t_real)), y_t.device)
    return brk, a, v, carry_out
