"""State carried across from the JAX reference into the port.

This system has no weights: its data is made from a seed, and its state is
the segmenter carry.  These functions take the reference's state as numpy
arrays (anything ``np.asarray`` accepts, jax arrays included) and return the
port's tensors, so a stream begun by the reference can be finished here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.angle import ANGLE_STATE_ROWS
from ..kernels.swing import SWING_STATE_ROWS
from .pla import SegmentOutput

__all__ = ["segment_output_from_reference", "carry_from_reference"]

_ROWS = {"swing": SWING_STATE_ROWS, "angle": ANGLE_STATE_ROWS}


def segment_output_from_reference(breaks, a, v, device) -> SegmentOutput:
    """A reference ``SegmentOutput``'s three ``(S, T)`` arrays as the port's."""
    dev = resolve_device(device)
    return SegmentOutput(torch.tensor(np.asarray(breaks, bool), device=dev),
                         torch.tensor(np.asarray(a, np.float32), device=dev),
                         torch.tensor(np.asarray(v, np.float32), device=dev))


def carry_from_reference(method: str, carry, device=None) -> torch.Tensor:
    """The reference's segmenter state as the port's packed ``(C, S)`` carry.

    ``carry`` is either the jnp ``SegmenterState.carry`` tuple of ``(S,)``
    arrays, Swing ``(od, oy, slo, shi, run_len)`` or Angle
    ``(phase, p0y, od, oy, slo, shi, run_len)``, which becomes the packed
    rows after a ``started = 1`` row; or a Pallas-layout packed carry
    ``(C, Sp)``, whose row layout the port shares, taken as it is.
    """
    if method not in _ROWS:
        raise ValueError(f"no carry layout for {method!r}; have "
                         f"{sorted(_ROWS)}")
    rows = _ROWS[method]
    dev = resolve_device(device)
    if isinstance(carry, (tuple, list)):
        parts = [np.asarray(x, np.float32) for x in carry]
        if len(parts) != rows - 1:
            raise ValueError(f"{method} carry has {rows - 1} arrays; "
                             f"got {len(parts)}")
        packed = np.stack([np.ones_like(parts[0])] + parts)
    else:
        packed = np.asarray(carry, np.float32)
        if packed.ndim != 2 or packed.shape[0] != rows:
            raise ValueError(f"packed {method} carry must be ({rows}, S); "
                             f"got {packed.shape}")
    return torch.tensor(packed, device=dev)
