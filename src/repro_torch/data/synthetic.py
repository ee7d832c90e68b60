"""Statistically-matched surrogates for the paper's four datasets.

The originals (GeoLife GPS, Ford-Campus LiDAR, Rio URBAN speeds, UCR) are
not redistributable offline; these generators mimic the signal character
that drives PLA behaviour (smoothness, bursts, sampling cadence, range):

- ``gps``:   2nd-order smooth trajectories (slowly varying velocity),
             occasional stops and GPS multipath noise bursts.  Units ~ m.
- ``lidar``: rotating range scans — piecewise-smooth sweeps with sharp
             object edges and max-range dropouts.  Units ~ m.
- ``urban``: mean-reverting AR(1) vehicle speeds with rush-hour
             seasonality, 5-minute cadence.  Units ~ km/h.
- ``ucr``:   heterogeneous bank of wave-like series (sine mixtures, ECG-ish
             spikes, random walks) echoing UCR's diversity.

Each returns ``(ts, ys)`` float64 arrays with strictly increasing ``ts``.
The paper's eps grids per dataset are exported as ``EPS_GRID``.

This module is a copy of ``repro/data/synthetic.py`` (numpy only; the port
imports nothing of the JAX package).  :func:`make_batch` is the port's
addition: a seeded ``(S, T)`` float32 batch on a device, for callers that
need the same data in every process (``make_dataset`` salts its seed with
``hash(name)``, which Python randomises per process).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device

EPS_GRID = {
    "gps": (1.0, 10.0, 50.0),       # meters (paper §6.2)
    "lidar": (0.1, 2.0, 20.0),      # meters
    "urban": (0.5, 1.0, 5.0),       # km/h
    "ucr": ("p0.5", "p5", "p5C"),   # percent-of-range thresholds
}


def _gps(rng: np.random.Generator, n: int) -> Tuple[np.ndarray, np.ndarray]:
    ts = np.arange(n, dtype=float)  # 1 Hz fixes
    vel = np.zeros(n)
    acc = rng.normal(0, 0.02, n)
    # stop-and-go: zero acceleration/velocity during stops
    stop = np.zeros(n, bool)
    i = 0
    while i < n:
        if rng.random() < 0.1:
            d = rng.integers(20, 200)
            stop[i:i + d] = True
            i += d
        i += rng.integers(50, 400)
    vel = np.cumsum(np.where(stop, 0.0, acc))
    vel = np.where(stop, 0.0, np.clip(vel, -30, 30))
    pos = np.cumsum(vel)
    noise = rng.normal(0, 1.5, n)
    burst = (rng.random(n) < 0.01) * rng.normal(0, 8, n)  # multipath
    return ts, pos + noise + burst


def _lidar(rng: np.random.Generator, n: int) -> Tuple[np.ndarray, np.ndarray]:
    ts = np.arange(n, dtype=float)  # beam index within a rotation
    angle = 2 * np.pi * ts / 1500.0
    y = np.full(n, 120.0)  # max range
    # a handful of smooth 'objects' (walls/cars) across angular sectors
    for _ in range(rng.integers(8, 20)):
        a0 = rng.uniform(0, 2 * np.pi)
        width = rng.uniform(0.05, 0.6)
        dist = rng.uniform(2, 80)
        m = np.abs((angle - a0 + np.pi) % (2 * np.pi) - np.pi) < width
        y[m] = dist / np.maximum(
            np.cos((angle[m] - a0) / np.maximum(width, 1e-3) * 0.8), 0.2)
    y = y + rng.normal(0, 0.03, n)
    drop = rng.random(n) < 0.02
    y[drop] = 120.0
    return ts, y


def _urban(rng: np.random.Generator, n: int) -> Tuple[np.ndarray, np.ndarray]:
    ts = np.arange(n, dtype=float) * 5.0  # 5-minute cadence (minutes)
    day = 288.0  # samples per day at 5 min — here in *samples*
    t = np.arange(n)
    season = (12.0 * np.sin(2 * np.pi * t / day)
              + 6.0 * np.sin(4 * np.pi * t / day + 1.0))
    x = np.zeros(n)
    mean = 38.0
    for i in range(1, n):
        x[i] = 0.92 * x[i - 1] + rng.normal(0, 2.2)
    y = np.clip(mean + season + x, 0, 90)
    return ts, y


def _ucr(rng: np.random.Generator, n: int) -> Tuple[np.ndarray, np.ndarray]:
    ts = np.arange(n, dtype=float)
    kind = rng.integers(0, 4)
    if kind == 0:     # sine mixture
        y = sum(rng.uniform(0.5, 3) * np.sin(2 * np.pi * ts
                                             / rng.uniform(20, 400)
                                             + rng.uniform(0, 6))
                for _ in range(3))
    elif kind == 1:   # ECG-ish: periodic spikes over baseline wander
        y = 0.3 * np.sin(2 * np.pi * ts / 500)
        period = rng.integers(40, 120)
        for s in range(0, n, period):
            w = min(8, n - s)
            y[s:s + w] += np.hanning(2 * w)[:w] * rng.uniform(3, 6)
    elif kind == 2:   # random walk
        y = np.cumsum(rng.normal(0, 0.5, n))
    else:             # step levels
        y = np.repeat(rng.normal(0, 2, max(1, -(-n // 64))), 64)[:n]
        y = y + rng.normal(0, 0.05, n)
    return ts, y


_GENS = {"gps": _gps, "lidar": _lidar, "urban": _urban, "ucr": _ucr}
DATASETS = tuple(_GENS)


def make_dataset(name: str, n: int = 20000, seed: int = 0, files: int = 1):
    """Returns a list of (ts, ys) traces."""
    rng = np.random.default_rng(seed + hash(name) % (2 ** 16))
    return [_GENS[name](rng, n) for _ in range(files)]


def make_batch(name: str, n_streams: int, n: int,
               rng: np.random.Generator, device=None) -> torch.Tensor:
    """``n_streams`` traces of surrogate ``name`` as an ``(S, n)`` float32
    tensor on ``device`` (default ``"cuda"``), drawn in order from ``rng``."""
    dev = resolve_device(device)
    y = np.empty((n_streams, n), np.float32)
    for s in range(n_streams):
        y[s] = _GENS[name](rng, n)[1]
    return torch.from_numpy(y).to(dev)


def ucr_eps(ys: np.ndarray, spec: str) -> float:
    """The paper's UCR eps rules: % of (trimmed) value range."""
    if spec == "p0.5":
        lo, hi = np.percentile(ys, [5, 95])
        return 0.005 * (hi - lo)
    if spec == "p5":
        lo, hi = np.percentile(ys, [5, 95])
        return 0.05 * (hi - lo)
    if spec == "p5C":
        return 0.05 * (ys.max() - ys.min())
    return float(spec)
