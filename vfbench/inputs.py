"""Seeded inputs the benchmark hands to the program and to the reference.

- ``orbit_eyes``: the eyes of ``bench.py``'s orbit cameras
  (``bench.py:55-67``; ``chip_smoke.orbit_eyes`` is the same formula).
- ``dem_tile``: ``chip_smoke.dem`` / ``dem_heights``' seeded relief, six
  sine ramps of random amplitude, frequency and phase summed and scaled to
  ~1.5 km, computed on the device in float64 in one pass and returned as
  a float32 numpy array, as a user's DEM arrives.
- ``rng``: one numpy generator per (seed, stream), for any whole seed.
"""
from __future__ import annotations

import math

import numpy as np
import torch

DEM_RELIEF = 1500.0
DEM_WAVES = 6


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` and a stream id: the same pair gives the
    same draws; any integer seed (negative ones and ones past 2**63 too)."""
    return np.random.default_rng([seed % 2**64, *stream])


def orbit_eyes(n: int, phase: float = 0.0):
    """The eyes of ``n`` cameras on ``bench.py``'s orbit around the spike:
    radius 3, height 2 + 0.1 sin(phase), spread evenly from ``phase``."""
    angles = (2.0 * math.pi * i / max(n, 1) + phase for i in range(n))
    return [(3.0 * math.cos(a), 2.0 + 0.1 * math.sin(phase), 3.0 * math.sin(a))
            for a in angles]


def dem_tile(n: int, seed: int, tile: int, device) -> np.ndarray:
    """An n x n DEM in metres, float32, made on ``device`` from (seed,
    tile): ``chip_smoke.dem``'s relief (amplitude U[0.05, 0.2], row and
    column frequencies U[1, 4], phase U[0, 1) per wave) times 1500."""
    draws = rng(seed, 2, tile)
    waves = [(draws.uniform(0.05, 0.2), draws.uniform(1, 4), draws.uniform(1, 4),
              draws.uniform()) for _ in range(DEM_WAVES)]
    idx = torch.arange(n, dtype=torch.float64, device=device) / n
    y, x = idx[:, None], idx[None, :]
    h = torch.zeros((n, n), dtype=torch.float64, device=device)
    for amp, fx, fy, ph in waves:
        h += amp * torch.sin(2 * math.pi * (fx * x + fy * y + ph))
    return (h.to(torch.float32) * DEM_RELIEF).cpu().numpy()
