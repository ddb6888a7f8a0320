"""DEM statistics, normalization, and percentile height-range helpers.

Parity targets:
  - ``dem_stats`` / ``dem_normalize``: the pure-Python helpers from the
    reference shim (python/vulkan_forge/__init__.py:120-142), incl. the exact
    validation message.
  - ``dem_stats_from_slice`` / ``normalize_in_place`` semantics: the Rust
    single-pass versions used by Renderer.terrain_stats / normalize_terrain
    (src/lib.rs:905-951).
  - ``min_max(data, clamp)``: percentile-clamped range with deterministic
    stride sampling above 65,536 samples (src/terrain_stats.rs:11-35).
  - ``TerrainMeta``: height-range store with the reference's clamping and
    exact ValueError strings (src/renderer.rs:6-42).

A numpy-only copy of ``vulkan_forge/_dem.py``: importing ``vulkan_forge``
loads jax. ``tests/test_torch_host.py`` holds the two byte-equal.
"""
from __future__ import annotations

import numpy as np


def dem_stats(heightmap):
    """(min, max, mean, std) of a 2-D float32/float64 C-contiguous array."""
    a = np.asarray(heightmap)
    if a.ndim != 2 or a.dtype not in (np.float32, np.float64) or not a.flags["C_CONTIGUOUS"]:
        raise RuntimeError("heightmap must be 2-D float32/float64 and C-contiguous")
    a = a.astype(np.float32, copy=False)
    mn = float(a.min())
    mx = float(a.max())
    mean = float(a.mean())
    std = float(a.std(dtype=np.float32))
    return mn, mx, mean, std


def dem_normalize(heightmap, *, mode="minmax", out_range=(0.0, 1.0), eps=1e-8,
                  return_stats=False):
    """Normalize a DEM (minmax to out_range, or zscore)."""
    mn, mx, mean, std = dem_stats(heightmap)
    a = np.asarray(heightmap).astype(np.float32, copy=False)
    if mode == "minmax":
        lo, hi = map(float, out_range)
        scale = 0.0 if mx == mn else (hi - lo) / max(mx - mn, float(eps))
        out = (a - mn) * scale + lo
    elif mode == "zscore":
        out = (a - mean) / max(std, float(eps))
    else:
        raise ValueError("mode must be 'minmax' or 'zscore'")
    if return_stats:
        return out, (mn, mx, mean, std)
    return out


def dem_stats_from_slice(heights: np.ndarray):
    """Single-pass f32 min/max/mean/std (parity: src/lib.rs:905-932).

    Population std (divide by N), f32 accumulation semantics.
    """
    h = np.asarray(heights, dtype=np.float32).reshape(-1)
    if h.size == 0:
        return 0.0, 0.0, 0.0, 0.0
    mn = float(h.min())
    mx = float(h.max())
    mean = float(np.mean(h, dtype=np.float32))
    var = float(np.mean((h - np.float32(mean)) ** 2, dtype=np.float32))
    return mn, mx, mean, float(np.sqrt(var))


def normalize_in_place(heights: np.ndarray, mode: str, eps: float,
                       out_range, stats) -> np.ndarray:
    """Normalize heights (parity: src/lib.rs:934-951). Returns new array."""
    mn, mx, mean, std = stats
    h = np.asarray(heights, dtype=np.float32)
    if mode == "minmax":
        lo, hi = out_range
        denom = max(abs(mx - mn), eps)
        scale = np.float32((hi - lo) / denom)
        return (h - np.float32(mn)) * scale + np.float32(lo)
    elif mode == "zscore":
        denom = np.float32(max(std, eps))
        return (h - np.float32(mean)) / denom
    else:
        raise RuntimeError("mode must be 'minmax' or 'zscore'")


def min_max(data: np.ndarray, clamp: bool):
    """(min, max) or the deterministic 1-99 percentile range if clamp.

    Parity: src/terrain_stats.rs:11-35 — stride sampling (step = len//65536)
    above 65,536 samples, full sort otherwise, p1/p99 by truncated index.
    """
    d = np.asarray(data, dtype=np.float32).reshape(-1)
    if d.size == 0:
        raise AssertionError("heightmap slice empty")
    if not clamp:
        return float(d.min()), float(d.max())
    SAMPLE = 65_536
    if d.size > SAMPLE:
        step = d.size // SAMPLE
        buf = d[::step].copy()
    else:
        buf = d.copy()
    buf.sort()
    p1 = buf[int(buf.size * np.float32(0.01))]
    p99 = buf[int(buf.size * np.float32(0.99))]
    return float(p1), float(p99)


class TerrainMeta:
    """Stored height normalization range (parity: src/renderer.rs:6-42)."""

    def __init__(self) -> None:
        self.h_min = 0.0
        self.h_max = 1.0

    def compute_and_store_h_range(self, heights: np.ndarray) -> None:
        h_min, h_max = min_max(heights, clamp=True)
        self.h_min = h_min
        self.h_max = max(h_max, h_min + 1e-5)  # avoid div/0

    def set_height_range(self, min: float, max: float) -> None:
        mn, mx = float(min), float(max)
        if not (np.isfinite(mn) and np.isfinite(mx)):
            raise ValueError("min/max must be finite floats")
        if mn >= mx:
            raise ValueError("min must be < max")
        self.h_min = mn
        self.h_max = mx
