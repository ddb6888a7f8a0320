"""Terrain globals and the 176-byte / 44-float uniform-buffer emulation.

Parity targets:
  - ``Globals`` defaults: sun (0.5,0.8,0.6) normalized, exposure 1,
    spacing 1, h in [-0.5, 0.5], exaggeration 1 (src/terrain/mod.rs:188-200).
  - ``TerrainUniforms`` layout: view(64B col-major) + proj(64B col-major) +
    (sun_dir.xyz, exposure) + (spacing, h_range, exaggeration, 0) + 16B pad
    = 176 bytes = 44 f32 (src/terrain/mod.rs:114-141, pinned by the Rust
    layout test src/terrain/mod.rs:698-707 and tests/test_t31_integration.py).
  - Spherical sun direction: Y-up, azimuth 0 along +X, CCW toward +Z
    (src/lib.rs:444-453).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def _normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    n = np.float32(np.sqrt(np.sum(v * v, dtype=np.float32)))
    if n <= 0.0 or not np.isfinite(n):
        return np.zeros(3, dtype=np.float32)
    return (v / n).astype(np.float32)


def sun_dir_spherical(elevation_deg: float, azimuth_deg: float) -> np.ndarray:
    """Spherical angles (degrees) -> unit vector (parity: src/lib.rs:444-453)."""
    el = np.float32(float(elevation_deg) * math.pi / 180.0)
    az = np.float32(float(azimuth_deg) * math.pi / 180.0)
    se, ce = np.float32(np.sin(el)), np.float32(np.cos(el))
    sa, ca = np.float32(np.sin(az)), np.float32(np.cos(az))
    return _normalize(np.array([ce * ca, se, ce * sa], dtype=np.float32))


@dataclass
class Globals:
    """Scene-wide shading state (parity: src/terrain/mod.rs:178-215)."""

    sun_dir: np.ndarray = field(
        default_factory=lambda: _normalize(np.array([0.5, 0.8, 0.6], dtype=np.float32)))
    exposure: float = 1.0
    spacing: float = 1.0
    h_min: float = -0.5
    h_max: float = 0.5
    exaggeration: float = 1.0

    @property
    def h_range(self) -> float:
        return float(np.float32(self.h_max) - np.float32(self.h_min))

    def to_uniforms(self, view: np.ndarray, proj: np.ndarray) -> np.ndarray:
        """Pack the 44-float UBO image (view/proj stored column-major)."""
        return pack_uniforms(view, proj, self.sun_dir, self.exposure,
                             self.spacing, self.h_range, self.exaggeration)


def pack_uniforms(view, proj, sun_dir, exposure, spacing, h_range,
                  exaggeration) -> np.ndarray:
    """44-float TerrainUniforms image (parity: src/terrain/mod.rs:114-141).

    ``view``/``proj`` are row-major math-convention (4,4) arrays (what the
    camera functions return); they are stored column-major like glam's
    to_cols_array_2d, so ``debug_uniforms_f32`` round-trips with
    ``reshape(4, 4, order='F')`` as the tests do.
    """
    u = np.zeros(44, dtype=np.float32)
    u[0:16] = np.asarray(view, dtype=np.float32).flatten(order="F")
    u[16:32] = np.asarray(proj, dtype=np.float32).flatten(order="F")
    s = np.asarray(sun_dir, dtype=np.float32).reshape(3)
    u[32:36] = [s[0], s[1], s[2], np.float32(exposure)]
    u[36:40] = [np.float32(spacing), np.float32(h_range),
                np.float32(exaggeration), 0.0]
    # u[40:44] stays zero (_pad_tail)
    return u


def default_view_proj(width: int, height: int):
    """Default camera: eye(3,2,3)->origin, fovy 45deg, z 0.1..100, wgpu clip.

    Parity: src/terrain/mod.rs:681-691 / src/scene/mod.rs:16-22,119-121.
    Returns (view, proj, light) with light = normalize(0.5, 1.0, 0.3).
    """
    from ._camera import look_at_rh, perspective_wgpu
    aspect = np.float32(width) / np.float32(height)
    proj = perspective_wgpu(np.float32(math.radians(45.0)), aspect,
                            np.float32(0.1), np.float32(100.0))
    view = look_at_rh((3.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    light = _normalize(np.array([0.5, 1.0, 0.3], dtype=np.float32))
    return view, proj, light
