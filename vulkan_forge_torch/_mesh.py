"""Grid mesh generation for regular (W,H) heightmaps.

Semantics parity with the reference grid generator (src/terrain/mesh.rs:35-90
and the Python wrapper src/terrain/mesh.rs:157-203):

  - positions are centered at the origin in world XY:
      x in [-(W-1)/2*dx, +(W-1)/2*dx], y in [-(H-1)/2*dy, +(H-1)/2*dy]
  - UVs cover [0,1]^2: u = x/(W-1), v = y/(H-1)
  - two CCW triangles per cell: [i0, i1, i2, i2, i1, i3]
  - internal index dtype switches u16 -> u32 above 65,535 vertices
    (src/terrain/mesh.rs:29-32); the public function always returns uint32.
  - exact reference ValueError messages.

Implementation is vectorized NumPy instead of the reference's scalar loops;
output is bit-identical because every element goes through the same f32 ops
in the same order (x*dx - cx etc.). A copy of ``vulkan_forge/_mesh.py``
without its native fast path: importing ``vulkan_forge`` loads jax.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_grid(w: int, h: int, dx: float, dy: float):
    """Build a (W,H) grid; returns (xy (N,2) f32, uv (N,2) f32, idx u16|u32).

    Parity: src/terrain/mesh.rs:35-90 (including the u16/u32 index switch).
    """
    if not (w >= 2 and h >= 2):
        raise AssertionError("grid must be at least 2x2")
    dx = np.float32(dx)
    dy = np.float32(dy)
    if not (np.isfinite(dx) and np.isfinite(dy) and dx > 0 and dy > 0):
        raise AssertionError("dx/dy must be finite and > 0")

    cx = np.float32(np.float32(w) - np.float32(1.0)) * np.float32(0.5) * dx
    cy = np.float32(np.float32(h) - np.float32(1.0)) * np.float32(0.5) * dy

    xs = np.arange(w, dtype=np.float32) * dx - cx          # (W,)
    ys = np.arange(h, dtype=np.float32) * dy - cy          # (H,)
    us = np.arange(w, dtype=np.float32) / np.float32(w - 1)
    vs = np.arange(h, dtype=np.float32) / np.float32(h - 1)

    xy = np.empty((h, w, 2), dtype=np.float32)
    xy[..., 0] = xs[None, :]
    xy[..., 1] = ys[:, None]
    uv = np.empty((h, w, 2), dtype=np.float32)
    uv[..., 0] = us[None, :]
    uv[..., 1] = vs[:, None]

    n_verts = w * h
    idx_dtype = np.uint16 if n_verts <= 0xFFFF else np.uint32
    idx = grid_indices(w, h, idx_dtype)
    return xy.reshape(n_verts, 2), uv.reshape(n_verts, 2), idx


def grid_indices(w: int, h: int, dtype=np.uint32) -> np.ndarray:
    """CCW cell indices [i0,i1,i2, i2,i1,i3] (src/terrain/mesh.rs:62-89)."""
    row = (np.arange(h - 1, dtype=np.int64)[:, None] * w
           + np.arange(w - 1, dtype=np.int64)[None, :])       # (H-1, W-1) base i0
    i0 = row
    i1 = row + 1
    i2 = row + w
    i3 = row + w + 1
    tris = np.stack([i0, i1, i2, i2, i1, i3], axis=-1)          # (H-1, W-1, 6)
    return tris.reshape(-1).astype(dtype)


def grid_generate(nx: int, nz: int, spacing: Tuple[float, float] = (1.0, 1.0),
                  origin: "str | None" = "center"):
    """Generate a regular grid mesh for heightmaps.

    Returns (XY (nx*nz,2) f32, UV (nx*nz,2) f32, indices (M,) u32).
    Parity incl. exact error strings: src/terrain/mesh.rs:157-203.
    """
    nx = int(nx)
    nz = int(nz)
    if nx < 2 or nz < 2:
        raise ValueError("nx and nz must be >= 2")
    dx, dy = (float(spacing[0]), float(spacing[1]))
    if not (np.isfinite(dx) and np.isfinite(dy) and dx > 0.0 and dy > 0.0):
        raise ValueError("spacing components must be finite and > 0")
    origin_str = "center" if origin is None else str(origin)
    if origin_str != "center":
        raise ValueError("origin must be 'center'")

    xy, uv, idx = make_grid(nx, nz, dx, dy)
    return (np.ascontiguousarray(xy), np.ascontiguousarray(uv),
            np.ascontiguousarray(idx.astype(np.uint32)))


def build_grid_xyuv(n: int):
    """Analytic spike grid over [-1.5, 1.5]^2 with [x, z, u, v] vertices.

    Used by TerrainSpike/Scene; parity: src/terrain/mod.rs:553-598 and
    src/scene/mod.rs:85-116. NOTE: the winding here is [a, c, b, b, c, d] —
    intentionally different from grid_generate's [i0,i1,i2, i2,i1,i3].
    Returns (xyuv (n*n, 4) f32, idx (M,) u32).
    """
    n = max(int(n), 2)
    w = h = n
    scale = np.float32(1.5)
    step_x = (np.float32(2.0) * scale) / np.float32(w - 1)
    step_z = (np.float32(2.0) * scale) / np.float32(h - 1)

    xs = -scale + np.arange(w, dtype=np.float32) * step_x
    zs = -scale + np.arange(h, dtype=np.float32) * step_z
    us = np.arange(w, dtype=np.float32) / np.float32(w - 1)
    vs = np.arange(h, dtype=np.float32) / np.float32(h - 1)

    verts = np.empty((h, w, 4), dtype=np.float32)
    verts[..., 0] = xs[None, :]
    verts[..., 1] = zs[:, None]
    verts[..., 2] = us[None, :]
    verts[..., 3] = vs[:, None]

    # Direct uint32 fill (identical values to the former
    # int64-stack-then-cast; ~3x cheaper at n=1024: 81 -> ~25 ms).
    a = (np.arange(h - 1, dtype=np.uint32)[:, None] * np.uint32(w)
         + np.arange(w - 1, dtype=np.uint32)[None, :])
    idx = np.empty((h - 1, w - 1, 6), dtype=np.uint32)
    idx[..., 0] = a                     # [a, c, b, b, c, d]
    idx[..., 1] = a + np.uint32(w)
    idx[..., 2] = a + np.uint32(1)
    idx[..., 3] = a + np.uint32(1)
    idx[..., 4] = a + np.uint32(w)
    idx[..., 5] = a + np.uint32(w + 1)
    return verts.reshape(w * h, 4), idx.reshape(-1)
