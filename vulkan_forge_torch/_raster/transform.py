"""Vertex stages ("vertex shaders") as batched torch math.

Port of ``vulkan_forge/_raster/transform.py``:
  - terrain_vs: src/shaders/terrain.wgsl:44-66 (height sample + analytic
    fallback + world/clip transform).
  - triangle_vs: src/shaders/triangle.wgsl:6-16 (passthrough, z=0 w=1).

Matrix convention: ``view``/``proj`` are row-major math-convention (4,4)
float32; clip = (world @ view.T) @ proj.T. The two 4x4 products are written
out as f32 elementwise ops, each output component summed as
``(p0 + p1) + (p2 + p3)``: that is the order XLA:CPU's dot uses (bit-equal
on the default TerrainSpike), it cannot pick up TF32, and it gives the same
bits on the CPU and on a card. A leading batch axis on ``view``/``proj``
renders several cameras at once.
"""
from __future__ import annotations

import torch


def sample_height_nearest(heights: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest, clamp-to-edge sampling of an R32Float texture at uv.

    ``heights``: (Ht, Wt) f32; ``uv``: (N, 2) in [0,1]. Matches the
    NonFiltering sampler of the reference (src/terrain/pipeline.rs:39-59).
    """
    ht, wt = heights.shape
    tx = torch.clamp(torch.floor(uv[:, 0] * wt), 0, wt - 1).to(torch.long)
    ty = torch.clamp(torch.floor(uv[:, 1] * ht), 0, ht - 1).to(torch.long)
    return heights[ty, tx]


def analytic_height(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Deterministic analytic fallback relief (src/shaders/terrain.wgsl:39-41)."""
    return torch.sin(x * 1.3) * 0.25 + torch.cos(z * 1.1) * 0.25


def _rows_times_mt(v, m):
    """``v @ m.T`` for 4-vectors ``v`` (list of 4 (..., N) tensors) and
    (..., 4, 4) matrices ``m``, in XLA:CPU's summation order."""
    out = []
    for i in range(4):
        p = [v[k] * m[..., i, k, None] for k in range(4)]
        out.append((p[0] + p[1]) + (p[2] + p[3]))
    return out


def terrain_vs(xyuv: torch.Tensor, heights: torch.Tensor, view: torch.Tensor,
               proj: torch.Tensor, spacing: torch.Tensor,
               exaggeration: torch.Tensor):
    """Terrain vertex stage.

    xyuv: (N, 4) [x, z, u, v] plane vertices; view/proj: (4, 4) or
    (B, 4, 4). Returns (clip (..., N, 4), varyings (N, 3) = [height, x, z])
    -- the interpolants the fragment stage consumes
    (src/shaders/terrain.wgsl:30-36). Varyings do not depend on the camera.
    """
    x = xyuv[:, 0]
    z = xyuv[:, 1]
    uv = xyuv[:, 2:4]
    spacing = torch.clamp_min(spacing, 1e-8)  # shader guard (terrain.wgsl:46)

    h_tex = sample_height_nearest(heights, uv)
    h = h_tex + analytic_height(x, z)

    wx = x * spacing
    wy = h * exaggeration
    wz = z * spacing
    world = [wx, wy, wz, torch.ones_like(wx)]

    view_pos = _rows_times_mt(world, view.to(torch.float32))
    clip = torch.stack(_rows_times_mt(view_pos, proj.to(torch.float32)), dim=-1)
    varyings = torch.stack([h, x, z], dim=-1)
    return clip, varyings


def triangle_vs(pos2: torch.Tensor, color3: torch.Tensor):
    """Gradient-triangle vertex stage (passthrough; z=0, w=1)."""
    n = pos2.shape[0]
    clip = torch.cat(
        [pos2.to(torch.float32),
         torch.zeros((n, 1), dtype=torch.float32, device=pos2.device),
         torch.ones((n, 1), dtype=torch.float32, device=pos2.device)], dim=-1)
    return clip, color3.to(torch.float32)
