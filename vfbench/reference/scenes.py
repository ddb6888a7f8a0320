"""The plain reference's frames, one function per kind of public entry.

Each takes the inputs the benchmark handed to the program (eyes, a DEM,
the sun's angles, an exposure) and works out again everything the program
derived from them: the mesh, the camera matrices, the sun vector, the LUT
and the DEM's height range. Returns (B, H, W, 4) uint8 RGBA, as the
program's entries return it. ``tf32=True`` computes the control (see
``raster``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import host, raster

# The spike's globals (src/terrain/mod.rs:188-200, 327): heights in
# [-0.5, 0.5], exposure 1, sun along (0.5, 1.0, 0.3).
SPIKE_H_MIN, SPIKE_H_MAX, SPIKE_EXPOSURE = -0.5, 0.5, 1.0
SPIKE_SUN = (0.5, 1.0, 0.3)


def _t(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def spike_frames(width: int, height: int, grid: int, eyes, colormap: str, device,
                 tf32: bool = False) -> np.ndarray:
    """Frames of the analytic spike at ``grid``, one per eye (looking at the
    origin, Y up, fovy 45, near 0.1, far 100), shipped shader."""
    xyuv, tris = host.spike_mesh(grid)
    cams = [host.eye_camera(e, width, height) for e in eyes]
    views = _t(np.stack([c[0] for c in cams]), device)
    projs = _t(np.stack([c[1] for c in cams]), device)
    heights = torch.zeros((1, 1), dtype=torch.float32, device=device)
    fields = raster.vertex_fields(_t(xyuv, device), heights, views, projs, width, height,
                                  "shipped", tf32)
    tris = torch.as_tensor(tris, device=device)
    gbuf = raster.resolve(fields, tris, raster.winners(fields, tris, width, height))
    h_range = _t(SPIKE_H_MAX, device) - _t(SPIKE_H_MIN, device)
    img = raster.shade_shipped(*gbuf, _t(host.lut(colormap), device), h_range,
                               _t(SPIKE_EXPOSURE, device),
                               _t(host.normalize3(SPIKE_SUN), device))
    return img.cpu().numpy()


def renderer_frame(dem: np.ndarray, spacing, exaggeration: float, colormap: str,
                   sun, exposure: float, width: int, height: int, device,
                   tf32: bool = False) -> np.ndarray:
    """The Renderer's frame of ``dem`` (rows x cols, metres) at its default
    camera: heights times ``exaggeration``, their 1-99 percentile range,
    the sun at ``sun`` = (elevation, azimuth) degrees, extended shader."""
    rows, cols = dem.shape
    heights = dem.astype(np.float32) * np.float32(exaggeration)
    h_min, h_max = host.height_range(heights)
    xyuv, tris = host.dem_mesh(rows, cols, spacing[0], spacing[1])
    view, proj = host.dem_camera(rows, cols, spacing, width, height)
    tex = _t(heights, device)
    fields = raster.vertex_fields(_t(xyuv, device), tex, _t(view, device)[None],
                                  _t(proj, device)[None], width, height, "extended", tf32)
    del xyuv
    tris = torch.as_tensor(tris, device=device)
    gbuf = raster.resolve(fields, tris, raster.winners(fields, tris, width, height))
    del fields, tris
    img = raster.shade_extended(*gbuf, _t(host.lut(colormap), device), tex, _t(h_min, device),
                                _t(h_max, device), _t(exposure, device),
                                _t(host.sun_dir_spherical(*sun), device),
                                _t(spacing[0], device), _t(1.0, device))
    return img.cpu().numpy()
