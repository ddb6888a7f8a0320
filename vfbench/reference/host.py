"""The host-side half of the plain reference: camera matrices, the sun
vector, the colormap LUT, the grid meshes and the DEM's height range, in
numpy float32, worked out again from the benchmark's inputs.

Frozen copies of the port's host passes (``vulkan_forge_torch/_camera.py``,
``_uniforms.py``, ``_colormap.py``, ``_mesh.py``, ``_dem.py``,
``_renderer.py``), with the same f32 ops in the same order, so that a
sound program gives these bits. Nothing here imports the program.
"""
from __future__ import annotations

import math

import numpy as np

from .palettes import palette_srgb_rgba8

_f32 = np.float32


# ---- camera (the port's _camera.py: glam's look_at_rh, perspective_rh_gl) ----

def _normalize_or_zero(v: np.ndarray) -> np.ndarray:
    n = np.sqrt(np.sum(v.astype(np.float32) * v, dtype=np.float32))
    if n <= 0.0 or not np.isfinite(n):
        return np.zeros(3, dtype=np.float32)
    return (v / n).astype(np.float32)


def look_at_rh(eye, target, up) -> np.ndarray:
    """Row-major (4, 4) f32 view matrix, right-handed, Y up."""
    e, t, u = (np.asarray(a, dtype=np.float32).reshape(3) for a in (eye, target, up))
    f = _normalize_or_zero(t - e)
    s = _normalize_or_zero(np.cross(f, u).astype(np.float32))
    uu = np.cross(s, f).astype(np.float32)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = uu
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, e)
    m[1, 3] = -np.dot(uu, e)
    m[2, 3] = np.dot(f, e)
    m[3, 3] = 1.0
    return np.ascontiguousarray(m, dtype=np.float32)


def perspective_wgpu(fovy_rad, aspect, znear, zfar) -> np.ndarray:
    """glam's perspective_rh_gl with the GL -> WGPU depth remap in front."""
    fovy_rad, aspect, znear, zfar = _f32(fovy_rad), _f32(aspect), _f32(znear), _f32(zfar)
    inv_length = _f32(1.0) / (znear - zfar)
    f = _f32(1.0) / _f32(math.tan(float(_f32(0.5) * fovy_rad)))
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (znear + zfar) * inv_length
    m[2, 3] = (_f32(2.0) * znear * zfar) * inv_length
    m[3, 2] = _f32(-1.0)
    remap = np.eye(4, dtype=np.float32)
    remap[2, 2] = 0.5
    remap[2, 3] = 0.5
    return (remap @ m).astype(np.float32)


def orbit_cameras(n: int, phase: float, width: int, height: int):
    """The views and projections of ``n`` cameras on ``bench.py``'s orbit
    (``bench.py:55-67``): eyes at radius 3 around the spike, height
    2 + 0.1 sin(phase), looking at the origin, fovy 45, near 0.1, far 100.
    Returns (views, projs), each (n, 4, 4) f32."""
    views, projs = [], []
    aspect = np.float32(width) / np.float32(height)
    for i in range(n):
        ang = 2.0 * math.pi * i / max(n, 1) + phase
        eye = (3.0 * math.cos(ang), 2.0 + 0.1 * math.sin(phase), 3.0 * math.sin(ang))
        views.append(look_at_rh(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)))
        projs.append(perspective_wgpu(np.float32(math.radians(45.0)), aspect,
                                      np.float32(0.1), np.float32(100.0)))
    return np.stack(views), np.stack(projs)


def eye_camera(eye, width: int, height: int, fovy_deg=45.0, znear=0.1, zfar=100.0):
    """(view, proj) of a camera at ``eye`` looking at the origin, Y up."""
    aspect = np.float32(width) / np.float32(height)
    return (look_at_rh(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
            perspective_wgpu(np.float32(math.radians(float(fovy_deg))), aspect,
                             np.float32(znear), np.float32(zfar)))


def dem_camera(rows: int, cols: int, spacing, width: int, height: int):
    """The Renderer's default framing camera for a rows x cols DEM: the
    centred grid seen from the -X side at 45 degrees, panned half a pixel
    so that its centre projects to the centre of pixel (W//2, H//2)."""
    extent = max((cols - 1) * spacing[0], (rows - 1) * spacing[1], 1e-3)
    view = look_at_rh((-0.9 * extent, 0.9 * extent, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    aspect = np.float32(width) / np.float32(height)
    dist = math.sqrt(2.0) * 0.9 * extent
    proj = perspective_wgpu(np.float32(math.radians(45.0)), aspect,
                            np.float32(max(dist * 1e-3, 1e-3)), np.float32(dist * 10.0 + 10.0))
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = 1.0 / np.float32(width)
    shift[1, 3] = -1.0 / np.float32(height)
    return view, (shift @ proj).astype(np.float32)


# ---- lighting and colour ----

def normalize3(v) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    n = np.float32(np.sqrt(np.sum(v * v, dtype=np.float32)))
    if n <= 0.0 or not np.isfinite(n):
        return np.zeros(3, dtype=np.float32)
    return (v / n).astype(np.float32)


def sun_dir_spherical(elevation_deg: float, azimuth_deg: float) -> np.ndarray:
    """Unit sun vector: Y up, azimuth 0 along +X, counter-clockwise to +Z."""
    el = np.float32(float(elevation_deg) * math.pi / 180.0)
    az = np.float32(float(azimuth_deg) * math.pi / 180.0)
    se, ce = np.float32(np.sin(el)), np.float32(np.cos(el))
    sa, ca = np.float32(np.sin(az)), np.float32(np.cos(az))
    return normalize3(np.array([ce * ca, se, ce * sa], dtype=np.float32))


def lut(name: str) -> np.ndarray:
    """The (256, 4) f32 linear LUT of a palette: its sRGB bytes decoded in
    full precision (the sRGB-texture path; alpha is byte / 255)."""
    srgb = palette_srgb_rgba8(name)
    c = srgb[:, :3].astype(np.float32) / np.float32(255.0)
    lo = c / np.float32(12.92)
    hi = ((c + np.float32(0.055)) / np.float32(1.055)) ** np.float32(2.4)
    table = np.empty((256, 4), dtype=np.float32)
    table[:, :3] = np.where(c <= np.float32(0.04045), lo, hi).astype(np.float32)
    table[:, 3] = srgb[:, 3].astype(np.float32) / np.float32(255.0)
    return table


# ---- meshes ----

def spike_mesh(n: int):
    """The analytic spike's grid over [-1.5, 1.5]^2: (xyuv (n*n, 4) f32 as
    [x, z, u, v], triangles (T, 3) int64, two per cell [a, c, b], [b, c, d]
    with b = a + 1, c = a + n, d = a + n + 1)."""
    scale = np.float32(1.5)
    step = (np.float32(2.0) * scale) / np.float32(n - 1)
    xs = -scale + np.arange(n, dtype=np.float32) * step
    us = np.arange(n, dtype=np.float32) / np.float32(n - 1)
    xyuv = np.empty((n, n, 4), dtype=np.float32)
    xyuv[..., 0] = xs[None, :]
    xyuv[..., 1] = xs[:, None]
    xyuv[..., 2] = us[None, :]
    xyuv[..., 3] = us[:, None]
    a = np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None, :]
    tris = np.stack([a, a + n, a + 1, a + 1, a + n, a + n + 1], axis=-1)
    return xyuv.reshape(-1, 4), tris.reshape(-1, 3)


def dem_mesh(rows: int, cols: int, dx: float, dy: float):
    """The DEM's grid, centred at the origin: (xyuv (rows*cols, 4) f32 as
    [x, y, u, v], triangles (T, 3) int64): the reference grid generator's
    cells [i0, i1, i2, i2, i1, i3] with the Renderer's [0, 2, 1] flip."""
    dx, dy = np.float32(dx), np.float32(dy)
    cx = np.float32(np.float32(cols) - np.float32(1.0)) * np.float32(0.5) * dx
    cy = np.float32(np.float32(rows) - np.float32(1.0)) * np.float32(0.5) * dy
    xs = np.arange(cols, dtype=np.float32) * dx - cx
    ys = np.arange(rows, dtype=np.float32) * dy - cy
    us = np.arange(cols, dtype=np.float32) / np.float32(cols - 1)
    vs = np.arange(rows, dtype=np.float32) / np.float32(rows - 1)
    xyuv = np.empty((rows, cols, 4), dtype=np.float32)
    xyuv[..., 0] = xs[None, :]
    xyuv[..., 1] = ys[:, None]
    xyuv[..., 2] = us[None, :]
    xyuv[..., 3] = vs[:, None]
    i0 = np.arange(rows - 1)[:, None] * cols + np.arange(cols - 1)[None, :]
    i1, i2, i3 = i0 + 1, i0 + cols, i0 + cols + 1
    tris = np.stack([i0, i2, i1, i2, i3, i1], axis=-1)
    return xyuv.reshape(-1, 4), tris.reshape(-1, 3)


# ---- the DEM's height range ----

def height_range(heights: np.ndarray):
    """(h_min, h_max) the Renderer stores at ``add_terrain``: the 1st and
    99th percentiles of the (exaggerated) heights, by truncated index over a
    sorted stride sample (step len // 65536 above 65,536 samples), with
    h_max at least h_min + 1e-5."""
    d = np.asarray(heights, dtype=np.float32).reshape(-1)
    sample = 65_536
    buf = d[::d.size // sample].copy() if d.size > sample else d.copy()
    buf.sort()
    p1 = float(buf[int(buf.size * np.float32(0.01))])
    p99 = float(buf[int(buf.size * np.float32(0.99))])
    return p1, max(p99, p1 + 1e-5)
