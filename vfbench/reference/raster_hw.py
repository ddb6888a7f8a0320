"""The plain reference under the hardware fill rule (``VF_FILL_RULE=hw``):
the Vulkan rule of fixed-point rasterization ("Basic Polygon
Rasterization"), as the hardware rasterizer under the wgpu renderer
covers pixels.

Two things set it apart from the inclusive rule of ``raster``:

- each vertex's framebuffer x and y are snapped once to the 8.8 sub-pixel
  grid (``round(v * 256) / 256``, half to even), for coverage and resolve
  alike;
- each edge of a triangle gets a threshold: 0 for a top-left edge (a
  horizontal edge that runs rightward, any other that runs upward, in the
  snapped y-down framebuffer) and for every edge of a triangle that
  crosses w = 0, 2^-16 (one step of the snapped edge function) for the
  rest. A pixel centre is covered where each edge function is at least
  its threshold, and every other test of ``raster.evaluate`` holds.

On the snapped lattice the edge functions are exact multiples of 2^-16,
so a pixel centre on an edge shared by two triangles is covered by one
of them. Everything else is ``raster``'s, called as it is: the vertex
stage, the setup, the evaluation, the resolve and the extended shader;
coverage is worked out over every triangle at once, in chunks, with no
binning, as ``raster.winners`` does. ``tf32=True`` is the control, as in
``raster``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import host, raster

SNAP = 256.0             # 8.8 fixed point: 8 sub-pixel bits
STEP = 2.0 ** -16        # one step of a snapped edge function
_W_EPS = 1e-8


def _t(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def snapped(fields: torch.Tensor) -> torch.Tensor:
    """(B, 7, N) post-VS fields with x_fb and y_fb on the 8.8 grid."""
    out = fields.clone()
    out[:, :2] = torch.round(fields[:, :2] * SNAP) * (1.0 / SNAP)
    return out


def thresholds(c0, c1, c2):
    """The three edges' coverage thresholds (edge opposite corner 0, 1, 2)
    of triangles given by their corners' 7 field tensors, snapped."""
    x0, y0, x1, y1, x2, y2 = c0[0], c0[1], c1[0], c1[1], c2[0], c2[1]
    clean = (c0[2] > _W_EPS) & (c1[2] > _W_EPS) & (c2[2] > _W_EPS)

    def edge(ax, ay, bx, by):
        horiz = ay == by
        topleft = (horiz & (bx > ax)) | (~horiz & (by < ay))
        return torch.where(topleft | ~clean, 0.0, STEP)

    return edge(x1, y1, x2, y2), edge(x2, y2, x0, y0), edge(x0, y0, x1, y1)


def covered(col, thr, px, py):
    """``raster.evaluate``'s coverage of record columns ``col(k)`` at
    pixel centres, each edge function at least its threshold ``thr``."""
    f0 = raster.mad(col(2), px - col(0), -(col(3) * (py - col(1))))
    f1 = raster.mad(col(6), px - col(4), -(col(7) * (py - col(5))))
    f2 = raster.mad(col(10), px - col(8), -(col(11) * (py - col(9))))
    return (raster.evaluate(col, px, py)[4]
            & (f0 >= thr[0]) & (f1 >= thr[1]) & (f2 >= thr[2]))


def winners(fields, tris, width: int, height: int) -> torch.Tensor:
    """(B, H, W) int64: 1 + the largest id of a triangle covering each
    pixel centre under the hardware rule, 0 where none does. ``fields``
    snapped (``snapped``)."""
    B = fields.shape[0]
    T = tris.shape[0]
    dev = fields.device
    flat = torch.zeros(B * height * width, dtype=torch.int64, device=dev)
    step = max(1, raster._TRI_CHUNK // B)
    for lo in range(0, T, step):
        ids = torch.arange(lo, min(lo + step, T), device=dev)
        frame = torch.arange(B, device=dev).repeat_interleave(ids.numel())
        tri = ids.repeat(B)
        corners = raster._corners(fields, tris, frame, tri)
        cols, px0, px1, py0, py1, valid = raster.setup(*corners, width, height)
        sel = torch.nonzero(valid).squeeze(1)
        _deposit(flat, [c[sel] for c in cols], [t[sel] for t in thresholds(*corners)],
                 px0[sel], px1[sel], py0[sel], py1[sel], frame[sel], tri[sel], width,
                 height)
    return flat.view(B, height, width)


def _deposit(flat, cols, thr, px0, px1, py0, py1, frame, ids, width, height):
    """Max-combine ``ids + 1`` into ``flat`` at every pixel of each
    triangle's bbox it covers, (triangle, pixel) pairs in chunks."""
    bw = (px1 - px0 + 1).to(torch.long)
    npix = bw * (py1 - py0 + 1).to(torch.long)
    ends = torch.cumsum(npix, 0)
    total = int(ends[-1]) if ends.numel() else 0
    marks = torch.arange(1, total // raster._PAIR_CHUNK + 1, device=ends.device) \
        * raster._PAIR_CHUNK
    bounds = [0] + torch.searchsorted(ends, marks, right=True).tolist() + [npix.numel()]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        cnt = npix[lo:hi]
        tri = lo + torch.repeat_interleave(torch.arange(hi - lo, device=cnt.device), cnt)
        k = torch.arange(tri.numel(), device=cnt.device) - (torch.cumsum(cnt, 0) - cnt)[tri - lo]
        x = px0[tri].to(torch.long) + k % bw[tri]
        y = py0[tri].to(torch.long) + torch.div(k, bw[tri], rounding_mode="floor")
        cov = covered(lambda j: cols[j][tri], [t[tri] for t in thr],
                      x.to(torch.float32) + 0.5, y.to(torch.float32) + 0.5)
        pix = (frame[tri] * height + y) * width + x
        flat.scatter_reduce_(0, pix[cov], ids[tri][cov] + 1, "amax")


def renderer_frame_hw(dem: np.ndarray, spacing, exaggeration: float, colormap: str,
                      sun, exposure: float, width: int, height: int, device,
                      tf32: bool = False) -> np.ndarray:
    """``scenes.renderer_frame`` under the hardware fill rule: the
    Renderer's frame of ``dem`` at its default camera, the vertices snapped
    and the edges' thresholds applied."""
    rows, cols = dem.shape
    heights = dem.astype(np.float32) * np.float32(exaggeration)
    h_min, h_max = host.height_range(heights)
    xyuv, tris = host.dem_mesh(rows, cols, spacing[0], spacing[1])
    view, proj = host.dem_camera(rows, cols, spacing, width, height)
    tex = _t(heights, device)
    fields = snapped(raster.vertex_fields(_t(xyuv, device), tex, _t(view, device)[None],
                                          _t(proj, device)[None], width, height,
                                          "extended", tf32))
    del xyuv
    tris = torch.as_tensor(tris, device=device)
    gbuf = raster.resolve(fields, tris, winners(fields, tris, width, height))
    del fields, tris
    img = raster.shade_extended(*gbuf, _t(host.lut(colormap), device), tex, _t(h_min, device),
                                _t(h_max, device), _t(exposure, device),
                                _t(host.sun_dir_spherical(*sun), device),
                                _t(spacing[0], device), _t(1.0, device))
    return img.cpu().numpy()
