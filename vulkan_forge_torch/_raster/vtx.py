"""Vertex-stream route for dense grid meshes.

Port of ``vulkan_forge/_raster/vtx.py``: the K3a/K3b kernels
(``_vtx_kernel``, vtx.py:590, and ``_vtx_kernel_fused``, vtx.py:616) read
only the post-vertex-shader fields of the grid's vertices and build every
triangle's record from its four grid corners with ``setup_fields_core``,
so no (T, 40) records reach device memory. The port's kernels
(``csrc/vtx.cu``) keep that and drop the TPU layout (lane-packed stream,
MXU deposit, slot cap and overflow): two passes per batch,

  1. cover: per triangle, setup and a walk of its pixel-centre bbox; every
     covered pixel keeps the maximum ``id + 1`` (0 = uncovered). A
     triangle whose bbox holds more than ``BIG_PIXELS`` pixels is listed
     instead and walked by a whole block in a second kernel;
  2. resolve: per pixel, the winner's record is built again and evaluated
     at the pixel centre: the g-buffer (K3a) or the shipped shader's u32
     word (K3b).

This module holds the route's vertex stage (``vs_fields``), the plain
PyTorch version of each pass -- the specification the kernels are held
to, which CPU tensors take -- and the route's entries. The plain version
enumerates (triangle, bbox pixel) pairs and evaluates coverage with the
formulas of ``tiles.py:79-90``, independently of ``tiles.py``'s tile walk.

Triangle ids are those of ``_mesh.build_grid_xyuv(n)``'s indices (draw
order): id = (r*(n-1) + c)*2 + k for cell (r, c), k = 0 for [A, C, B] and
k = 1 for [B, C, D]. Painter's order (max id wins) is the record route's.
"""
from __future__ import annotations

import torch

from . import fragment, kernels, transform
from .setup import clip_to_fb, grid_corners, setup_fields_core

FIELDS = 7          # x_fb, y_fb, w_clip, var0, var1, var2, z_ndc
# Triangles whose pixel bbox holds more pixels than this are walked by the
# big-triangle pass. Must equal kBigPixels in csrc/vtx.cu (kernels.load()
# checks it).
BIG_PIXELS = 64
# Pairs evaluated at once by the plain version (bounds its memory).
_PAIR_CHUNK = 1 << 22


def n_triangles(n: int) -> int:
    return 2 * (n - 1) * (n - 1)


def vs_fields(xyuv, heights, views, projs, spacing, exaggeration,
              width: int, height: int, fs_mode: str = "shipped"):
    """Post-VS fields of B frames, SoA: (B, FIELDS, N) float32.

    Rows: x_fb, y_fb, w_clip, var0, var1, var2, z_ndc (the field order of
    ``vulkan_forge/_raster/pipeline.py:467-482``, without its eighth, zero
    row, which only pads the TPU's 8-row tiles). fs_mode "shipped"
    uses ``terrain_vs`` (varyings h, x, z), "extended" uses
    ``terrain_vs_extended`` (varyings h, u, v). views/projs: (B, 4, 4).
    """
    vs = transform.terrain_vs if fs_mode == "shipped" else transform.terrain_vs_extended
    clip, vary = vs(xyuv, heights, views, projs, spacing, exaggeration)
    x, y, z, w = clip_to_fb(clip, width, height)
    vary = vary.expand(x.shape[0], *vary.shape[-2:])
    return torch.stack([x, y, w, vary[..., 0], vary[..., 1], vary[..., 2], z],
                       dim=1).contiguous()


def tri_corners(fields: torch.Tensor, n: int, frame: torch.Tensor,
                tri: torch.Tensor):
    """Corners of triangles ``tri`` of frames ``frame`` (1-D int64), decoded
    from their ids as the kernels decode them: three lists of 7 tensors."""
    cell = torch.div(tri, 2, rounding_mode="floor")
    k = tri % 2
    r = torch.div(cell, n - 1, rounding_mode="floor")
    a = r * n + cell % (n - 1)
    verts = (torch.where(k == 0, a, a + 1), a + n, torch.where(k == 0, a + 1, a + n + 1))
    return [[fields[frame, f, v] for f in range(FIELDS)] for v in verts]


def _edges(col, px, py):
    """The three edge functions of records ``col(j)`` at pixel centres
    (tiles.py:79-81)."""
    return (col(2) * (px - col(0)) - col(3) * (py - col(1)),
            col(6) * (px - col(4)) - col(7) * (py - col(5)),
            col(10) * (px - col(8)) - col(11) * (py - col(9)))


def _deposit(winner, cols, px0, px1, py0, py1, frame, ids):
    """Max-combine ``ids + 1`` into ``winner`` (B, H, W) int32 at every
    covered pixel of each listed triangle's bbox (1-D per-triangle inputs,
    all triangles valid)."""
    _, height, width = winner.shape
    flat = winner.view(-1)
    bw = (px1 - px0 + 1).to(torch.long)
    npix = bw * (py1 - py0 + 1).to(torch.long)
    ends = torch.cumsum(npix, 0)
    total = int(ends[-1]) if ends.numel() else 0
    marks = torch.arange(1, total // _PAIR_CHUNK + 1, device=ends.device) * _PAIR_CHUNK
    cuts = torch.searchsorted(ends, marks, right=True)
    bounds = [0] + cuts.tolist() + [npix.numel()]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        cnt = npix[lo:hi]
        tri = lo + torch.repeat_interleave(torch.arange(hi - lo, device=cnt.device), cnt)
        k = torch.arange(tri.numel(), device=cnt.device) - (torch.cumsum(cnt, 0) - cnt)[tri - lo]
        x = px0[tri].to(torch.long) + k % bw[tri]
        y = py0[tri].to(torch.long) + torch.div(k, bw[tri], rounding_mode="floor")
        px = x.to(torch.float32) + 0.5
        py = y.to(torch.float32) + 0.5

        def col(j):
            return cols[j][tri]

        f0, f1, f2 = _edges(col, px, py)
        aw = f0 * col(21) + f1 * col(22) + f2 * col(23)
        az = f0 * col(25) + f1 * col(26) + f2 * col(27)
        asum = f0 * col(28) + f1 * col(29) + f2 * col(30)
        cov = ((f0 >= 0.0) & (f1 >= 0.0) & (f2 >= 0.0) & (col(24) > 0.0)
               & (az >= 0.0) & (aw > 0.0) & (asum - az >= 0.0))
        pix = (frame[tri] * height + y) * width + x
        flat.scatter_reduce_(0, pix[cov], (ids[tri][cov] + 1).to(torch.int32), "amax")
    return winner


def cover_plain(fields: torch.Tensor, n: int, width: int, height: int):
    """Plain version of ``vf_vtx_cover``.

    Returns (winner (B, H, W) int32 over the triangles of at most
    BIG_PIXELS bbox pixels, big (B*T,) int32 whose first ``count`` entries
    list the other valid triangles as frame*T + id in ascending order,
    count (1,) int32). The kernel lists them in any order.
    """
    B = fields.shape[0]
    T = n_triangles(n)
    c0, c1, c2 = grid_corners([fields[:, f] for f in range(FIELDS)], n)
    cols, px0, px1, py0, py1, valid = setup_fields_core(c0, c1, c2, width, height)
    area = ((px1 - px0 + 1).to(torch.long) * (py1 - py0 + 1).to(torch.long))
    small = (valid & (area <= BIG_PIXELS)).reshape(-1)
    sel = torch.nonzero(small).squeeze(1)
    winner = torch.zeros((B, height, width), dtype=torch.int32, device=fields.device)
    flat_cols = [c.reshape(-1)[sel] for c in cols]
    _deposit(winner, flat_cols, *(p.reshape(-1)[sel] for p in (px0, px1, py0, py1)),
             torch.div(sel, T, rounding_mode="floor"), sel % T)
    listed = torch.nonzero((valid & (area > BIG_PIXELS)).reshape(-1)).squeeze(1)
    big = torch.zeros(B * T, dtype=torch.int32, device=fields.device)
    big[:listed.numel()] = listed.to(torch.int32)
    count = torch.tensor([listed.numel()], dtype=torch.int32, device=fields.device)
    return winner, big, count


def cover_big_plain(fields: torch.Tensor, n: int, winner: torch.Tensor,
                    big: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Plain version of ``vf_vtx_cover_big``: deposits the listed
    triangles into ``winner`` in place (as the kernel's atomicMax does)."""
    _, height, width = winner.shape
    T = n_triangles(n)
    e = big[:int(count[0])].to(torch.long)
    frame = torch.div(e, T, rounding_mode="floor")
    tri = e % T
    cols, px0, px1, py0, py1, _ = setup_fields_core(
        *tri_corners(fields, n, frame, tri), width, height)
    return _deposit(winner, cols, px0, px1, py0, py1, frame, tri)


def resolve_gbuffer_plain(fields: torch.Tensor, n: int, winner: torch.Tensor):
    """Plain version of ``vf_vtx_resolve_gbuffer``: (v0, v1, v2, mask),
    each (B, H, W), with ``tiles.py``'s accumulator rule (uncovered: 0)."""
    B, height, width = winner.shape
    w = winner.reshape(B, -1).to(torch.long)
    mask = w > 0
    frame = torch.arange(B, device=w.device)[:, None].expand_as(w)
    cols = setup_fields_core(*tri_corners(fields, n, frame.reshape(-1),
                                          torch.clamp_min(w - 1, 0).reshape(-1)),
                             width, height)[0]
    cols = [c.reshape(B, -1) for c in cols]
    lp = torch.arange(height * width, device=w.device)
    px = (lp % width).to(torch.float32) + 0.5
    py = torch.div(lp, width, rounding_mode="floor").to(torch.float32) + 0.5
    f0, f1, f2 = _edges(cols.__getitem__, px, py)
    acc = [torch.where(mask, f0 * cols[3 * j + 12] + f1 * cols[3 * j + 13]
                       + f2 * cols[3 * j + 14], 0.0) for j in range(3)]
    accw = torch.where(mask, f0 * cols[21] + f1 * cols[22] + f2 * cols[23], 1.0)
    rcp = 1.0 / torch.where(torch.abs(accw) < 1e-20, 1.0, accw)
    planes = [a * rcp for a in acc] + [mask]
    return tuple(p.reshape(B, height, width) for p in planes)


def resolve_shade_shipped_plain(fields, n, winner, lut, h_range, exposure, sun_dir):
    """Plain version of ``vf_vtx_resolve_shade_shipped``: the g-buffer
    resolve followed by ``fragment.terrain_fs``."""
    return fragment.terrain_fs(*resolve_gbuffer_plain(fields, n, winner), lut,
                               h_range, exposure, sun_dir)


def render_gbuffer_vtx_batch(fields: torch.Tensor, grid_n: int, width: int, height: int):
    """B frames through the vertex-stream kernels (K3a's counterpart).

    fields: (B, FIELDS, n*n) float32 from ``vs_fields``. Returns (v0, v1,
    v2, mask), each (B, H, W): cover, big-triangle cover, resolve. The port
    has no slot cap, so there is no ``needed``.
    """
    winner = kernels.vtx_cover_big(fields, grid_n,
                                   *kernels.vtx_cover(fields, grid_n, width, height))
    return kernels.vtx_resolve_gbuffer(fields, grid_n, winner)


def render_image_vtx_batch(fields: torch.Tensor, lut, h_range, exposure, sun_dir,
                           grid_n: int, width: int, height: int):
    """B frames through the vertex-stream kernels with the shipped shader
    in the resolve (K3b's counterpart): cover, big-triangle cover, shading
    resolve. Returns (B, H, W) uint32 RGBA."""
    winner = kernels.vtx_cover_big(fields, grid_n,
                                   *kernels.vtx_cover(fields, grid_n, width, height))
    return kernels.vtx_resolve_shade_shipped(fields, grid_n, winner, lut, h_range,
                                             exposure, sun_dir)
