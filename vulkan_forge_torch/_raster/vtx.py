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
     instead and walked by a whole block in a second kernel, which skips
     the triangles and the ``BIG_TILE``-pixel tiles of the bbox that it
     cannot cover (``big_tile_walk`` mirrors that test);
  2. resolve: per pixel, the winner's record is built again and evaluated
     at the pixel centre: the g-buffer (K3a) or the shipped shader's u32
     word (K3b).

This module holds the route's vertex stage (``vs_fields``), the plain
PyTorch version of each pass -- the specification the kernels are held
to, which CPU tensors take -- and the route's entries. The plain version
enumerates (triangle, bbox pixel) pairs and evaluates coverage with
``tiles.eval_records``, independently of ``tiles.py``'s tile walk. Its
corner-based bodies (``cover_from_corners`` and the two after it) serve
the indexed-mesh route too (packed.py).

Triangle ids are those of ``_mesh.build_grid_xyuv(n)``'s indices (draw
order): id = (r*(n-1) + c)*2 + k for cell (r, c), k = 0 for [A, C, B] and
k = 1 for [B, C, D]. Painter's order (max id wins) is the record route's.
"""
from __future__ import annotations

import torch

from . import fragment, kernels, transform
from .setup import clip_to_fb, grid_corners, setup_fields_core
from .tiles import eval_records

FIELDS = 7          # x_fb, y_fb, w_clip, var0, var1, var2, z_ndc
# Triangles whose pixel bbox holds more pixels than this are walked by the
# big-triangle pass. Must equal kBigPixels in csrc/vtx.cu (kernels.load()
# checks it).
BIG_PIXELS = 64
# Pairs evaluated at once by the plain version (bounds its memory).
_PAIR_CHUNK = 1 << 22
# The big-triangle kernels test their bbox in square tiles of this many
# pixels a side (kBigTile in csrc/raster_common.cuh; kernels.load() checks).
BIG_TILE = 16
# Margins of big_tile_walk's rejects (the kernels' kEdgeMargin, kDotMargin,
# kFloor and kLimit; csrc/raster_common.cuh derives them).
_EDGE_MARGIN, _DOT_MARGIN, _FLOOR, _LIMIT = 2.0 ** -20, 2.0 ** -19, 2.0 ** -100, 2.0 ** 120
# Tiles tested at once by big_tile_walk (bounds its memory).
_TILE_CHUNK = 1 << 18
# The resolve kernels' pixel layout (kResolveTileW and kResolveWarpW in
# csrc/raster_common.cuh; kernels.load() checks): a block of RESOLVE_THREADS
# threads takes one frame's RESOLVE_TILE_W x RESOLVE_TILE_H tile, a thread
# one pixel, a warp a RESOLVE_WARP_W x (32 / RESOLVE_WARP_W) patch
# (resolve_pixel_map).
RESOLVE_THREADS = 256
RESOLVE_TILE_W, RESOLVE_WARP_W = 32, 8
RESOLVE_TILE_H = RESOLVE_THREADS // RESOLVE_TILE_W
# The field planes a resolve reads: x_fb, y_fb, w_clip, var0..2. z_ndc
# feeds only coverage, which a resolve drops.
RESOLVE_PLANES = 6
SECTOR_BYTES = 32


def n_triangles(n: int) -> int:
    return 2 * (n - 1) * (n - 1)


def vs_fields(xyuv, heights, views, projs, spacing, exaggeration,
              width: int, height: int, fs_mode: str = "shipped"):
    """Post-VS fields of B frames, SoA: (B, FIELDS, N) float32.

    Rows: x_fb, y_fb, w_clip, var0, var1, var2, z_ndc (the field order of
    ``vulkan_forge/_raster/pipeline.py:467-482``, without its eighth, zero
    row, which only pads the TPU's 8-row tiles). fs_mode "shipped"
    uses ``terrain_vs`` (varyings h, x, z), "extended" uses
    ``terrain_vs_extended`` (varyings h, u, v). xyuv: (N, 4), heights:
    (Ht, Wt), views/projs: (B, 4, 4), spacing and exaggeration: one value
    each, all float32 tensors on one device.

    CPU tensors: ``vs_fields_plain``. CUDA tensors: ``kernels.vs_fields``
    (``vf_vs_fields``), bit-equal to it.
    """
    return kernels.vs_fields(xyuv, heights, views, projs, spacing, exaggeration,
                             width, height, fs_mode)


def vs_fields_plain(xyuv, heights, views, projs, spacing, exaggeration,
                    width: int, height: int, fs_mode: str = "shipped"):
    """``vs_fields`` as torch ops: ``transform.terrain_vs`` or
    ``terrain_vs_extended``, then ``setup.clip_to_fb``, stacked. The
    specification ``vf_vs_fields`` is held to."""
    vs = transform.terrain_vs if fs_mode == "shipped" else transform.terrain_vs_extended
    clip, vary = vs(xyuv, heights, views, projs, spacing, exaggeration)
    x, y, z, w = clip_to_fb(clip, width, height)
    vary = vary.expand(x.shape[0], *vary.shape[-2:])
    return torch.stack([x, y, w, vary[..., 0], vary[..., 1], vary[..., 2], z],
                       dim=1).contiguous()


def tri_vertices(n: int, tri: torch.Tensor):
    """The three grid vertex indices of triangles ``tri`` (1-D int64),
    decoded from their ids as the kernels decode them, in record order."""
    cell = torch.div(tri, 2, rounding_mode="floor")
    k = tri % 2
    r = torch.div(cell, n - 1, rounding_mode="floor")
    a = r * n + cell % (n - 1)
    return torch.where(k == 0, a, a + 1), a + n, torch.where(k == 0, a + 1, a + n + 1)


def tri_corners(fields: torch.Tensor, n: int, frame: torch.Tensor,
                tri: torch.Tensor):
    """Corners of triangles ``tri`` of frames ``frame`` (1-D int64), decoded
    from their ids as the kernels decode them: three lists of 7 tensors."""
    return [[fields[frame, f, v] for f in range(FIELDS)] for v in tri_vertices(n, tri)]


def _deposit(winner, cols, px0, px1, py0, py1, frame, ids, stats=None):
    """Max-combine ``ids + 1`` into ``winner`` (B, H, W) int32 at every
    covered pixel of each listed triangle's bbox (1-D per-triangle inputs,
    all triangles valid). ``stats``, a dict or None, receives
    ``covered_pairs``, the number of covered (triangle, pixel) pairs."""
    covered = 0
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

        cov = eval_records(col, px, py)[4]
        pix = (frame[tri] * height + y) * width + x
        flat.scatter_reduce_(0, pix[cov], (ids[tri][cov] + 1).to(torch.int32), "amax")
        if stats is not None:
            covered += int(cov.sum())
    if stats is not None:
        stats["covered_pairs"] = covered
    return winner


def cover_from_corners(c0, c1, c2, width: int, height: int, stats: dict | None = None):
    """The cover pass over every triangle's corners: three lists (one per
    corner) of 7 (B, T) field tensors, triangle id = position along T.

    Returns (winner (B, H, W) int32 = max id+1 of the triangles of at most
    BIG_PIXELS bbox pixels, big (B*T,) int32 whose first ``count`` entries
    list the other valid triangles as frame*T + id in ascending order,
    count (1,) int32). The kernels list them in any order. ``stats``, a
    dict or None, receives ``survivors``: (B,) int64, the valid triangles
    of at most BIG_PIXELS bbox pixels per frame (those the pass walks).
    """
    B, T = c0[0].shape
    cols, px0, px1, py0, py1, valid = setup_fields_core(c0, c1, c2, width, height)
    area = ((px1 - px0 + 1).to(torch.long) * (py1 - py0 + 1).to(torch.long))
    small = valid & (area <= BIG_PIXELS)
    if stats is not None:
        stats["survivors"] = small.sum(dim=1)
    small = small.reshape(-1)
    sel = torch.nonzero(small).squeeze(1)
    dev = c0[0].device
    winner = torch.zeros((B, height, width), dtype=torch.int32, device=dev)
    flat_cols = [c.reshape(-1)[sel] for c in cols]
    _deposit(winner, flat_cols, *(p.reshape(-1)[sel] for p in (px0, px1, py0, py1)),
             torch.div(sel, T, rounding_mode="floor"), sel % T)
    listed = torch.nonzero((valid & (area > BIG_PIXELS)).reshape(-1)).squeeze(1)
    big = torch.zeros(B * T, dtype=torch.int32, device=dev)
    big[:listed.numel()] = listed.to(torch.int32)
    count = torch.tensor([listed.numel()], dtype=torch.int32, device=dev)
    return winner, big, count


def listed_setup(corners_of, T: int, big: torch.Tensor, count: torch.Tensor,
                 width: int, height: int):
    """Setup of the triangles the cover pass listed, in list order:
    (cols, px0, px1, py0, py1, frame, tri). ``corners_of(frame, tri)``
    (1-D int64) gives their corners."""
    e = big[:int(count[0])].to(torch.long)
    frame = torch.div(e, T, rounding_mode="floor")
    tri = e % T
    cols, px0, px1, py0, py1, _ = setup_fields_core(*corners_of(frame, tri), width, height)
    return cols, px0, px1, py0, py1, frame, tri


def cover_big_from_corners(corners_of, T: int, winner: torch.Tensor,
                           big: torch.Tensor, count: torch.Tensor,
                           stats: dict | None = None) -> torch.Tensor:
    """The big-triangle pass: deposits the listed triangles into ``winner``
    in place (as the kernels' atomicMax does), walking every pixel of each
    bbox. ``corners_of(frame, tri)`` (1-D int64) gives their corners.
    ``stats``, a dict or None, receives ``covered_pairs``: the (triangle,
    pixel) pairs whose coverage test passed, before the max."""
    _, height, width = winner.shape
    cols, px0, px1, py0, py1, frame, tri = listed_setup(corners_of, T, big, count,
                                                        width, height)
    return _deposit(winner, cols, px0, px1, py0, py1, frame, tri, stats)


def _outside(c, px, py):
    """(N, 6) bool: functional j (edges f0..f2, aw, az, asum - az) is below
    zero, with the kernels' margin, at pixel centres (px, py) (f64). ``c``:
    the 31 record columns as f64, each (N,). The f64 ops of
    vf::outside_mask (csrc/raster_common.cuh) in their order, so the
    decisions are the kernels' bit for bit."""
    E, M = [], []
    for k in (0, 4, 8):
        a = c[k + 2] * (px - c[k])
        b = c[k + 3] * (py - c[k + 1])
        E.append(a - b)
        M.append((torch.abs(a) + torch.abs(b)) + _FLOOR)
    ok = (M[0] < _LIMIT) & (M[1] < _LIMIT) & (M[2] < _LIMIT)
    out = [(e + m * _EDGE_MARGIN < 0.0) & (m < _LIMIT) for e, m in zip(E, M)]
    D, S = {}, {}
    for k in (21, 25, 28):
        D[k] = (E[0] * c[k] + E[1] * c[k + 1]) + E[2] * c[k + 2]
        S[k] = (torch.abs(c[k]) * M[0] + torch.abs(c[k + 1]) * M[1]) + torch.abs(c[k + 2]) * M[2]
    for k in (21, 25):
        out.append(ok & (S[k] < _LIMIT) & (D[k] + (S[k] * _DOT_MARGIN + _FLOOR) < 0.0))
    out.append(ok & (S[25] < _LIMIT) & (S[28] < _LIMIT)
               & ((D[28] - D[25]) + ((S[28] + S[25]) * _DOT_MARGIN + _FLOOR) < 0.0))
    return torch.stack(out, dim=1)


def _rejected(c, x0, x1, y0, y1):
    """(N,) bool: one functional is below zero, with its margin, at all four
    corner pixel centres of the rectangles [x0, x1] x [y0, y1] (int)."""
    cx = [x.double() + 0.5 for x in (x0, x1)]
    cy = [y.double() + 0.5 for y in (y0, y1)]
    out = (_outside(c, cx[0], cy[0]) & _outside(c, cx[1], cy[0])
           & _outside(c, cx[0], cy[1]) & _outside(c, cx[1], cy[1]))
    return out.any(dim=1)


def big_tile_walk(cols, px0, px1, py0, py1):
    """The tiles the big-triangle kernels walk, for listed triangles given
    by their record columns (31 tensors (N,)) and pixel-centre bboxes (N,).

    A kernel rejects a whole triangle, and otherwise each ``BIG_TILE`` x
    ``BIG_TILE`` tile of its bbox (tile (i, j) spans x from px0 +
    BIG_TILE*i, y from py0 + BIG_TILE*j, clipped to the bbox), when one of
    the six functionals of the coverage test is below zero by more than
    its f32 error bound at all four corner pixel centres (the maximum of an
    affine function over a rectangle lies at a corner). A record with a
    non-finite column keeps every tile. Returns the kept tiles, by owner
    and then row-major: (owner (K,) int64 index into the N triangles, x0,
    x1, y0, y1 (K,) int64 inclusive pixel ranges). The same f64 ops as
    the kernels, so the counts per owner are the kernels' walk counts.
    """
    dev = px0.device
    c = [col.double() for col in cols]
    finite = torch.stack([torch.isfinite(col) for col in cols], dim=1).all(dim=1)
    bx0, bx1, by0, by1 = (p.to(torch.long) for p in (px0, px1, py0, py1))
    alive = ~finite | ~_rejected(c, bx0, bx1, by0, by1)
    ntx = torch.div(bx1 - bx0 + BIG_TILE, BIG_TILE, rounding_mode="floor")
    nty = torch.div(by1 - by0 + BIG_TILE, BIG_TILE, rounding_mode="floor")
    ntiles = torch.where(alive, ntx * nty, 0)
    ends = torch.cumsum(ntiles, 0)
    total = int(ends[-1]) if ends.numel() else 0
    kept = []
    for lo in range(0, total, _TILE_CHUNK):
        g = torch.arange(lo, min(lo + _TILE_CHUNK, total), device=dev)
        owner = torch.searchsorted(ends, g, right=True)
        k = g - (ends[owner] - ntiles[owner])
        ty = torch.div(k, ntx[owner], rounding_mode="floor")
        x0 = bx0[owner] + BIG_TILE * (k - ty * ntx[owner])
        y0 = by0[owner] + BIG_TILE * ty
        x1 = torch.minimum(x0 + BIG_TILE - 1, bx1[owner])
        y1 = torch.minimum(y0 + BIG_TILE - 1, by1[owner])
        keep = ~finite[owner] | ~_rejected([col[owner] for col in c], x0, x1, y0, y1)
        kept.append(torch.stack([owner, x0, x1, y0, y1])[:, keep])
    if not kept:
        return tuple(torch.zeros(0, dtype=torch.long, device=dev) for _ in range(5))
    return tuple(torch.cat(kept, dim=1))


def walk_counts_from_corners(corners_of, T: int, big: torch.Tensor, count: torch.Tensor,
                             width: int, height: int) -> torch.Tensor:
    """(count,) int32: the tiles the big-triangle kernels walk for each list
    entry (``big_tile_walk``), in list order."""
    cols, px0, px1, py0, py1, _, _ = listed_setup(corners_of, T, big, count, width, height)
    owner = big_tile_walk(cols, px0, px1, py0, py1)[0]
    return torch.bincount(owner, minlength=px0.numel()).to(torch.int32)


def resolve_from_corners(corners_of, winner: torch.Tensor):
    """The g-buffer resolve: (v0, v1, v2, mask), each (B, H, W), with
    ``tiles.py``'s accumulator rule (uncovered: 0). ``corners_of(frame,
    tri)`` gives the winners' corners."""
    B, height, width = winner.shape
    w = winner.reshape(B, -1).to(torch.long)
    mask = w > 0
    frame = torch.arange(B, device=w.device)[:, None].expand_as(w)
    cols = setup_fields_core(*corners_of(frame.reshape(-1),
                                         torch.clamp_min(w - 1, 0).reshape(-1)),
                             width, height)[0]
    cols = [c.reshape(B, -1) for c in cols]
    lp = torch.arange(height * width, device=w.device)
    px = (lp % width).to(torch.float32) + 0.5
    py = torch.div(lp, width, rounding_mode="floor").to(torch.float32) + 0.5
    a0, a1, a2, aw, _ = eval_records(cols.__getitem__, px, py)
    acc = [torch.where(mask, a, 0.0) for a in (a0, a1, a2)]
    accw = torch.where(mask, aw, 1.0)
    rcp = 1.0 / torch.where(torch.abs(accw) < 1e-20, 1.0, accw)
    planes = [a * rcp for a in acc] + [mask]
    return tuple(p.reshape(B, height, width) for p in planes)


def resolve_pixel_map(frames: int, width: int, height: int) -> torch.Tensor:
    """The pixel each thread of a resolve launch takes: (blocks, threads)
    int64, ``frame*H*W + y*W + x``, or -1 where the kernel masks the thread
    (past the ragged right or bottom edge). The mirror of
    ``vf::resolve_tile``'s mapping: block = frame * tiles + tile (tiles in
    row-major order), warp t // 32 at patch (warp % across, warp // across)
    of the tile, lane t % 32 at (lane % RESOLVE_WARP_W, lane //
    RESOLVE_WARP_W) in its patch."""
    tiles_x = -(-width // RESOLVE_TILE_W)
    tiles = tiles_x * -(-height // RESOLVE_TILE_H)
    blk = torch.arange(frames * tiles)[:, None]
    t = torch.arange(RESOLVE_THREADS)[None, :]
    frame, tile = torch.div(blk, tiles, rounding_mode="floor"), blk % tiles
    ty, tx = torch.div(tile, tiles_x, rounding_mode="floor"), tile % tiles_x
    warp, lane = torch.div(t, 32, rounding_mode="floor"), t % 32
    across = RESOLVE_TILE_W // RESOLVE_WARP_W
    x = tx * RESOLVE_TILE_W + (warp % across) * RESOLVE_WARP_W + lane % RESOLVE_WARP_W
    y = (ty * RESOLVE_TILE_H + torch.div(warp, across, rounding_mode="floor")
         * (32 // RESOLVE_WARP_W) + torch.div(lane, RESOLVE_WARP_W, rounding_mode="floor"))
    return torch.where((x < width) & (y < height), (frame * height + y) * width + x, -1)


def winners(winner: torch.Tensor):
    """(frame, triangle id) of every covered pixel of ``winner`` (B, H, W),
    1-D int64 each."""
    frame = torch.arange(winner.shape[0], device=winner.device)[:, None, None]
    covered = winner > 0
    return frame.expand_as(winner)[covered], winner[covered].to(torch.long) - 1


def field_sectors(frame: torch.Tensor, verts, nv: int) -> int:
    """Distinct 32-byte sectors of a (B, FIELDS, nv) f32 fields tensor (its
    start 32-byte aligned, as torch's allocator places it) that reading
    planes 0..RESOLVE_PLANES-1 of vertices ``verts`` (a sequence of 1-D
    int64 tensors) of frames ``frame`` touches."""
    v = torch.unique(torch.cat([frame * nv + u for u in verts]))
    f, u = torch.div(v, nv, rounding_mode="floor"), v % nv
    planes = torch.arange(RESOLVE_PLANES, device=v.device)
    offset = ((f[:, None] * FIELDS + planes) * nv + u[:, None]) * 4
    return int(torch.unique(torch.div(offset, SECTOR_BYTES, rounding_mode="floor")).numel())


def resolve_sectors(fields: torch.Tensor, n: int, winner: torch.Tensor) -> int:
    """Distinct 32-byte sectors of ``fields`` the vtx resolves must read:
    RESOLVE_PLANES planes of the corners of every covered pixel's winner
    (the least this SoA layout moves, each sector once)."""
    frame, tri = winners(winner)
    return field_sectors(frame, tri_vertices(n, tri), fields.shape[2])


def cover_plain(fields: torch.Tensor, n: int, width: int, height: int,
                stats: dict | None = None):
    """Plain version of ``vf_vtx_cover`` (``cover_from_corners`` over the
    grid's triangles; ``stats`` as there)."""
    return cover_from_corners(*grid_corners([fields[:, f] for f in range(FIELDS)], n),
                              width, height, stats)


def cover_big_plain(fields: torch.Tensor, n: int, winner: torch.Tensor,
                    big: torch.Tensor, count: torch.Tensor,
                    stats: dict | None = None) -> torch.Tensor:
    """Plain version of ``vf_vtx_cover_big``: deposits the listed
    triangles into ``winner`` in place, walking their whole bboxes
    (``stats`` as in ``cover_big_from_corners``)."""
    return cover_big_from_corners(lambda frame, tri: tri_corners(fields, n, frame, tri),
                                  n_triangles(n), winner, big, count, stats)


def big_walk_counts(fields: torch.Tensor, n: int, big: torch.Tensor, count: torch.Tensor,
                    width: int, height: int) -> torch.Tensor:
    """The tiles ``vf_vtx_cover_big`` walks for each list entry, from the
    torch mirror of its rejects (``walk_counts_from_corners``)."""
    return walk_counts_from_corners(lambda frame, tri: tri_corners(fields, n, frame, tri),
                                    n_triangles(n), big, count, width, height)


def resolve_gbuffer_plain(fields: torch.Tensor, n: int, winner: torch.Tensor):
    """Plain version of ``vf_vtx_resolve_gbuffer``: (v0, v1, v2, mask),
    each (B, H, W)."""
    return resolve_from_corners(lambda frame, tri: tri_corners(fields, n, frame, tri),
                                winner)


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
