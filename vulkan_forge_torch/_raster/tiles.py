"""Plain PyTorch tile raster: the specification of both raster kernels.

Port of ``vulkan_forge/_raster/tiles.py:22-101``. It is vectorized over
tiles and loops over list positions: at step p every tile with more than p
binned triangles evaluates its p-th record (ascending id) at all of its
pixels and overwrites the pixels it covers, so the last cover -- the
maximum id -- wins (painter's order; the reference has no depth buffer,
src/terrain/pipeline.rs:133).

``kernels.raster_gbuffer`` and ``kernels.raster_shade_shipped`` run this on
a CPU tensor; on a CUDA tensor they launch ``csrc/raster.cu``, which does
the same f32 ops in the same order per pixel.

The kernels do not walk in this order: they test each binned pair only
at the pixels of its box (``Binning.boxes``, its bbox clipped to the
tile); a heavy tile covers first, keeping the largest covering row per
pixel, and evaluates only that winner. ``render_gbuffer_walk`` mirrors
that order in torch and ``tile_work`` counts its (pair, pixel) items; the
tests hold both to this version.

``eval_records`` -- one record at pixel centres -- is the evaluation every
route shares (vtx.py and packed.py use it too; ``vf::eval_pixel`` in
``csrc/raster_common.cuh`` is its CUDA twin). It rounds its multiply-adds
as XLA:CPU contracts the JAX package's (``mad``), so the port's g-buffer
equals the JAX jnp oracle's bit for bit, not only within a tolerance.
"""
from __future__ import annotations

import torch

from .setup import BIAS0_COL, BIAS1_COL, BIAS2_COL, TILE, Binning, tile_grid


def mad(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` (f32) rounded once: the fused multiply-add XLA:CPU
    contracts it into, and CUDA's ``__fmaf_rn``. The f32 product is exact
    in f64; the f64 sum is rounded to odd (one ulp towards the exact value
    when TwoSum finds an error and the nearest sum is even), and a sum
    rounded to odd with 29 spare bits rounds to f32 as the exact value
    does, ties included."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    s = torch.where(inexact_even, torch.nextafter(s, s + torch.sign(err) * float("inf")), s)
    return s.float()


def _edges(col, px, py):
    f0 = mad(col(2), px - col(0), -(col(3) * (py - col(1))))
    f1 = mad(col(6), px - col(4), -(col(7) * (py - col(5))))
    f2 = mad(col(10), px - col(8), -(col(11) * (py - col(9))))
    return f0, f1, f2


def _dot(f, col, k):
    return mad(f[2], col(k + 2), mad(f[0], col(k), f[1] * col(k + 1)))


def _covers(col, f, aw, bias):
    az = _dot(f, col, 25)
    asum = _dot(f, col, 28)
    return ((f[0] >= bias[0]) & (f[1] >= bias[1]) & (f[2] >= bias[2]) & (col(24) > 0.0)
            & (az >= 0.0) & (aw > 0.0) & (asum - az >= 0.0))


def eval_records(col, px, py, bias=(0.0, 0.0, 0.0)):
    """Records ``col(k)`` (column k, broadcastable) at pixel centres
    (px, py): (a0, a1, a2, aw, cov), the varying numerators, the 1/w
    numerator and coverage (edges, near z>=0, camera-front w>0, far
    z<=w). The ops of ``vulkan_forge/_raster/tiles.py:38-53`` with XLA:CPU's
    contraction: each edge function is mad(a, p - b, -(c * (q - d))), each
    three-term sum mad(f2, c2, mad(f0, c0, f1 * c1)). Edge i covers where
    f_i >= bias[i]: 0 for the inclusive rule, the record's top-left
    threshold col(31 + i) for the hw rule (``tiles.py:49-52``); on the
    snapped lattice the edge functions are multiples of 2^-16 and exact
    while |dy * (px - ax)| < 256 px^2, so the fused and unfused forms agree
    there."""
    f = _edges(col, px, py)
    aw = _dot(f, col, 21)
    return _dot(f, col, 12), _dot(f, col, 15), _dot(f, col, 18), aw, _covers(col, f, aw, bias)


def cover_records(col, px, py, bias=(0.0, 0.0, 0.0)):
    """``eval_records``' coverage alone, with its ops (``vf::cover_pixel``
    in csrc/raster_common.cuh): it reads columns 0..11 and 21..30 (and the
    thresholds ``bias``), never the varying numerators 12..20; the 1/w
    numerator (21..23) is its w > 0 test."""
    f = _edges(col, px, py)
    return _covers(col, f, _dot(f, col, 21), bias)


def _pixel_centers(n_tiles: int, width: int, height: int, device):
    """(n_tiles, TILE*TILE) pixel-center x and y of every tile, row-major."""
    ntx, nty = tile_grid(width, height)
    t = torch.arange(n_tiles, device=device) % (ntx * nty)
    ty = torch.div(t, ntx, rounding_mode="floor")
    tx = t % ntx
    lp = torch.arange(TILE * TILE, device=device)
    px = (tx[:, None] * TILE + lp % TILE).to(torch.float32) + 0.5
    py = (ty[:, None] * TILE + torch.div(lp, TILE, rounding_mode="floor")
          ).to(torch.float32) + 0.5
    return px, py


def _assemble(planes: torch.Tensor, n_frames: int, width: int,
              height: int) -> torch.Tensor:
    """(B*NT, TILE*TILE) tile-major planes -> (B, H, W) image planes."""
    ntx, nty = tile_grid(width, height)
    p = planes.reshape(n_frames, nty, ntx, TILE, TILE).permute(0, 1, 3, 2, 4)
    return p.reshape(n_frames, nty * TILE, ntx * TILE)[:, :height, :width]


def render_gbuffer(records: torch.Tensor, binning: Binning, n_frames: int,
                   width: int, height: int):
    """Rasterize binned records into a g-buffer.

    records: (B*(T+1), REC_WIDTH) f32 (frames stacked); binning from
    ``setup.bin_tiles``. Each edge covers from the record's threshold at
    columns 31..33 (zero unless set up under the hw fill rule). Returns
    (v0, v1, v2, mask), each (B, H, W): the perspective-divided varyings of
    the winning triangle and its coverage.
    """
    offsets = binning.offsets.to(torch.long)
    rows = binning.rows.to(torch.long)
    n_tiles = offsets.numel() - 1
    counts = offsets[1:] - offsets[:-1]
    # Busiest tiles first: the tiles still walking at step p are a prefix.
    order = torch.argsort(counts, descending=True, stable=True)
    counts_o = counts[order]
    start_o = offsets[:-1][order]
    px, py = _pixel_centers(n_tiles, width, height, records.device)
    px, py = px[order], py[order]

    npx = TILE * TILE
    acc0 = torch.zeros((n_tiles, npx), dtype=torch.float32, device=records.device)
    acc1 = torch.zeros_like(acc0)
    acc2 = torch.zeros_like(acc0)
    accw = torch.ones_like(acc0)
    covered = torch.zeros((n_tiles, npx), dtype=torch.bool, device=records.device)

    # n_active[p] = number of tiles with more than p triangles.
    steps = torch.arange(int(counts_o[0].item()) if n_tiles else 0,
                         device=records.device)
    n_active = torch.searchsorted(-counts_o, -steps, side="left").tolist()
    for p, na in enumerate(n_active):
        r = records[rows[start_o[:na] + p]]           # (na, REC_WIDTH)

        def col(k):
            return r[:, k, None]

        a0, a1, a2, aw, cov = eval_records(
            col, px[:na], py[:na], (col(BIAS0_COL), col(BIAS1_COL), col(BIAS2_COL)))
        acc0[:na] = torch.where(cov, a0, acc0[:na])
        acc1[:na] = torch.where(cov, a1, acc1[:na])
        acc2[:na] = torch.where(cov, a2, acc2[:na])
        accw[:na] = torch.where(cov, aw, accw[:na])
        covered[:na] |= cov

    rcp = 1.0 / torch.where(torch.abs(accw) < 1e-20, 1.0, accw)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n_tiles, device=records.device)
    planes = [(acc0 * rcp)[inv], (acc1 * rcp)[inv], (acc2 * rcp)[inv], covered[inv]]
    return tuple(_assemble(p, n_frames, width, height) for p in planes)


def box_extents(boxes: torch.Tensor):
    """Decode ``Binning.boxes``: (x0, x1, y0, y1) int64, tile-local."""
    b = boxes.to(torch.long)
    return b & 15, (b >> 4) & 15, (b >> 8) & 15, (b >> 12) & 15


def _box_pixels(boxes: torch.Tensor) -> torch.Tensor:
    x0, x1, y0, y1 = box_extents(boxes)
    return (x1 - x0 + 1) * (y1 - y0 + 1)


def tile_work(binning: Binning) -> torch.Tensor:
    """(B*NT,) int64: the (pair, pixel) items each tile's raster kernel
    walks -- the pixels of its pairs' boxes, the count the kernels write to
    their ``evaluated`` output."""
    ends = torch.zeros(binning.boxes.numel() + 1, dtype=torch.long,
                       device=binning.boxes.device)
    ends[1:] = torch.cumsum(_box_pixels(binning.boxes), 0)
    offsets = binning.offsets.to(torch.long)
    return ends[offsets[1:]] - ends[offsets[:-1]]


def render_gbuffer_walk(records: torch.Tensor, binning: Binning, n_frames: int,
                        width: int, height: int):
    """``render_gbuffer`` in the order of the raster kernels (a torch mirror
    for tests; it holds every item in memory): each pair's box pixels are
    covered with ``cover_records`` and the tile-local winner is the largest
    covering record row (rows ascend with the id within a tile), then each
    pixel evaluates its winner alone with ``eval_records`` and divides."""
    dev = records.device
    offsets = binning.offsets.to(torch.long)
    rows = binning.rows.to(torch.long)
    n_tiles = offsets.numel() - 1
    npx = TILE * TILE
    pair_tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev),
                                        offsets[1:] - offsets[:-1])
    x0, x1, y0, y1 = box_extents(binning.boxes)
    n = _box_pixels(binning.boxes)
    pair = torch.repeat_interleave(torch.arange(rows.numel(), device=dev), n)
    local = torch.arange(pair.numel(), device=dev) - (torch.cumsum(n, 0) - n)[pair]
    bw = (x1 - x0 + 1)[pair]
    lx = x0[pair] + local % bw
    ly = y0[pair] + torch.div(local, bw, rounding_mode="floor")
    px, py = _pixel_centers(n_tiles, width, height, dev)
    slot = pair_tile[pair] * npx + ly * TILE + lx
    r = records[rows[pair]]

    def col(k):
        return r[:, k]
    cov = cover_records(col, px.reshape(-1)[slot], py.reshape(-1)[slot],
                        (col(BIAS0_COL), col(BIAS1_COL), col(BIAS2_COL)))
    win = torch.zeros(n_tiles * npx, dtype=torch.long, device=dev)
    win.scatter_reduce_(0, slot, torch.where(cov, rows[pair] + 1, 0), "amax")

    covered = win > 0
    w = records[(win - 1).clamp_min(0)]

    def wcol(k):
        return w[:, k]
    a0, a1, a2, aw, _ = eval_records(wcol, px.reshape(-1), py.reshape(-1),
                                     (wcol(BIAS0_COL), wcol(BIAS1_COL), wcol(BIAS2_COL)))
    zero = torch.zeros_like(a0)
    a0, a1, a2 = (torch.where(covered, a, zero) for a in (a0, a1, a2))
    aw = torch.where(covered, aw, 1.0)
    rcp = 1.0 / torch.where(torch.abs(aw) < 1e-20, 1.0, aw)
    planes = [a0 * rcp, a1 * rcp, a2 * rcp, covered]
    return tuple(_assemble(p.reshape(n_tiles, npx), n_frames, width, height) for p in planes)
