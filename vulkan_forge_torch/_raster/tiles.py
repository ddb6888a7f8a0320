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
"""
from __future__ import annotations

import torch

from .setup import TILE, Binning, tile_grid


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
    ``setup.bin_tiles``. Returns (v0, v1, v2, mask), each (B, H, W): the
    perspective-divided varyings of the winning triangle and its coverage.
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

        x, y = px[:na], py[:na]
        f0 = col(2) * (x - col(0)) - col(3) * (y - col(1))
        f1 = col(6) * (x - col(4)) - col(7) * (y - col(5))
        f2 = col(10) * (x - col(8)) - col(11) * (y - col(9))
        a0 = f0 * col(12) + f1 * col(13) + f2 * col(14)
        a1 = f0 * col(15) + f1 * col(16) + f2 * col(17)
        a2 = f0 * col(18) + f1 * col(19) + f2 * col(20)
        aw = f0 * col(21) + f1 * col(22) + f2 * col(23)
        # Clip-volume tests (near z>=0, camera-front w>0, far z<=w).
        az = f0 * col(25) + f1 * col(26) + f2 * col(27)
        asum = f0 * col(28) + f1 * col(29) + f2 * col(30)
        cov = ((f0 >= 0.0) & (f1 >= 0.0) & (f2 >= 0.0) & (col(24) > 0.0)
               & (az >= 0.0) & (aw > 0.0) & (asum - az >= 0.0))
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
