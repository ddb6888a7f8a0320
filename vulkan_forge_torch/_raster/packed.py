"""Indexed-mesh route: any triangle mesh given by an index buffer.

Port of the function of ``vulkan_forge/_raster/packed.py``'s K5
(``_packed_kernel``, packed.py:222) and K6 (``_packed_id_kernel`` +
``_varyings_from_ids``, packed.py:580, :704): draw-order triangles -> for
each pixel the covering valid triangle with the largest id, its
perspective-correct varyings and a mask. K6 computes that as a winner id
plus a record gather; the port's kernels (``csrc/packed.cu``) take that
form, merged with K5, as three passes per batch:

  1. cover: per triangle, setup in registers from its three indexed
     corners and a walk of its pixel-centre bbox; every covered pixel keeps
     the maximum ``id + 1`` (0 = uncovered). A triangle whose bbox holds
     more than ``vtx.BIG_PIXELS`` pixels is listed instead and walked by a
     whole block in a second kernel, which skips the triangles and tiles
     it cannot cover (``vtx.big_tile_walk``);
  2. resolve: per pixel, the winner's record is built again from its
     indexed corners and evaluated at the pixel centre.

Despite the module's name it packs nothing. The JAX package's 128
B/triangle lane layout, its DMA slab ring, its per-column worklists and
its f32 split painter ids (``exact_ids``, for T >= 2**24) exist to feed a
TPU's VMEM and its f32 lanes. Here the inputs are the post-VS fields of
the vertices, (B, 7, N) f32 from ``vtx.vs_fields``, and the (T, 3) int32
index buffer; painter ids are integers (int32 in the kernels, int64 in the
plain version), exact at any T below 2**31 / B.

This module holds the plain PyTorch version of each pass -- the
specification the kernels are held to, which CPU tensors take -- built on
``vtx.py``'s corner-based bodies, and the route's entry. Triangle id =
row of the index buffer; corners are taken in index order
(``setup.indexed_corners``), so the records are ``setup.setup_cols``'s bit
for bit and the g-buffer equals the record route's.
"""
from __future__ import annotations

import torch

from . import kernels, vtx
from .setup import indexed_corners


def tri_corners(fields: torch.Tensor, indices: torch.Tensor,
                frame: torch.Tensor, tri: torch.Tensor):
    """Corners of triangles ``tri`` of frames ``frame`` (1-D int64), read
    through the index buffer as the kernels read them: three lists of 7
    tensors."""
    verts = indices.to(torch.long)[tri]
    return [[fields[frame, f, verts[:, j]] for f in range(vtx.FIELDS)] for j in range(3)]


def cover_plain(fields: torch.Tensor, indices: torch.Tensor, width: int, height: int,
                stats: dict | None = None):
    """Plain version of ``vf_packed_cover``: (winner (B, H, W) int32, big
    (B*T,) int32 list of frame*T + id, count (1,) int32), as
    ``vtx.cover_from_corners`` defines them (``stats`` as there)."""
    corners = indexed_corners([fields[:, f] for f in range(vtx.FIELDS)], indices)
    return vtx.cover_from_corners(*corners, width, height, stats)


def cover_big_plain(fields: torch.Tensor, indices: torch.Tensor, winner: torch.Tensor,
                    big: torch.Tensor, count: torch.Tensor,
                    stats: dict | None = None) -> torch.Tensor:
    """Plain version of ``vf_packed_cover_big``: deposits the listed
    triangles into ``winner`` in place (as the kernel's atomicMax does),
    walking their whole bboxes (``stats`` as in
    ``vtx.cover_big_from_corners``)."""
    return vtx.cover_big_from_corners(
        lambda frame, tri: tri_corners(fields, indices, frame, tri),
        indices.shape[0], winner, big, count, stats)


def big_walk_counts(fields: torch.Tensor, indices: torch.Tensor, big: torch.Tensor,
                    count: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """The tiles ``vf_packed_cover_big`` walks for each list entry, from the
    torch mirror of its rejects (``vtx.walk_counts_from_corners``)."""
    return vtx.walk_counts_from_corners(
        lambda frame, tri: tri_corners(fields, indices, frame, tri),
        indices.shape[0], big, count, width, height)


def resolve_gbuffer_plain(fields: torch.Tensor, indices: torch.Tensor,
                          winner: torch.Tensor):
    """Plain version of ``vf_packed_resolve_gbuffer``: (v0, v1, v2, mask),
    each (B, H, W), uncovered pixels 0 (``_varyings_from_ids``'s rule)."""
    return vtx.resolve_from_corners(
        lambda frame, tri: tri_corners(fields, indices, frame, tri), winner)


def resolve_sectors(fields: torch.Tensor, indices: torch.Tensor,
                    winner: torch.Tensor) -> int:
    """Distinct 32-byte sectors ``vf_packed_resolve_gbuffer`` must read: the
    index buffer's rows of every covered pixel's winner, and
    ``vtx.RESOLVE_PLANES`` planes of their corners (``vtx.field_sectors``);
    both tensors' starts 32-byte aligned."""
    frame, tri = vtx.winners(winner)
    rows = torch.unique(tri)
    entries = (rows[:, None] * 3 + torch.arange(3, device=rows.device)) * 4
    index = int(torch.unique(torch.div(entries, vtx.SECTOR_BYTES,
                                       rounding_mode="floor")).numel())
    verts = indices.to(torch.long)[tri]
    return index + vtx.field_sectors(frame, verts.unbind(1), fields.shape[2])


def render_gbuffer_packed_batch(fields: torch.Tensor, indices: torch.Tensor,
                                width: int, height: int):
    """B frames of one indexed mesh through the indexed-mesh kernels (the
    counterpart of JAX's entry of the same name, packed.py:952).

    fields: (B, 7, N) float32 from ``vtx.vs_fields``; indices: (T, 3)
    int32, each in [0, N). Returns (v0, v1, v2, mask), each (B, H, W):
    cover, big-triangle cover, resolve.
    """
    winner = kernels.packed_cover_big(
        fields, indices, *kernels.packed_cover(fields, indices, width, height))
    return kernels.packed_resolve_gbuffer(fields, indices, winner)
