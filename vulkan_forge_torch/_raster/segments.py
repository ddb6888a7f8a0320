"""Segment-walk route for tall frames.

Port of ``vulkan_forge/_raster/segments.py`` and of the axis choice in its
pipeline (pipeline.py:148-180, 705-723). The JAX package sends a single
inclusive frame here when it has more than 20,000 triangles and its strip
accumulators do not fit VMEM (H >= 4089); the port routes the same frames
here (``pipeline.use_segment_route``).

Grid meshes are row-major: the triangles of one mesh row that overlap a
framebuffer tile column form one contiguous id interval. The route

  1. culls and compacts the records into a dense stream, order kept
     (``compact_valid``), with the original triangle id of each row;
  2. builds per-(mesh-row, tile-column) intervals in compacted coordinates
     and each tile row's active mesh-row range (``segment_bin``), walking
     the mesh row by row or column by column, whichever its work estimate
     says is cheaper (``walk_order``). Steps 1 and 2, from the frame's
     fields, are ``kernels.seg_setup``: the ``vf_seg_setup_*`` kernels of
     ``csrc/segments.cu`` for CUDA tensors, ``setup_frame_plain`` (the
     functions named here) for CPU tensors;
  3. walks each 8x128 tile's intervals and keeps, per pixel, the covering
     record with the largest original id: ``kernels.seg_gbuffer`` and
     ``kernels.seg_shade_shipped`` (``csrc/segments.cu``), the counterparts
     of ``segments._seg_kernel`` (K8, segments.py:159), or the plain
     version here for CPU tensors.

The kernels reach the per-pixel evaluation only with the (tile, record)
pairs whose bbox overlaps the tile: they skip an interval whose y-extent
(``seg_y``) misses the tile row and a record whose bbox (compacted beside
the records) misses the tile, and launch the tiles in ``tile_order``,
heaviest first. ``overlap_walk`` mirrors both tests for the checks; the
plain walk (``render_gbuffer_segments_plain``) walks every interval, as K8
does, and is what the kernels are held to bit for bit.

Tiles are the reference's 8x128 (``setup.py:86-87``), so the tables equal
JAX's. The original ids travel as an int32 vector beside the compacted
records, not in record columns 32..34 as the reference writes them
(segments.py:53-55): in the port columns 31..33 hold the hw rule's edge
thresholds (setup.py), and an int32 id is exact at any T below 2**31, so
the reference's (id >> 12, id & 4095) split compare for T >= 2**24
(``exact_ids``) has no counterpart. The winner is the largest id, never
the walk order, so a permuted (column-major) stream paints the same image
(segments.py:269-271). The stream has the exact valid count (a host read:
``torch.nonzero`` here, on the card read with the axes' estimates in one);
the reference's pow2 capacity exists for XLA's static shapes, and its
8-row DMA alignment and double buffering are TPU layout.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _trace
from . import fragment, kernels
from .setup import corner_records, grid_corners, indexed_corners
from .tiles import eval_records

# The reference's raster tile (vulkan_forge/_raster/setup.py:86-87). Must
# equal kTileH and kTileW in csrc/segments.cu (kernels.load() checks).
TILE_H, TILE_W = 8, 128
_NO_LO, _NO_HI = 1 << 28, -1        # an empty interval (segments.py:137-138)
_NO_TY = 1 << 20                    # a row without valid triangles (:142-143)
# (tile, record, pixel) evaluations per step of the plain walk: many on the
# card, where a step's launches cost more than its work; few on the host,
# where large temporaries leave the cache.
_PLAIN_ELEMS = {"cuda": 1 << 22, "cpu": 1 << 16}


class SegmentBinning(NamedTuple):
    """The walk tables of ``segment_bin``: the reference's five fields, then
    the port's two for the kernels' skip. One frame: seg_lo/seg_hi (NTX,
    ROWS) int32, inclusive interval of compacted in-row positions (empty:
    lo > hi); row_base (ROWS,) int32, compacted stream offset of each row;
    r_bounds (2, NTY) int32, the active mesh-row range [r_lo; r_hi] of each
    tile row; counts_est (NTY*NTX,) int32, the records each tile walks;
    seg_y (NTX, ROWS, 2) int32, each interval's pixel y-extent [min y0,
    max y1] over the triangles that join it (empty: [1 << 28, -1]);
    tile_order (NTY*NTX,) int32, the tiles (ty*NTX + tx) by the records
    they scan after the interval test, most first (stable).
    ``stack_frames`` adds a leading frame axis."""
    seg_lo: torch.Tensor
    seg_hi: torch.Tensor
    row_base: torch.Tensor
    r_bounds: torch.Tensor
    counts_est: torch.Tensor
    seg_y: torch.Tensor
    tile_order: torch.Tensor


def seg_grid(width: int, height: int):
    """(NTX, NTY) TILE_W x TILE_H tiles covering a width x height frame."""
    return -(-width // TILE_W), -(-height // TILE_H)


def compact_valid(records: torch.Tensor, bbox: torch.Tensor, ids=None):
    """Gather the valid triangles' records into a dense stream, in stream
    order (segments.py:59-89).

    records: (T or T+1, REC_WIDTH) rows indexed by original triangle id;
    bbox: (T, 4) int32 in stream order (valid: x1 >= x0). ``ids`` maps
    stream position -> original id when the stream is permuted (the
    column-major walk): each position then takes its original row, so
    geometry and painter id agree. Returns (compacted records (N,
    REC_WIDTH), original ids (N,) int32, compacted bbox (N, 4) int32 in
    stream order), N the valid count.
    """
    src = torch.nonzero(_trace.sync(bbox[:, 1] >= bbox[:, 0])).squeeze(1)
    orig = src if ids is None else ids.to(torch.long)[src]
    return records[orig], orig.to(torch.int32), bbox[src].to(torch.int32).contiguous()


def segment_bin(bbox: torch.Tensor, width: int, height: int, row_size: int) -> SegmentBinning:
    """Per-(mesh-row, tile-column) intervals in compacted coordinates
    (segments.py:92-156), for the stream ``bbox`` (T, 4) whose mesh rows
    are ``row_size`` consecutive triangles.

    A valid triangle's compacted position is row_base[row] + its rank among
    its row's valid triangles; it joins the interval of every tile column
    its bbox spans, and its row is active in every tile row its bbox spans.
    The reference takes a min and a max over every triangle once per tile
    column (O(T * NTX)); here each (triangle, tile column) pair is
    scattered once, which gives the same tables. The same pairs give each
    interval's y-extent (``seg_y``); the records each tile scans after the
    kernels' interval test (every non-empty interval's length in each tile
    row of its extent) give ``tile_order``.
    """
    T = bbox.shape[0]
    ntx, nty = seg_grid(width, height)
    rows = -(-T // row_size)
    dev = bbox.device
    b = bbox.to(torch.long)
    t = torch.nonzero(_trace.sync(b[:, 1] >= b[:, 0])).squeeze(1)   # valid ids, ascending
    b = b[t]
    row = torch.div(t, row_size, rounding_mode="floor")
    counts = torch.bincount(_trace.sync(row, 2), minlength=rows)    # its min and max
    row_base = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t.numel(), device=dev) - row_base[row]

    tx0 = torch.div(b[:, 0], TILE_W, rounding_mode="floor")
    span = torch.div(b[:, 1], TILE_W, rounding_mode="floor") - tx0 + 1
    # Two reads: the output's size and the check that no count is negative.
    pair = torch.repeat_interleave(torch.arange(t.numel(), device=dev), _trace.sync(span, 2))
    k = torch.arange(pair.numel(), device=dev) - (torch.cumsum(span, 0) - span)[pair]
    key = (tx0[pair] + k) * rows + row[pair]
    seg_lo = torch.full((ntx * rows,), _NO_LO, dtype=torch.long, device=dev)
    seg_hi = torch.full((ntx * rows,), _NO_HI, dtype=torch.long, device=dev)
    seg_lo.scatter_reduce_(0, key, rank[pair], "amin")
    seg_hi.scatter_reduce_(0, key, rank[pair], "amax")
    seg_y0 = torch.full((ntx * rows,), _NO_LO, dtype=torch.long, device=dev)
    seg_y1 = torch.full((ntx * rows,), _NO_HI, dtype=torch.long, device=dev)
    seg_y0.scatter_reduce_(0, key, b[pair, 2], "amin")
    seg_y1.scatter_reduce_(0, key, b[pair, 3], "amax")
    seg_y = torch.stack([seg_y0, seg_y1], 1).view(ntx, rows, 2)
    seg_lo, seg_hi = seg_lo.view(ntx, rows), seg_hi.view(ntx, rows)

    row_ty0 = torch.full((rows,), _NO_TY, dtype=torch.long, device=dev)
    row_ty1 = torch.full((rows,), -_NO_TY, dtype=torch.long, device=dev)
    row_ty0.scatter_reduce_(0, row, torch.div(b[:, 2], TILE_H, rounding_mode="floor"), "amin")
    row_ty1.scatter_reduce_(0, row, torch.div(b[:, 3], TILE_H, rounding_mode="floor"), "amax")
    tys = torch.arange(nty, device=dev)
    row_act = (row_ty0[:, None] <= tys) & (tys <= row_ty1[:, None])      # (ROWS, NTY)
    ridx = torch.arange(rows, device=dev)[:, None]
    r_lo = torch.where(row_act, ridx, rows).amin(0)
    r_hi = torch.where(row_act, ridx, -1).amax(0)

    # Records each tile walks: the interval lengths of its active rows
    # (the reference's f32 einsum, exact here in f64).
    seg_len = torch.clamp_min(seg_hi - seg_lo + 1, 0)
    est = row_act.T.to(torch.float64) @ seg_len.T.to(torch.float64)       # (NTY, NTX)

    # Records each tile scans once the intervals whose y-extent misses its
    # tile row are skipped: a difference array over tile rows per column.
    # (An interval's extent lies inside its row's active tile rows, so
    # these are walked.)
    n = seg_len.reshape(-1)
    live = n > 0
    cell = torch.div(torch.arange(ntx * rows, device=dev), rows, rounding_mode="floor") * (nty + 1)
    first = torch.where(live, torch.div(seg_y0, TILE_H, rounding_mode="floor"), 0)
    past = torch.where(live, torch.div(seg_y1, TILE_H, rounding_mode="floor") + 1, 0)
    diff = torch.zeros(ntx * (nty + 1), dtype=torch.long, device=dev)
    diff.scatter_add_(0, cell + first, n)
    diff.scatter_add_(0, cell + past, -n)
    scan = torch.cumsum(diff.view(ntx, nty + 1)[:, :nty], 1).T               # (NTY, NTX)
    order = torch.argsort(scan.reshape(-1), descending=True, stable=True)
    i32 = lambda a: a.to(torch.int32).contiguous()
    return SegmentBinning(i32(seg_lo), i32(seg_hi), i32(row_base),
                          i32(torch.stack([r_lo, r_hi])), i32(est.reshape(-1)), i32(seg_y),
                          i32(order))


def table_bytes(binning: SegmentBinning) -> int:
    """Bytes of the tables the kernels read: every table but counts_est."""
    return sum(t.nbytes for name, t in binning._asdict().items() if name != "counts_est")


def column_major_perm(cells_rows: int, cells_cols: int, device=None) -> torch.Tensor:
    """Stream order that walks a grid mesh column by column
    (pipeline.py:147-161): perm[j] is the original id at stream position j,
    original ids being row-major with two triangles per cell
    ((r*cols + c)*2 + k). int64."""
    t = torch.arange(cells_rows * cells_cols * 2, device=device)
    return t.view(cells_rows, cells_cols, 2).transpose(0, 1).reshape(-1)


def segment_axis_estimate(binning: SegmentBinning) -> int:
    """The walk's work estimate: the records all tiles walk
    (pipeline.py:164-180 sums counts_est in f32; exact here)."""
    return int(_trace.d2h(binning.counts_est.sum(dtype=torch.int64)))


class WalkStream(NamedTuple):
    """One walk of a frame's T triangles: ``length`` stream positions in
    rows of ``row_size``; a column-major walk (``columns``) takes the
    positions of ``column_major_perm(cells_rows, cells_cols)``, a
    row-major one (cells_rows = cells_cols = 0) the ids in order."""
    length: int
    row_size: int
    cells_rows: int
    cells_cols: int
    columns: bool


def walk_streams(n_tris: int, row_size: int) -> list:
    """The walks the reference weighs (pipeline.py:709-719): the row-major
    one, and the column-major one when ``row_size`` splits the T triangles
    into whole grid rows (0 < row_size < T, T % row_size == 0)."""
    walks = [WalkStream(n_tris, row_size, 0, 0, False)]
    if 0 < row_size < n_tris and n_tris % row_size == 0:
        cells_rows, cells_cols = n_tris // row_size, row_size // 2
        walks.append(WalkStream(cells_rows * cells_cols * 2, 2 * cells_rows, cells_rows,
                                cells_cols, True))
    return walks


def cheaper_walk(estimates) -> int:
    """The walk with the lowest work estimate; the row-major one on a tie."""
    return min(range(len(estimates)), key=lambda a: estimates[a])


def walk_order(bbox: torch.Tensor, width: int, height: int, row_size: int):
    """The reference's axis choice among ``walk_streams``: the column-major
    walk where there is one and its estimate is lower. Returns (perm or
    None, the chosen walk's SegmentBinning)."""
    walks = walk_streams(bbox.shape[0], row_size)
    perms = [None] + [column_major_perm(w.cells_rows, w.cells_cols, bbox.device)
                      for w in walks[1:]]
    binnings = [segment_bin(bbox if p is None else bbox[p], width, height, w.row_size)
                for w, p in zip(walks, perms)]
    if len(walks) == 1:
        return None, binnings[0]
    a = cheaper_walk([segment_axis_estimate(b) for b in binnings])
    return perms[a], binnings[a]


def setup_frame_plain(fields: torch.Tensor, indices, grid_n, width: int, height: int,
                      row_size: int):
    """Plain version of the ``vf_seg_setup_*`` chain (``kernels.seg_setup``,
    which says what the arguments are): every triangle's inclusive record
    and bbox from its corners (``grid_corners`` when ``grid_n`` names the
    mesh, else ``indexed_corners``), ``walk_order`` and ``compact_valid``.
    Returns (records, ids, bbox, SegmentBinning, columns)."""
    f = [fields[:, k] for k in range(fields.shape[1])]
    corners = grid_corners(f, int(grid_n)) if indices is None else indexed_corners(f, indices)
    records, bbox = corner_records(*corners, width, height)
    del corners
    records, bbox = records[0], bbox[0]
    perm, binning = walk_order(bbox, width, height, row_size)
    return (*compact_valid(records, bbox if perm is None else bbox[perm], perm), binning,
            perm is not None)


def stack_frames(frames):
    """B single frames [(compacted records, ids, bbox, SegmentBinning)] ->
    one stream: (records, ids, bbox, binning with a leading frame axis),
    each frame's row_base offset by its start in the stacked records and
    its tables padded with empty rows to the longest walk's ROWS. One
    frame is its tables with the axis added, nothing copied."""
    if len(frames) == 1:
        return (*frames[0][:3], SegmentBinning(*(t[None] for t in frames[0][3])))
    rows = max(f[3].seg_lo.shape[1] for f in frames)
    starts = [0]
    for rec, *_ in frames[:-1]:
        starts.append(starts[-1] + rec.shape[0])

    def pad(a, value):
        return torch.nn.functional.pad(a, (0, rows - a.shape[-1]), value=value)
    tables = [f[3] for f in frames]
    binning = SegmentBinning(
        torch.stack([pad(t.seg_lo, _NO_LO) for t in tables]),
        torch.stack([pad(t.seg_hi, _NO_HI) for t in tables]),
        torch.stack([pad(t.row_base + s, 0) for t, s in zip(tables, starts)]),
        torch.stack([t.r_bounds for t in tables]),
        torch.stack([t.counts_est for t in tables]),
        torch.stack([torch.stack([pad(t.seg_y[..., 0], _NO_LO), pad(t.seg_y[..., 1], _NO_HI)], -1)
                     for t in tables]),
        torch.stack([t.tile_order for t in tables]))
    return tuple(torch.cat([f[k] for f in frames]) for k in range(3)) + (binning,)


def _walk_lists(binning: SegmentBinning, n_frames: int, width: int, height: int,
                bbox=None):
    """Every tile's walk, in K8's order, as CSR: (stream positions of the
    entries, per-tile offsets); tile = (frame*NTY + ty)*NTX + tx. With the
    compacted ``bbox``, only the entries the kernels evaluate: those of
    intervals whose y-extent meets the tile row, then of records whose
    bbox overlaps the tile."""
    ntx, nty = seg_grid(width, height)
    dev = binning.seg_lo.device
    n_tiles = n_frames * nty * ntx
    tile = torch.arange(n_tiles, device=dev)
    frame = torch.div(tile, nty * ntx, rounding_mode="floor")
    ty = torch.div(tile, ntx, rounding_mode="floor") % nty
    tx = tile % ntx
    r_lo = binning.r_bounds[frame, 0, ty].to(torch.long)
    n_rows = torch.clamp_min(binning.r_bounds[frame, 1, ty].to(torch.long) - r_lo + 1, 0)

    def expand(n):
        """(owner, index within owner) of sum(n) entries, owner by owner."""
        owner = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n)
        return owner, torch.arange(owner.numel(), device=dev) - (torch.cumsum(n, 0) - n)[owner]

    pt, k = expand(n_rows)                                # (tile, row) pairs
    f, x, r = frame[pt], tx[pt], r_lo[pt] + k
    lo = binning.seg_lo[f, x, r].to(torch.long)
    n = torch.clamp_min(binning.seg_hi[f, x, r].to(torch.long) - lo + 1, 0)
    if bbox is not None:                                  # the interval test
        ey, y0 = binning.seg_y[f, x, r], ty[pt] * TILE_H
        n = torch.where((ey[:, 1] >= y0) & (ey[:, 0] < y0 + TILE_H), n, 0)
    start = binning.row_base[f, r].to(torch.long) + lo
    pe, k = expand(n)                                     # (tile, record) entries
    pos, owner = start[pe] + k, pt[pe]
    if bbox is not None:                                  # the record test
        b, x0, y0 = bbox[pos], tx[owner] * TILE_W, ty[owner] * TILE_H
        keep = ((b[:, 0] < x0 + TILE_W) & (b[:, 1] >= x0)
                & (b[:, 2] < y0 + TILE_H) & (b[:, 3] >= y0))
        pos, owner = pos[keep], owner[keep]
    offsets = torch.zeros(n_tiles + 1, dtype=torch.long, device=dev)
    offsets[1:] = torch.cumsum(torch.bincount(owner, minlength=n_tiles), 0)
    return pos, offsets


def overlap_walk(bbox: torch.Tensor, binning: SegmentBinning, n_frames: int, width: int,
                 height: int):
    """The (tile, record) pairs the kernels evaluate, in a torch mirror of
    their two skip tests (for the checks; the route never calls it): of
    K8's walk, the intervals whose y-extent meets the tile row, then the
    records whose bbox overlaps the tile. CSR as ``render_gbuffer_walk``
    takes it; offsets[t+1] - offsets[t] is tile t's count of evaluated
    pairs, the kernels' ``evaluated`` output."""
    return _walk_lists(binning, n_frames, width, height, bbox)


def render_gbuffer_segments_plain(records: torch.Tensor, ids: torch.Tensor,
                                  binning: SegmentBinning, n_frames: int,
                                  width: int, height: int):
    """Plain version of ``vf_seg_gbuffer``: K8's segment walk over every
    interval (``render_gbuffer_walk``). Returns (v0, v1, v2, mask), each
    (B, H, W), uncovered pixels 0."""
    return render_gbuffer_walk(records, ids, _walk_lists(binning, n_frames, width, height),
                               n_frames, width, height)


def render_gbuffer_walk(records: torch.Tensor, ids: torch.Tensor, walk, n_frames: int,
                        width: int, height: int):
    """The max-id g-buffer over given per-tile lists ``walk`` = (stream
    positions, per-tile offsets), vectorized over tiles.

    From step p every tile whose walk is longer than p evaluates its next
    k records (``tiles.eval_records``, the fused multiply-adds of every
    route) at its 8x128 pixel centres, k as many as the device's
    ``_PLAIN_ELEMS`` evaluations allow; a pixel takes the covering record
    of largest original id among them if that id is larger than its best
    so far. The winner is the largest id whatever the grouping, so this is
    the record-by-record walk's result. Returns (v0, v1, v2, mask), each
    (B, H, W), uncovered pixels 0.
    """
    ntx, nty = seg_grid(width, height)
    dev = records.device
    pos, offsets = walk
    n_tiles = offsets.numel() - 1
    counts = offsets[1:] - offsets[:-1]
    # Longest walks first: the tiles still walking at step p are a prefix.
    order = torch.argsort(counts, descending=True, stable=True)
    counts_o, start_o = counts[order], offsets[:-1][order]
    t = order % (nty * ntx)
    lp = torch.arange(TILE_H * TILE_W, device=dev)
    px = ((t % ntx)[:, None] * TILE_W + lp % TILE_W).to(torch.float32) + 0.5
    py = (torch.div(t, ntx, rounding_mode="floor")[:, None] * TILE_H
          + torch.div(lp, TILE_W, rounding_mode="floor")).to(torch.float32) + 0.5

    shape = (n_tiles, TILE_H * TILE_W)
    best = torch.full(shape, -1, dtype=torch.long, device=dev)
    acc = [torch.zeros(shape, dtype=torch.float32, device=dev) for _ in range(3)]
    accw = torch.ones(shape, dtype=torch.float32, device=dev)
    n_steps = int(counts_o[0]) if n_tiles else 0
    budget = _PLAIN_ELEMS.get(dev.type, _PLAIN_ELEMS["cpu"])
    p = 0
    while p < n_steps:
        na = int(torch.searchsorted(-counts_o, torch.tensor([-p], device=dev),
                                    side="left"))
        j = p + torch.arange(min(n_steps - p, max(1, budget // (na * TILE_H * TILE_W))),
                             device=dev)
        live = j < counts_o[:na, None]                                # (na, k)
        e = pos[torch.clamp_max(start_o[:na, None] + j, pos.numel() - 1)]
        r = records[e]
        idv = torch.where(live, ids[e].to(torch.long), -1)[:, :, None]
        a0, a1, a2, aw, cov = eval_records(lambda c: r[:, :, c, None], px[:na, None],
                                           py[:na, None])            # (na, k, pixels)
        top, pick = torch.where(cov, idv, -1).max(1)
        better = top > best[:na]
        best[:na] = torch.where(better, top, best[:na])
        for a, v in zip(acc + [accw], (a0, a1, a2, aw)):
            a[:na] = torch.where(better, v.gather(1, pick[:, None]).squeeze(1), a[:na])
        p += j.numel()

    rcp = 1.0 / torch.where(torch.abs(accw) < 1e-20, 1.0, accw)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n_tiles, device=dev)
    planes = [(a * rcp)[inv] for a in acc] + [(best >= 0)[inv]]

    def assemble(p):
        p = p.reshape(n_frames, nty, ntx, TILE_H, TILE_W).permute(0, 1, 3, 2, 4)
        return p.reshape(n_frames, nty * TILE_H, ntx * TILE_W)[:, :height, :width]
    return tuple(assemble(p) for p in planes)


def render_gbuffer_segments_batch(records: torch.Tensor, ids: torch.Tensor,
                                  bbox: torch.Tensor, binning: SegmentBinning,
                                  n_frames: int, width: int, height: int, evaluated=None):
    """B frames of compacted records through the segment walk (the
    counterpart of JAX's entry of the same name, segments.py:338):
    ``kernels.seg_gbuffer``. records (N, REC_WIDTH) f32, ids (N,) int32,
    bbox (N, 4) int32 and a binning with a leading frame axis, from
    ``stack_frames``; ``evaluated`` as the kernel takes it. Returns (v0,
    v1, v2, mask), each (B, H, W)."""
    return kernels.seg_gbuffer(records, ids, bbox, binning, n_frames, width, height,
                               evaluated)


def render_image_segments_batch(records: torch.Tensor, ids: torch.Tensor,
                                bbox: torch.Tensor, binning: SegmentBinning,
                                n_frames: int, width: int, height: int, lut, h_range,
                                exposure, sun_dir, evaluated=None):
    """``render_gbuffer_segments_batch`` with the shipped shader fused:
    ``kernels.seg_shade_shipped``. Returns (B, H, W) uint32 RGBA."""
    return kernels.seg_shade_shipped(records, ids, bbox, binning, n_frames, width, height,
                                     lut, h_range, exposure, sun_dir, evaluated)


def render_image_segments_plain(records, ids, binning, n_frames, width, height,
                                lut, h_range, exposure, sun_dir):
    """Plain version of ``vf_seg_shade_shipped``: the plain walk, then
    ``fragment.terrain_fs``."""
    return fragment.terrain_fs(*render_gbuffer_segments_plain(
        records, ids, binning, n_frames, width, height), lut, h_range, exposure, sun_dir)
