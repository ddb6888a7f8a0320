"""The segment kernels' skip tables and the torch mirror of their skip
tests (``_raster/segments.py``; CPU).

``csrc/segments.cu`` evaluates only the (8x128 tile, record) pairs whose
bbox overlaps the tile: it skips an interval whose y-extent (``seg_y``)
misses the tile row and a record whose compacted bbox misses the tile, and
launches the tiles in ``tile_order``. ``segments.overlap_walk`` mirrors
both tests; test_torch_cuda.py holds the kernels' ``evaluated`` output to
it on the card. Here, exactly:
- ``seg_y`` equals a brute force over the triangles, on both walks and on
  an empty scene; ``compact_valid``'s bbox is ``bbox[src]``;
  ``tile_order`` is a permutation of the tiles, most scanned records
  first;
- the mirror's pairs are the bbox-overlapping pairs, tile by tile, and the
  plain walk over them alone is ``render_gbuffer_segments_plain`` bit for
  bit (the yardstick that test_torch_segments.py holds to K8 itself);
- the wrappers reject skip tables of the wrong dtype, shape or device.
"""
import math

import numpy as np
import pytest
import torch

import vulkan_forge_torch as vt
from vulkan_forge_torch import _camera, _mesh, _renderer
from vulkan_forge_torch._raster import kernels, pipeline, segments as tseg, setup, vtx

torch.set_num_threads(1)

TW, TH = tseg.TILE_W, tseg.TILE_H


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _spike(grid, W, H, eye, near=0.1, columns=False):
    """The spike grid's inclusive (records, stream bbox, perm, row size) at
    a camera looking at the origin from ``eye`` (fovy 60), on the row-major
    or the column-major walk."""
    xyuv, _ = _mesh.build_grid_xyuv(grid)
    view = _camera.look_at_rh(eye, (0, 0, 0), (0, 1, 0))
    proj = _camera.perspective_wgpu(np.float32(math.radians(60)), np.float32(W / H),
                                    np.float32(near), np.float32(100))
    heights = _t(np.random.default_rng(grid).uniform(-0.3, 0.3, (9, 11)))
    f = vtx.vs_fields(_t(xyuv), heights, _t(view[None]), _t(proj[None]), _t(0.9), _t(1.2), W, H)
    records, bbox = setup.corner_records(
        *setup.grid_corners([f[:, k] for k in range(vtx.FIELDS)], grid), W, H)
    n = grid - 1
    perm = tseg.column_major_perm(n, n) if columns else None
    return records[0], bbox[0] if perm is None else bbox[0][perm], perm, 2 * n


def _frame(records, b, perm, rs, W, H):
    return (*tseg.compact_valid(records, b, perm), tseg.segment_bin(b, W, H, rs))


def _dem_frame(W, H):
    """A Renderer DEM-40 frame's segment-walk inputs (default camera)."""
    rng = np.random.default_rng(5)
    y, x = np.mgrid[0:40, 0:40] / np.float32(40)
    dem = sum(rng.uniform(5, 30) * np.sin(2 * math.pi * (rng.uniform(1, 3) * x
                                                         + rng.uniform(1, 3) * y))
              for _ in range(4)).astype(np.float32)
    r = vt.Renderer(W, H, device="cpu")
    r.add_terrain(dem, (30.0, 30.0), 1.5, "terrain")
    r.upload_height_r32f()
    terr = r._terrain
    xyuv, tris = _renderer.grid_mesh(terr.width, terr.height, *terr.spacing, "cpu")
    view, proj = r._default_terrain_camera(terr)
    fields = vtx.vs_fields(xyuv, r._height_tex, _t(view[None]), _t(proj[None]), _t(1.0),
                           _t(1.0), W, H, "extended")
    return pipeline.segment_frame(fields, tris, None, W, H, 2 * (terr.width - 1))


def _brute_extent(b, rs, W):
    """(NTX, ROWS, 2): min y0 and max y1 over the valid triangles of each
    row whose bbox spans each tile column."""
    b = b.numpy()
    rows = -(-b.shape[0] // rs)
    valid = b[:, 1] >= b[:, 0]
    row = np.arange(b.shape[0]) // rs
    want = np.tile(np.array([1 << 28, -1], np.int32), (-(-W // TW), rows, 1))
    for tx in range(want.shape[0]):
        spans = valid & (b[:, 0] // TW <= tx) & (b[:, 1] // TW >= tx)
        for r in range(rows):
            sel = spans & (row == r)
            if sel.any():
                want[tx, r] = b[sel, 2].min(), b[sel, 3].max()
    return want


def _brute_overlap(bbox, n_frames, W, H, frame_of):
    """Per tile ((frame*NTY + ty)*NTX + tx): the records whose bbox
    overlaps it."""
    ntx, nty = tseg.seg_grid(W, H)
    count = np.zeros((n_frames, nty, ntx), np.int64)
    for (x0, x1, y0, y1), f in zip(bbox.numpy(), frame_of):
        count[f, y0 // TH:y1 // TH + 1, x0 // TW:x1 // TW + 1] += 1
    return count.reshape(-1)


EXTENT_CASES = {"rows": dict(columns=False), "columns": dict(columns=True), "empty": None}


@pytest.mark.parametrize("case", sorted(EXTENT_CASES))
def test_extent_table_matches_brute_force(case):
    W, H = 300, 4200
    records, b, perm, rs = _spike(24, W, H, (2.0, 1.5, 2.5), **(EXTENT_CASES[case] or {}))
    if case == "empty":
        b = b.clone()
        b[:, 1] = -1
    sb = tseg.segment_bin(b, W, H, rs)
    want = _brute_extent(b, rs, W)
    assert sb.seg_y.dtype == torch.int32 and sb.seg_y.is_contiguous()
    np.testing.assert_array_equal(sb.seg_y.numpy(), want)
    # An interval holds triangles exactly where its extent is set.
    np.testing.assert_array_equal((sb.seg_hi >= sb.seg_lo).numpy(), want[..., 1] >= 0)
    assert (case == "empty") == bool((sb.seg_y[..., 1] < 0).all())


def test_compacted_bbox_is_the_stream_bbox():
    records, b, perm, rs = _spike(24, 300, 4200, (2.0, 1.5, 2.5), columns=True)
    src = torch.nonzero(b[:, 1] >= b[:, 0]).squeeze(1)
    crec, ids, cb = tseg.compact_valid(records, b, perm)
    assert cb.dtype == torch.int32 and cb.is_contiguous() and cb.shape == (ids.numel(), 4)
    assert torch.equal(cb, b[src].to(torch.int32))
    assert torch.equal(crec, records[perm[src]]) and torch.equal(ids.long(), perm[src])


@pytest.mark.parametrize("columns", [False, True])
def test_tile_order_is_a_permutation_heaviest_first(columns):
    """tile_order sorts the tiles by the records each scans once the
    intervals whose extent misses its tile row are skipped (a brute force
    over the walk), most first, ties in tile order."""
    W, H = 300, 4200
    records, b, perm, rs = _spike(24, W, H, (2.0, 1.5, 2.5), columns=columns)
    sb = tseg.segment_bin(b, W, H, rs)
    ntx, nty = tseg.seg_grid(W, H)
    lo, hi, ey = sb.seg_lo.numpy(), sb.seg_hi.numpy(), sb.seg_y.numpy()
    work = np.zeros(nty * ntx, np.int64)
    for ty in range(nty):
        for tx in range(ntx):
            for r in range(sb.r_bounds[0, ty], sb.r_bounds[1, ty] + 1):
                if hi[tx, r] >= lo[tx, r] and ey[tx, r, 1] >= ty * TH \
                        and ey[tx, r, 0] < (ty + 1) * TH:
                    work[ty * ntx + tx] += hi[tx, r] - lo[tx, r] + 1
    order = sb.tile_order.numpy()
    assert sb.tile_order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(nty * ntx))
    np.testing.assert_array_equal(order, np.argsort(-work, kind="stable"))
    assert work[order[0]] == work.max() > work[order[-1]]


# label: (frame maker, W, H): a tall spike on each walk, a w-crossing
# camera (near plane closer than a cell) and a small DEM through the
# Renderer.
OVERLAP_CASES = {
    "spike rows": (lambda W, H: _frame(*_spike(24, W, H, (2.0, 1.5, 2.5)), W, H), 136, 4104),
    "spike columns": (lambda W, H: _frame(*_spike(24, W, H, (2.0, 1.5, 2.5), columns=True),
                                          W, H), 136, 4104),
    "w-crossing": (lambda W, H: _frame(*_spike(16, W, H, (0.3, 0.35, 0.2), near=0.001), W, H),
                   136, 512),
    "dem": (_dem_frame, 136, 1024),
}


@pytest.mark.parametrize("case", sorted(OVERLAP_CASES))
def test_skip_mirror_evaluates_exactly_the_overlapping_pairs(case):
    """The mirror keeps, tile by tile, exactly the pairs whose bbox overlaps
    the tile (fewer than K8's walk), and the plain walk over those alone
    equals the plain walk over every interval bit for bit; the wrapper's
    ``evaluated`` output is the mirror's count."""
    build, W, H = OVERLAP_CASES[case]
    rec, ids, bbox, sb = tseg.stack_frames([build(W, H)])
    pos, offsets = tseg.overlap_walk(bbox, sb, 1, W, H)
    per_tile = (offsets[1:] - offsets[:-1]).numpy()
    want = _brute_overlap(bbox, 1, W, H, np.zeros(bbox.shape[0], np.int64))
    np.testing.assert_array_equal(per_tile, want)
    assert 0 < want.sum() < tseg._walk_lists(sb, 1, W, H)[0].numel()
    if case == "w-crossing":
        assert bool(((bbox[:, 1] - bbox[:, 0] == W - 1) & (bbox[:, 3] - bbox[:, 2] == H - 1)).any())
    # On the CPU the wrapper is the plain walk over every interval.
    evaluated = torch.full((1, per_tile.size), -1, dtype=torch.int32)
    plain = kernels.seg_gbuffer(rec, ids, bbox, sb, 1, W, H, evaluated=evaluated)
    np.testing.assert_array_equal(evaluated[0].numpy(), want)
    skipped = tseg.render_gbuffer_walk(rec, ids, (pos, offsets), 1, W, H)
    assert 0 < int(plain[3].sum())
    for a, c in zip(skipped, plain):
        assert torch.equal(a, c)


def test_stacked_frames_pad_the_extent_and_keep_each_walk():
    """Two frames of different ROWS: the shorter one's tables are padded
    with empty intervals and extents, and the mirror walks each frame as
    alone."""
    W, H = 300, 4200
    frames = [_frame(*_spike(24, W, H, (2.0, 1.5, 2.5)), W, H),
              _frame(*_spike(16, W, H, (-2.0, 1.4, 2.6), columns=True), W, H)]
    rec, ids, bbox, sb = tseg.stack_frames(frames)
    rows = [f[3].seg_lo.shape[1] for f in frames]
    assert rows[1] < rows[0] == sb.seg_y.shape[2]
    pad = sb.seg_y[1, :, rows[1]:]
    assert bool((pad[..., 0] == 1 << 28).all()) and bool((pad[..., 1] == -1).all())
    assert torch.equal(sb.tile_order, torch.stack([f[3].tile_order for f in frames]))
    offsets = tseg.overlap_walk(bbox, sb, 2, W, H)[1]
    counts = (offsets[1:] - offsets[:-1]).view(2, -1)
    for k, f in enumerate(frames):
        one = tseg.overlap_walk(*tseg.stack_frames([f])[2:], 1, W, H)[1]
        assert torch.equal(counts[k], one[1:] - one[:-1])


def _misaligned(records):
    out = torch.empty(records.numel() + 1)[1:].view(records.shape)
    out.copy_(records)
    return out


BAD_INPUTS = {
    "bbox dtype": (lambda r, i, b, s, e: (r, i, b.long(), s, e), "bbox must be"),
    "bbox shape": (lambda r, i, b, s, e: (r, i, b[:, :3].contiguous(), s, e), "bbox must be"),
    "bbox device": (lambda r, i, b, s, e: (r, i, b.to("meta"), s, e), "bbox is on meta"),
    "extent dtype": (lambda r, i, b, s, e: (r, i, b, s._replace(seg_y=s.seg_y.long()), e),
                     "binning.seg_y must be"),
    "extent shape": (lambda r, i, b, s, e: (r, i, b, s._replace(
        seg_y=s.seg_y[..., 0].contiguous()), e), "binning.seg_y must be"),
    "extent device": (lambda r, i, b, s, e: (r, i, b, s._replace(seg_y=s.seg_y.to("meta")), e),
                      "binning.seg_y is on meta"),
    "order shape": (lambda r, i, b, s, e: (r, i, b, s._replace(
        tile_order=s.tile_order[:, 1:].contiguous()), e), "binning.tile_order must be"),
    "order not a permutation": (lambda r, i, b, s, e: (r, i, b, s._replace(
        tile_order=torch.zeros_like(s.tile_order)), e), "tile_order must be a permutation"),
    "evaluated dtype": (lambda r, i, b, s, e: (r, i, b, s, e.long()), "evaluated must be"),
    "records alignment": (lambda r, i, b, s, e: (_misaligned(r), i, b, s, e), "16-byte"),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_wrappers_reject_bad_skip_tables(case):
    W, H = 300, 4200
    rec, ids, bbox, sb = tseg.stack_frames([_frame(*_spike(16, W, H, (2.0, 1.5, 2.5)), W, H)])
    evaluated = torch.zeros((1, sb.tile_order.shape[1]), dtype=torch.int32)
    bad, match = BAD_INPUTS[case]
    r, i, b, s, e = bad(rec, ids, bbox, sb, evaluated)
    shade = (torch.ones(256, 4), torch.tensor(1.0), torch.tensor(1.0), torch.tensor([0., 1., 0.]))
    with pytest.raises(ValueError, match=match):
        kernels.seg_gbuffer(r, i, b, s, 1, W, H, evaluated=e)
    with pytest.raises(ValueError, match=match):
        kernels.seg_shade_shipped(r, i, b, s, 1, W, H, *shade, evaluated=e)
