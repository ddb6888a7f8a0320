"""The record kernels' walk and its torch mirror (CPU; no jax).

``vf_raster_gbuffer(_hw)`` and ``vf_raster_shade_shipped(_hw)``
(csrc/raster.cu) walk, for each binned (tile, triangle) pair, only the
pixels of the pair's box -- its bbox clipped to the tile, which
``setup.bin_tiles`` packs into ``Binning.boxes`` -- test coverage alone
there (``vf::cover_pixel``, twin of ``tiles.cover_records``), keep the
largest covering record row per pixel, and evaluate that winner alone.
Here, exactly:
- every pair's box decodes to its bbox within its tile, at frames with
  partial right and bottom tiles, w-crossing full-screen bboxes, empty
  tiles, tiles of more than 64 records and pixel centres on edges (a
  watertight quad, where the hw rule's thresholds decide);
- ``tiles.tile_work`` (the kernels' ``evaluated`` count) equals a brute
  count of (pair, pixel) items;
- ``tiles.render_gbuffer_walk`` (the kernels' order in torch) gives the
  g-buffer of ``tiles.render_gbuffer`` bit for bit, under both fill rules,
  for the triangle, Scene g32 and DEM-64 frames; the JAX package stays the
  reference for those records through test_torch_raster.py and
  test_torch_fillrule.py;
- coverage never reads the varying numerators (columns 12..20);
- the CPU wrappers fill ``evaluated`` from the mirror and check it.
test_torch_cuda.py holds the kernels to the same counts on the card.
"""
import math

import numpy as np
import pytest
import torch

import vulkan_forge_torch as vt
from vulkan_forge_torch import _camera, _mesh, _renderer
from vulkan_forge_torch._raster import kernels, pipeline, setup, tiles, transform

torch.set_num_threads(1)

TILE = setup.TILE


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _setup(clip, vary, idx, W, H, rule):
    x, y, z, w = setup.clip_to_fb(clip, W, H)
    records, bbox = setup.triangle_setup(x, y, z, w, vary, idx, W, H, rule)
    return records.reshape(-1, setup.REC_WIDTH), bbox, setup.bin_tiles(bbox, W, H)


def _triangle(rule, W=97, H=61):
    clip, colors = transform.triangle_vs(_t(pipeline._TRI_POS), _t(pipeline._TRI_COLOR))
    return _setup(clip, colors, torch.tensor([[0, 1, 2]]), W, H, rule) + (W, H)


def _scene_g32(rule):
    s = vt.Scene(160, 120, 32, "magma", device="cpu")
    s.set_height_from_r32f((np.outer(np.sin(np.linspace(0, 3, 33)),
                                     np.cos(np.linspace(0, 2, 45))) * 0.3).astype(np.float32))
    g = s._globals
    clip, vary = transform.terrain_vs(_t(s._xyuv), _t(s._heights), _t(s._view)[None],
                                      _t(s._proj)[None], _t(g.spacing), _t(g.exaggeration))
    idx = torch.as_tensor(s._indices.astype(np.int64).reshape(-1, 3))
    return _setup(clip, vary, idx, 160, 120, rule) + (160, 120)


def _proj(near, W, H):
    return _camera.perspective_wgpu(np.float32(math.radians(60)), np.float32(W / H),
                                    np.float32(near), np.float32(1e4))


def _grid_wcross(rule, W=97, H=61, grid=64):
    """The spike grid from inside the relief, near 0.001: valid triangles
    cross w = 0 and get full-screen bboxes (chip_smoke's special_cameras)."""
    xyuv, idx = _mesh.build_grid_xyuv(grid)
    view = _camera.look_at_rh((0.0, 0.9, 0.0), (1.5, -0.2, 1.5), (0, 1, 0))
    clip, vary = transform.terrain_vs(_t(xyuv), _t(np.zeros((1, 1))), _t(view[None]),
                                      _t(_proj(0.001, W, H)[None]), _t(1.0), _t(1.0))
    return _setup(clip, vary, torch.as_tensor(idx.astype(np.int64).reshape(-1, 3)), W, H,
                  rule) + (W, H)


def _dem64(rule, wcross=False, W=97, H=61, n=64):
    """A Renderer DEM-64 frame (extended vertex stage): the default camera
    and two frames of the close-in / w-crossing DEM cameras."""
    rng = np.random.default_rng(n)
    y, x = np.mgrid[0:n, 0:n] / np.float32(n)
    dem = sum(rng.uniform(100, 400) * np.sin(2 * math.pi * (rng.uniform(1, 3) * x
                                                            + rng.uniform(1, 3) * y
                                                            + rng.uniform()))
              for _ in range(4)).astype(np.float32)
    r = vt.Renderer(W, H, device="cpu")
    r.add_terrain(dem, (30.0, 30.0), 1.5, "terrain")
    r.upload_height_r32f()
    terr = r._terrain
    xyuv, tris = _renderer.grid_mesh(terr.width, terr.height, *terr.spacing, "cpu")
    if wcross:
        h0 = float(terr.heights[n // 2, n // 2])
        views = np.stack([_camera.look_at_rh((0.0, h0 + above, 0.0), target, (0, 1, 0))
                          for above, target in ((300.0, (-3000.0, h0 - 400.0, -2000.0)),
                                                (5.0, (3000.0, h0 - 100.0, 2500.0)))])
        projs = np.stack([_proj(0.1, W, H), _proj(0.001, W, H)])
    else:
        view, proj = r._default_terrain_camera(terr)
        views, projs = view[None], proj[None]
    clip, vary = transform.terrain_vs_extended(xyuv, r._height_tex, _t(views), _t(projs),
                                               _t(1.0), _t(1.0))
    return _setup(clip, vary, tris.long(), W, H, rule) + (W, H)


def _quad(rule, W=128, H=96, copies=1):
    """Two triangles tiling a quad whose corners and shared diagonal lie on
    pixel centres (tests/test_fillrule.py:51-79): pixel centres exactly on
    edges, where the hw rule's thresholds decide; drawn ``copies`` times."""
    def ndc(px, py):
        return (2 * (px + 0.5) / W - 1, 1 - 2 * (py + 0.5) / H)
    clip = _t([[x, y, 0.5, 1.0] for x, y in (ndc(10, 10), ndc(70, 10), ndc(70, 70),
                                               ndc(10, 70))])
    return _setup(clip, _t(np.ones((4, 3))), torch.tensor([[0, 2, 1], [0, 3, 2]] * copies),
                  W, H, rule) + (W, H)


CASES = {"triangle 97x61": _triangle,
         "quad 128x96": _quad,
         "quad x20 128x96": lambda rule: _quad(rule, copies=20),
         "triangle 160x120": lambda rule: _triangle(rule, 160, 120),
         "Scene g32 160x120": _scene_g32,
         "g64 w-crossing 97x61": _grid_wcross,
         "DEM-64 97x61": _dem64,
         "DEM-64 close-in + w-crossing 97x61": lambda rule: _dem64(rule, wcross=True)}
RULES = ("inclusive", "hw")


def _pair_tiles(binning):
    """The tile of every pair."""
    offsets = binning.offsets.long()
    tile = torch.repeat_interleave(torch.arange(offsets.numel() - 1), offsets[1:] - offsets[:-1])
    return tile


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_boxes_are_the_bbox_within_the_tile(case, rule):
    records, bbox, binning, W, H = CASES[case](rule)
    if bbox.dim() == 2:
        bbox = bbox[None]
    B, T = bbox.shape[:2]
    ntx, nty = setup.tile_grid(W, H)
    assert binning.boxes.dtype == torch.int32 and binning.boxes.shape == binning.rows.shape
    tile = _pair_tiles(binning)
    frame = torch.div(tile, ntx * nty, rounding_mode="floor")
    t = tile % (ntx * nty)
    ox = (t % ntx) * TILE
    oy = torch.div(t, ntx, rounding_mode="floor") * TILE
    tri = binning.rows.long() - frame * (T + 1)
    b = bbox.reshape(B * T, 4)[frame * T + tri].long()
    # The bbox meets the tile, and the box is exactly their intersection.
    want = torch.stack([torch.maximum(b[:, 0], ox), torch.minimum(b[:, 1], ox + TILE - 1),
                        torch.maximum(b[:, 2], oy), torch.minimum(b[:, 3], oy + TILE - 1)], 1)
    assert bool((want[:, 0] <= want[:, 1]).all()) and bool((want[:, 2] <= want[:, 3]).all())
    x0, x1, y0, y1 = tiles.box_extents(binning.boxes)
    got = torch.stack([ox + x0, ox + x1, oy + y0, oy + y1], 1)
    assert torch.equal(got, want)
    assert bool((got[:, 1] < W).all()) and bool((got[:, 3] < H).all())


def test_cases_cover_partial_tiles_full_screen_bboxes_empty_and_crowded_tiles():
    seen = {"partial": False, "full_screen": False, "empty": False, "crowded": False}
    for case, make in CASES.items():
        records, bbox, binning, W, H = make("inclusive")
        counts = binning.offsets[1:] - binning.offsets[:-1]
        b = bbox.reshape(-1, 4)
        seen["partial"] |= W % TILE != 0 and H % TILE != 0
        seen["full_screen"] |= bool(((b[:, 0] == 0) & (b[:, 1] == W - 1) & (b[:, 2] == 0)
                                     & (b[:, 3] == H - 1)).any())
        seen["empty"] |= bool((counts == 0).any())
        seen["crowded"] |= int(counts.max()) > 64
    assert all(seen.values()), seen


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_work_counts_every_box_pixel(case):
    records, bbox, binning, W, H = CASES[case]("hw")
    ntx, nty = setup.tile_grid(W, H)
    tile = _pair_tiles(binning)
    x0, x1, y0, y1 = tiles.box_extents(binning.boxes)
    # Brute force: each pair against every pixel of its tile.
    lp = torch.arange(TILE * TILE)
    lx, ly = lp % TILE, torch.div(lp, TILE, rounding_mode="floor")
    inside = ((lx >= x0[:, None]) & (lx <= x1[:, None]) & (ly >= y0[:, None])
              & (ly <= y1[:, None]))
    want = torch.zeros(binning.offsets.numel() - 1, dtype=torch.long)
    want.index_add_(0, tile, inside.sum(1))
    assert torch.equal(tiles.tile_work(binning), want)
    assert int(want.sum()) >= binning.rows.numel()


def _bits(planes):
    return [p.view(torch.int32) if p.dtype == torch.float32 else p for p in planes]


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_order_is_bit_equal_to_the_plain_raster(case, rule):
    records, bbox, binning, W, H = CASES[case](rule)
    B = 1 if bbox.dim() == 2 else bbox.shape[0]
    got = tiles.render_gbuffer_walk(records, binning, B, W, H)
    want = tiles.render_gbuffer(records, binning, B, W, H)
    assert int(want[3].sum()) > 0
    for a, b in zip(_bits(got), _bits(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("case", ["Scene g32 160x120", "g64 w-crossing 97x61"])
def test_coverage_never_reads_the_varying_numerators(case, rule):
    records, bbox, binning, W, H = CASES[case](rule)
    rows = binning.rows.long()
    ntx, nty = setup.tile_grid(W, H)
    t = _pair_tiles(binning) % (ntx * nty)
    lp = torch.arange(TILE * TILE)
    px = ((t % ntx)[:, None] * TILE + lp % TILE).float() + 0.5
    py = (torch.div(t, ntx, rounding_mode="floor")[:, None] * TILE
          + torch.div(lp, TILE, rounding_mode="floor")).float() + 0.5
    r = records[rows]
    bias = tuple(r[:, c, None] for c in (setup.BIAS0_COL, setup.BIAS1_COL, setup.BIAS2_COL))
    want = tiles.eval_records(lambda k: r[:, k, None], px, py, bias)[4]
    r[:, 12:21] = float("nan")
    got = tiles.cover_records(lambda k: r[:, k, None], px, py, bias)
    assert torch.equal(got, want) and bool(want.any())


def test_cpu_wrappers_fill_evaluated_from_the_mirror():
    records, bbox, binning, W, H = _dem64("hw", wcross=True)
    ntx, nty = setup.tile_grid(W, H)
    lut = _t(np.linspace(0, 1, 1024).reshape(256, 4))
    shade = (lut, _t(1.0), _t(1.1), _t([0.35, 0.9, 0.2]))
    want = tiles.tile_work(binning).view(2, nty * ntx).to(torch.int32)
    for call in (lambda e: kernels.raster_gbuffer(records, binning, 2, W, H, evaluated=e),
                 lambda e: kernels.raster_gbuffer_hw(records, binning, 2, W, H, evaluated=e),
                 lambda e: kernels.raster_shade_shipped(records, binning, 2, W, H, *shade,
                                                        evaluated=e),
                 lambda e: kernels.raster_shade_shipped_hw(records, binning, 2, W, H, *shade,
                                                           evaluated=e)):
        e = torch.full((2, nty * ntx), -1, dtype=torch.int32)
        call(e)
        assert torch.equal(e, want)
    for bad in (torch.zeros(2, nty * ntx, dtype=torch.int64),
                torch.zeros(1, nty * ntx, dtype=torch.int32),
                torch.zeros(nty * ntx, 2, dtype=torch.int32).t()):
        with pytest.raises(ValueError, match="evaluated"):
            kernels.raster_gbuffer(records, binning, 2, W, H, evaluated=bad)
    short = binning._replace(boxes=binning.boxes[:-1])
    with pytest.raises(ValueError, match="boxes"):
        kernels.raster_gbuffer_hw(records, short, 2, W, H)
    with pytest.raises(ValueError, match="boxes"):
        kernels.raster_gbuffer(records, binning._replace(boxes=binning.boxes.long()), 2, W, H)
