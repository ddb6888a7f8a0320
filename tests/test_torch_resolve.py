"""The resolves of the vertex-stream and indexed-mesh routes on the CPU.

What the CUDA resolves (``vf::resolve_tile`` in csrc/raster_common.cuh,
``vf_vtx_resolve_*`` and ``vf_packed_resolve_gbuffer``) are held to here,
without a card:

  - the pixel-to-thread mapping: ``vtx.resolve_pixel_map`` (the kernels'
    mapping, written out in torch) takes every pixel of a frame exactly
    once, ragged right and bottom edges included, and its constants are
    the .cu file's;
  - ``vtx.resolve_sectors`` and ``packed.resolve_sectors``, which chip_smoke
    charges as the resolves' ``sector_bound_ms``: equal to a brute-force
    count of the distinct 32-byte sectors the covered pixels' winners read;
  - the plain resolves at frame sizes that are not multiples of the tile,
    against the JAX package's jnp oracles (the record route's g-buffer,
    ``tiles.render_gbuffer``, and K5's spec ``render_gbuffer_packed_ref``),
    as tests/test_torch_vtx.py and tests/test_torch_packed.py call them.
"""
import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vulkan_forge import _camera as jcam, _colormap as jcmap, _mesh as jmesh
from vulkan_forge._raster import fragment as jfrag

from vulkan_forge_torch._parity import assert_fs_policy, assert_gbuffer_close
from vulkan_forge_torch._raster import kernels, packed as tpacked, vtx as tvtx

from test_torch_packed import _jax_fields as _jax_packed_fields, _jax_spec, _renderer_mesh
from test_torch_vtx import _jax_fields as _jax_vtx_fields, _jax_oracle

torch.set_num_threads(1)


# ---------------- the pixel-to-thread mapping ----------------

def test_resolve_tile_constants_match_source():
    # kernels.load() makes the same check against the built library.
    src = (kernels._PKG_DIR / "csrc" / "raster_common.cuh").read_text()
    const = {m.group(1): int(m.group(2))
             for m in re.finditer(r"constexpr int (kResolve\w+) = (\d+);", src)}
    assert const == {"kResolveThreads": tvtx.RESOLVE_THREADS,
                     "kResolveTileW": tvtx.RESOLVE_TILE_W,
                     "kResolveWarpW": tvtx.RESOLVE_WARP_W}
    assert tvtx.RESOLVE_TILE_H * tvtx.RESOLVE_TILE_W == tvtx.RESOLVE_THREADS


@pytest.mark.parametrize("frames,W,H", [(1, 97, 61), (1, 800, 600), (1, 1, 1), (3, 33, 7),
                                        (2, 801, 599)])
def test_resolve_pixel_map_takes_each_pixel_once(frames, W, H):
    got = tvtx.resolve_pixel_map(frames, W, H)
    tiles = -(-W // tvtx.RESOLVE_TILE_W) * -(-H // tvtx.RESOLVE_TILE_H)
    assert tuple(got.shape) == (frames * tiles, tvtx.RESOLVE_THREADS)
    taken = got[got >= 0]
    assert torch.equal(torch.sort(taken).values, torch.arange(frames * H * W))
    # Each block stays in one frame.
    frame = torch.div(got, H * W, rounding_mode="floor")
    assert bool(((frame == frame.max(dim=1, keepdim=True).values) | (got < 0)).all())


def test_resolve_warps_take_2d_patches():
    """In a tile away from the edges each warp takes a RESOLVE_WARP_W x
    (32 / RESOLVE_WARP_W) rectangle of pixels, and the block a
    RESOLVE_TILE_W x RESOLVE_TILE_H one."""
    W, H = 4 * tvtx.RESOLVE_TILE_W, 4 * tvtx.RESOLVE_TILE_H
    got = tvtx.resolve_pixel_map(1, W, H)[5]          # tile (1, 1)
    x, y = got % W, torch.div(got, W, rounding_mode="floor")
    for warp in range(tvtx.RESOLVE_THREADS // 32):
        wx, wy = x[32 * warp:32 * (warp + 1)], y[32 * warp:32 * (warp + 1)]
        assert int(wx.max() - wx.min()) + 1 == tvtx.RESOLVE_WARP_W
        assert int(wy.max() - wy.min()) + 1 == 32 // tvtx.RESOLVE_WARP_W
    assert int(x.max() - x.min()) + 1 == tvtx.RESOLVE_TILE_W
    assert int(y.max() - y.min()) + 1 == tvtx.RESOLVE_TILE_H


# ---------------- the sectors a resolve must read ----------------

def _brute_sectors(winner, nv, vertices_of, index_rows=False):
    """Distinct 32-byte sectors of a (B, 7, nv) f32 fields tensor (and of a
    (T, 3) int32 index buffer) read for every covered pixel: planes 0..5 of
    its winner's three corners (and the winner's index row)."""
    field, index = set(), set()
    for b, y, x in zip(*np.nonzero(winner)):
        tri = int(winner[b, y, x]) - 1
        for v in vertices_of(tri):
            for plane in range(6):
                field.add(((int(b) * 7 + plane) * nv + int(v)) * 4 // 32)
        if index_rows:
            index.update((3 * tri + j) * 4 // 32 for j in range(3))
    return len(field) + len(index)


def _grid_vertices(n):
    """The grid triangle's corners as the kernels decode its id (tri0 = [A,
    C, B], tri1 = [B, C, D]), written out independently of the port."""
    def of(tri):
        cell, k = divmod(tri, 2)
        row, col = divmod(cell, n - 1)
        a = row * n + col
        return (a, a + n, a + 1) if k == 0 else (a + 1, a + n, a + n + 1)
    return of


def _vtx_frame(grid, W, H, batch, eye=(3.0, 2.0, 3.0)):
    """Post-VS fields of the spike grid (batch cameras about ``eye``) and
    the plain cover's winners."""
    xyuv, _ = jmesh.build_grid_xyuv(grid)
    views, projs = [], []
    for b in range(batch):
        a = 0.7 * b
        e = (eye[0] * math.cos(a) - eye[2] * math.sin(a), eye[1],
             eye[0] * math.sin(a) + eye[2] * math.cos(a))
        views.append(jcam.look_at_rh(e, (0, 0, 0), (0, 1, 0)))
        projs.append(jcam.perspective_wgpu(np.float32(math.radians(45.0)), np.float32(W / H),
                                           np.float32(0.1), np.float32(100.0)))
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    fields = tvtx.vs_fields(t(xyuv), t(np.zeros((1, 1))), t(np.stack(views)),
                            t(np.stack(projs)), t(1.0), t(1.0), W, H)
    winner = tvtx.cover_big_plain(fields, grid, *tvtx.cover_plain(fields, grid, W, H))
    return fields, winner


@pytest.mark.parametrize("grid,W,H,batch", [(32, 97, 61, 2), (64, 160, 120, 1)])
def test_vtx_resolve_sectors_equal_brute_force(grid, W, H, batch):
    fields, winner = _vtx_frame(grid, W, H, batch)
    assert bool(winner.any())
    want = _brute_sectors(winner.numpy(), grid * grid, _grid_vertices(grid))
    assert tvtx.resolve_sectors(fields, grid, winner) == want


def test_vtx_resolve_sectors_of_drawn_winners():
    """Winners drawn from a seed (any triangle at any pixel, a third
    uncovered) over a g48 grid of 3 frames."""
    grid, W, H = 48, 41, 29
    rng = np.random.default_rng(11)
    w = rng.integers(1, tvtx.n_triangles(grid) + 1, (3, H, W))
    w[rng.uniform(size=w.shape) < 0.33] = 0
    fields = torch.zeros((3, tvtx.FIELDS, grid * grid))
    want = _brute_sectors(w, grid * grid, _grid_vertices(grid))
    assert tvtx.resolve_sectors(fields, grid, torch.from_numpy(w).to(torch.int32)) == want


def test_resolve_sectors_of_uncovered_and_one_triangle_frames():
    grid = 16
    fields = torch.zeros((2, tvtx.FIELDS, grid * grid))
    idx = torch.from_numpy(jmesh.build_grid_xyuv(grid)[1].astype(np.int32).reshape(-1, 3))
    none = torch.zeros((2, 9, 13), dtype=torch.int32)
    assert tvtx.resolve_sectors(fields, grid, none) == 0
    assert tpacked.resolve_sectors(fields, idx, none) == 0
    # One triangle (the last row's last, tri1 = [B, C, D]) covers every
    # pixel of frame 1: its 3 corners in 6 planes, C and D in one sector.
    one = none.clone()
    one[1] = tvtx.n_triangles(grid)
    nv = grid * grid
    want = _brute_sectors(one.numpy(), nv, _grid_vertices(grid))
    assert tvtx.resolve_sectors(fields, grid, one) == want
    assert want == 6 * 2
    assert tpacked.resolve_sectors(fields, idx, one) == _brute_sectors(
        one.numpy(), nv, lambda tri: idx[tri].tolist(), index_rows=True)


@pytest.mark.parametrize("case", ["dem64", "soup"])
def test_packed_resolve_sectors_equal_brute_force(case):
    if case == "dem64":
        xyuv, tris, heights, view, proj, _ = _renderer_mesh(64, 64, 120, 90, 2)
        W, H = 120, 90
    else:
        rng = np.random.default_rng(5)
        n = 500
        xyuv = np.concatenate([rng.uniform(-60, 60, (n, 2)), rng.uniform(0, 1, (n, 2))],
                              axis=1).astype(np.float32)
        tris = rng.integers(0, n, (2000, 3)).astype(np.int32)
        heights = rng.uniform(-20, 20, (9, 11)).astype(np.float32)
        view = jcam.look_at_rh((-150, 110, 40), (0, 0, 0), (0, 1, 0))
        W, H = 97, 61
        proj = jcam.perspective_wgpu(np.float32(math.radians(45.0)), np.float32(W / H),
                                     np.float32(0.5), np.float32(1e4))
    fields = np.asarray(_jax_packed_fields(*(jnp.asarray(a) for a in (
        xyuv, tris, heights, view, proj)), W, H)[0])[None]
    fields, idx = torch.from_numpy(fields.copy()), torch.from_numpy(tris.copy())
    winner = tpacked.cover_big_plain(fields, idx, *tpacked.cover_plain(fields, idx, W, H))
    assert bool(winner.any())
    want = _brute_sectors(winner.numpy(), fields.shape[2], lambda tri: tris[tri].tolist(),
                          index_rows=True)
    assert tpacked.resolve_sectors(fields, idx, winner) == want


# ---------------- the plain resolves at ragged sizes, against JAX ----------------

SHADE = dict(colormap="terrain", h_range=1.0, exposure=1.1, sun=(0.35, 0.9, 0.2))


@pytest.mark.parametrize("W,H", [(97, 61), (33, 7)])
def test_plain_vtx_resolves_match_jax_at_ragged_sizes(W, H):
    """The plain g-buffer resolve against the JAX record route's g-buffer
    (jnp oracle) on the same post-VS fields, and the plain shaded resolve
    against the JAX shipped shader over that g-buffer."""
    grid = 40
    xyuv, _ = jmesh.build_grid_xyuv(grid)
    view = jcam.look_at_rh((2.4, 1.6, 2.2), (0, 0, 0), (0, 1, 0))
    proj = jcam.perspective_wgpu(np.float32(math.radians(45.0)), np.float32(W / H),
                                 np.float32(0.1), np.float32(100.0))
    f = _jax_vtx_fields(jnp.asarray(xyuv), jnp.zeros((1, 1), jnp.float32),
                        jnp.asarray(view), jnp.asarray(proj), W, H)
    f = np.stack([np.asarray(a) for a in f[:tvtx.FIELDS]])
    fields = torch.from_numpy(f[None].copy())
    winner = tvtx.cover_big_plain(fields, grid, *tvtx.cover_plain(fields, grid, W, H))
    got = tvtx.resolve_gbuffer_plain(fields, grid, winner)
    want = _jax_oracle(f, grid, W, H)
    assert 0 < int(got[3].sum()) < W * H
    assert_gbuffer_close([g[0] for g in got], want, f"vtx resolve {W}x{H}")
    lut, _ = jcmap.build_lut(SHADE["colormap"])
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    img = tvtx.resolve_shade_shipped_plain(fields, grid, winner, t(lut), t(SHADE["h_range"]),
                                           t(SHADE["exposure"]), t(SHADE["sun"]))
    ref = np.asarray(jfrag.terrain_fs(*(jnp.asarray(a) for a in want), jnp.asarray(lut),
                                      jnp.float32(SHADE["h_range"]),
                                      jnp.float32(SHADE["exposure"]),
                                      jnp.asarray(SHADE["sun"], jnp.float32)))
    img = img[0].view(torch.int32).numpy().view(np.uint32)
    assert_fs_policy(img, ref, f"vtx shaded resolve {W}x{H}")
    np.testing.assert_array_equal(img[~want[3]], ref[~want[3]])


@pytest.mark.parametrize("W,H", [(97, 61), (33, 7)])
def test_plain_packed_resolve_matches_k5_spec_at_ragged_sizes(W, H):
    """The plain indexed resolve on the plain cover's winners against K5's
    spec g-buffer of the same Renderer frame."""
    xyuv, tris, heights, view, proj, row_size = _renderer_mesh(20, 26, W, H, 0)
    fields, cols, bbox = _jax_packed_fields(*(jnp.asarray(a) for a in (
        xyuv, tris, heights, view, proj)), W, H)
    want = [np.asarray(a) for a in _jax_spec(cols, bbox, row_size, W, H)]
    fields = torch.from_numpy(np.asarray(fields)[None].copy())
    idx = torch.from_numpy(tris.copy())
    winner = tpacked.cover_big_plain(fields, idx, *tpacked.cover_plain(fields, idx, W, H))
    got = tpacked.resolve_gbuffer_plain(fields, idx, winner)
    assert 0 < int(got[3].sum()) < W * H
    assert_gbuffer_close([g[0] for g in got], want, f"packed resolve {W}x{H}")
