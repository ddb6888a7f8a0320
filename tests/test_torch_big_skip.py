"""The big-triangle kernels' rejects and their torch mirror
(``vtx.big_tile_walk``; CPU).

``vf_vtx_cover_big`` and ``vf_packed_cover_big`` (csrc/raster_common.cuh,
``vf::big_walk``) reject a listed triangle, and otherwise each 16x16 tile of
its bbox, where one functional of the coverage test is below zero by more
than its f32 error bound at all four corner pixel centres, and walk only
the surviving tiles. ``vtx.big_tile_walk`` does the same f64 ops;
test_torch_cuda.py holds the kernels' per-entry walk counts to it on the
card. Here, exactly:
- conservative: every (listed triangle, pixel) pair the plain deposit
  covers lies in a tile the mirror keeps -- at close-in and w-crossing
  cameras over a grid and a DEM, for random triangles with w-crossing
  corners, slivers, coordinates near +-1e9 and huge 1/w columns, and for a
  record with a non-finite column, which keeps every tile;
- an off-frustum w-crossing triangle (a full-screen bbox) is rejected whole;
- depositing only the kept tiles gives the plain big pass's winner plane
  bit for bit, and the resolved g-buffer matches the JAX package's CPU
  raster at a w-crossing camera (masks exact, varyings <= 1e-5*max(1,|x|),
  XLA:CPU contracting multiply-adds as the port's ``mad`` does).
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from vulkan_forge import _mesh as jmesh
from vulkan_forge._raster import setup as jsetup, tiles as jtiles

import vulkan_forge_torch as vt
from vulkan_forge_torch import _camera, _mesh, _renderer
from vulkan_forge_torch._parity import assert_gbuffer_close
from vulkan_forge_torch._raster import kernels, packed, setup, vtx
from vulkan_forge_torch._raster.tiles import eval_records

torch.set_num_threads(1)

W, H = 160, 120
BT = vtx.BIG_TILE


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _proj(near, width=W, height=H):
    return _camera.perspective_wgpu(np.float32(math.radians(60)), np.float32(width / height),
                                    np.float32(near), np.float32(1e4))


def _grid_case(grid, wcross):
    """The spike grid at a close-in camera or at one inside the relief whose
    near plane (0.001) lies closer than a cell, so that valid triangles
    cross w = 0 (chip_smoke's special_cameras)."""
    xyuv, _ = _mesh.build_grid_xyuv(grid)
    eye, target, near = (((0.0, 0.9, 0.0), (1.5, -0.2, 1.5), 0.001) if wcross
                         else ((0.6, 0.45, 0.5), (0, 0, 0), 0.1))
    view = _camera.look_at_rh(eye, target, (0, 1, 0))
    f = vtx.vs_fields(_t(xyuv), _t(np.zeros((1, 1))), _t(view[None]), _t(_proj(near)[None]),
                      _t(1.0), _t(1.0), W, H)
    return f, (lambda fr, tr: vtx.tri_corners(f, grid, fr, tr)), vtx.n_triangles(grid), \
        vtx.cover_plain(f, grid, W, H)


def _dem_case(n, wcross):
    """A Renderer DEM n x n (30 m cells) from 300 m above its centre, near
    0.1, or from 5 m above it, near 0.001 (chip_smoke's
    special_dem_cameras), on the indexed route."""
    rng = np.random.default_rng(n)
    y, x = np.mgrid[0:n, 0:n] / np.float32(n)
    dem = sum(rng.uniform(100, 400) * np.sin(2 * math.pi * (rng.uniform(1, 3) * x
                                                            + rng.uniform(1, 3) * y
                                                            + rng.uniform()))
              for _ in range(4)).astype(np.float32)
    r = vt.Renderer(W, H, device="cpu")
    r.add_terrain(dem, (30.0, 30.0), 1.5, "terrain")
    xyuv, tris = _renderer.grid_mesh(n, n, 30.0, 30.0, "cpu")
    h0 = float(r._terrain.heights[n // 2, n // 2])
    above, near, target = ((5.0, 0.001, (3000.0, h0 - 100.0, 2500.0)) if wcross
                           else (300.0, 0.1, (-3000.0, h0 - 400.0, -2000.0)))
    view = _camera.look_at_rh((0.0, h0 + above, 0.0), target, (0.0, 1.0, 0.0))
    f = vtx.vs_fields(xyuv, _t(r._terrain.heights), _t(view[None]), _t(_proj(near)[None]),
                      _t(1.0), _t(1.0), W, H, "extended")
    return f, (lambda fr, tr: packed.tri_corners(f, tris, fr, tr)), tris.shape[0], \
        packed.cover_plain(f, tris, W, H)


CASES = {"g64 close-in": lambda: _grid_case(64, False),
         "g64 w-crossing": lambda: _grid_case(64, True),
         "DEM-64 close-in": lambda: _dem_case(64, False),
         "DEM-64 w-crossing": lambda: _dem_case(64, True)}


def _covered(cols, px0, px1, py0, py1):
    """(owner, x, y) of every bbox pixel that the inclusive coverage test
    covers, over every pixel of each bbox (the plain deposit's pairs)."""
    bw = (px1 - px0 + 1).long()
    npix = bw * (py1 - py0 + 1).long()
    owner = torch.repeat_interleave(torch.arange(npix.numel()), npix)
    k = torch.arange(owner.numel()) - (torch.cumsum(npix, 0) - npix)[owner]
    x = px0[owner].long() + k % bw[owner]
    y = py0[owner].long() + torch.div(k, bw[owner], rounding_mode="floor")
    cov = eval_records(lambda j: cols[j][owner], x.float() + 0.5, y.float() + 0.5)[4]
    return owner[cov], x[cov], y[cov]


def _tile_keys(owner, x, y, px0, py0, px1):
    """One int64 key per (triangle, tile of its bbox) holding pixel (x, y)."""
    ntx = torch.div(px1 - px0 + BT, BT, rounding_mode="floor").long()[owner]
    tx = torch.div(x - px0[owner].long(), BT, rounding_mode="floor")
    ty = torch.div(y - py0[owner].long(), BT, rounding_mode="floor")
    return owner * (1 << 32) + ty * ntx + tx


def _assert_conservative(cols, px0, px1, py0, py1):
    """Every covered pair lies in a kept tile; returns (kept tiles, covered
    pairs, walked pairs)."""
    owner, x0, x1, y0, y1 = vtx.big_tile_walk(cols, px0, px1, py0, py1)
    assert bool(((x1 - x0 < BT) & (y1 - y0 < BT) & (x0 <= x1) & (y0 <= y1)).all())
    kept = torch.unique(_tile_keys(owner, x0, y0, px0, py0, px1))
    assert kept.numel() == owner.numel()
    c_owner, cx, cy = _covered(cols, px0, px1, py0, py1)
    need = torch.unique(_tile_keys(c_owner, cx, cy, px0, py0, px1))
    missing = need[~torch.isin(need, kept)]
    assert missing.numel() == 0, f"{missing.numel()} covered tiles rejected"
    return owner.numel(), c_owner.numel(), int(((x1 - x0 + 1) * (y1 - y0 + 1)).sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_mirror_keeps_every_covered_pair(case):
    f, corners_of, T, (_, big, count) = CASES[case]()
    cols, px0, px1, py0, py1, _, _ = vtx.listed_setup(corners_of, T, big, count, W, H)
    assert px0.numel() > 0, "the camera must exercise the big-triangle pass"
    _, covered, walked = _assert_conservative(cols, px0, px1, py0, py1)
    bbox_pairs = int(((px1 - px0 + 1).long() * (py1 - py0 + 1).long()).sum())
    assert covered > 0 and covered <= walked <= bbox_pairs
    if "w-crossing" in case:
        # Full-screen bboxes: the rejects must leave a small share of them.
        assert walked * 10 < bbox_pairs


def _random_corners(rng, mode, n):
    """Three corners (lists of 7 (1, n) f32 tensors: x_fb, y_fb, w, v0..v2,
    z_ndc) of n random triangles of a W x H frame, shaped by ``mode``."""
    def pos():
        return rng.uniform(-40, 90, n)

    corners = []
    for j in range(3):
        x, y = pos(), pos()
        w = rng.choice([-1, 1], n) * 10.0 ** rng.uniform(-3, 0.5, n)
        zn = rng.uniform(-0.5, 1.5, n)
        v = [rng.uniform(-100, 100, n) for _ in range(3)]
        if mode == "wcross":
            w = np.abs(w) * (1 if j else -1) * rng.choice([-1, 1], n)
        if mode == "far":
            big = rng.random(n) < 0.5
            x = np.where(big, rng.choice([-1, 1], n) * rng.uniform(0.5e9, 1e9, n), x)
            y = np.where(rng.random(n) < 0.3, rng.choice([-1, 1], n) * 1e9, y)
        if mode == "huge_rw":
            tiny = rng.choice([-1, 1], n) * 10.0 ** rng.uniform(-14, -9, n)
            w = np.where(rng.random(n) < 0.5, tiny, w)
            zn = np.where(rng.random(n) < 0.3, rng.uniform(-1e12, 1e12, n), zn)
            v = [a * 10.0 ** rng.uniform(0, 6, n) for a in v]
        corners.append([x, y, w, *v, zn])
    if mode == "sliver":
        # Corner 2 just off the line through corners 0 and 1.
        s = rng.uniform(-0.5, 1.5, n)
        for k in (0, 1):
            corners[2][k] = (corners[0][k] + s * (corners[1][k] - corners[0][k])
                             + rng.uniform(-1e-3, 1e-3, n))
    return [[torch.from_numpy(np.asarray(a, dtype=np.float32)[None]) for a in c]
            for c in corners]


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**32 - 1),
       mode=st.sampled_from(["wcross", "far", "huge_rw", "sliver", "mixed"]))
def test_mirror_is_conservative_on_random_triangles(seed, mode):
    w, h = 48, 40
    rng = np.random.default_rng(seed)
    c = _random_corners(rng, mode, 96)
    cols, px0, px1, py0, py1, valid = setup.setup_fields_core(*c, w, h)
    sel = valid.reshape(-1)
    if not bool(sel.any()):
        return
    cols = [col.reshape(-1)[sel] for col in cols]
    _assert_conservative(cols, *(p.reshape(-1)[sel] for p in (px0, px1, py0, py1)))


def _off_frustum(v0=0.0):
    """A valid triangle that crosses the eye's plane 30 units to the side of
    a camera with near 0.001 (so no part of it is in the frustum): its
    setup (cols, px0, px1, py0, py1), a full-screen bbox. ``v0``: the first
    corner's first varying."""
    proj = torch.from_numpy(_proj(0.001))
    pts = torch.tensor([[30.0, 0.0, -0.5, 1.0], [30.0, 1.0, 0.5, 1.0], [31.0, 0.5, 0.2, 1.0]])
    clip = pts @ proj.T
    x, y, z, wc = setup.clip_to_fb(clip, W, H)
    for order in ((0, 1, 2), (0, 2, 1)):
        c = [[x[i:i + 1, None], y[i:i + 1, None], wc[i:i + 1, None],
              torch.full((1, 1), v0 if i == 0 else 0.0), torch.zeros(1, 1), torch.zeros(1, 1),
              z[i:i + 1, None]] for i in order]
        cols, px0, px1, py0, py1, valid = setup.setup_fields_core(*c, W, H)
        if bool(valid.all()):
            return [col.reshape(-1) for col in cols], *(p.reshape(-1) for p in (px0, px1, py0, py1))
    raise AssertionError("neither winding is valid")


def test_off_frustum_triangle_is_rejected_whole():
    cols, px0, px1, py0, py1 = _off_frustum()
    assert (int(px0), int(px1), int(py0), int(py1)) == (0, W - 1, 0, H - 1)
    assert _covered(cols, px0, px1, py0, py1)[0].numel() == 0
    assert bool(vtx._rejected([c.double() for c in cols], px0.long(), px1.long(),
                              py0.long(), py1.long()).all())
    assert vtx.big_tile_walk(cols, px0, px1, py0, py1)[0].numel() == 0


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_non_finite_record_keeps_every_tile(bad):
    cols, px0, px1, py0, py1 = _off_frustum(bad)
    assert not bool(torch.isfinite(cols[12]).all())
    owner = vtx.big_tile_walk(cols, px0, px1, py0, py1)[0]
    assert owner.numel() == math.ceil(W / BT) * math.ceil(H / BT)
    _assert_conservative(cols, px0, px1, py0, py1)


def _kept_tile_winner(corners_of, T, winner, big, count):
    """The big pass over the mirror's kept tiles only (each tile deposited
    as a bbox of its own)."""
    _, height, width = winner.shape
    cols, px0, px1, py0, py1, frame, tri = vtx.listed_setup(corners_of, T, big, count,
                                                            width, height)
    owner, x0, x1, y0, y1 = vtx.big_tile_walk(cols, px0, px1, py0, py1)
    return vtx._deposit(winner, [c[owner] for c in cols], x0, x1, y0, y1, frame[owner],
                        tri[owner])


@pytest.mark.parametrize("case", sorted(CASES))
def test_kept_tiles_give_the_plain_winners(case):
    f, corners_of, T, (winner, big, count) = CASES[case]()
    want = vtx.cover_big_from_corners(corners_of, T, winner.clone(), big, count)
    got = _kept_tile_winner(corners_of, T, winner.clone(), big, count)
    assert torch.equal(got, want)
    assert not torch.equal(want, winner), "the big pass must paint some pixel"


@pytest.mark.parametrize("route", ["vtx", "packed"])
def test_wrapper_walk_counts_on_cpu(route):
    """The wrappers' optional ``walked`` output (CPU: the mirror's tiles per
    list entry, in list order), and their checks of it."""
    if route == "vtx":
        grid = 64
        f, corners_of, T, (winner, big, count) = _grid_case(grid, True)
        call = lambda w, walked: kernels.vtx_cover_big(f, grid, w, big, count, walked)
    else:
        f, corners_of, T, (winner, big, count) = _dem_case(64, True)
        idx = _renderer.grid_mesh(64, 64, 30.0, 30.0, "cpu")[1]
        call = lambda w, walked: kernels.packed_cover_big(f, idx, w, big, count, walked)
    walked = torch.full_like(big, -1)
    got = call(winner.clone(), walked)
    k = int(count[0])
    cols, px0, px1, py0, py1, _, _ = vtx.listed_setup(corners_of, T, big, count, W, H)
    owner = vtx.big_tile_walk(cols, px0, px1, py0, py1)[0]
    assert torch.equal(walked[:k], torch.bincount(owner, minlength=k).to(torch.int32))
    assert bool((walked[k:] == -1).all()) and int(walked[:k].sum()) > 0
    assert torch.equal(got, vtx.cover_big_from_corners(corners_of, T, winner.clone(), big, count))
    with pytest.raises(ValueError, match="walked must be contiguous 1-D int32"):
        call(winner.clone(), walked.long())
    with pytest.raises(ValueError, match="walked must hold"):
        call(winner.clone(), walked[:-1])


def _jax_oracle(f, grid, width, height):
    """The JAX package's CPU raster (jnp tiles) of one frame's fields."""
    _, idx = jmesh.build_grid_xyuv(grid)
    indices = jnp.asarray(idx.astype(np.int32).reshape(-1, 3))
    x, y, w, z = (jnp.asarray(f[k]) for k in (0, 1, 2, 6))
    records, bbox = jsetup.triangle_setup(x, y, z, w, jnp.asarray(f[3:6].T), indices,
                                          width, height)
    cap = int(jsetup.tile_counts(bbox, width, height).max())
    sx, sy = jsetup.tile_span_max(bbox, width, height)
    binning = jsetup.bin_triangles(bbox, width, height, max(cap, 8), span_x=int(sx),
                                   span_y=int(sy))
    return [np.asarray(a) for a in jtiles.render_gbuffer(records, binning.tile_lists,
                                                         width, height)]


def test_w_crossing_gbuffer_matches_jax_oracle():
    """At a w-crossing camera (grid 40, 128x96), the port's plain vtx
    g-buffer, and the one resolved from the kept tiles alone, match the JAX
    package's CPU raster."""
    grid, width, height = 40, 128, 96
    xyuv, _ = _mesh.build_grid_xyuv(grid)
    view = _camera.look_at_rh((0.1, 0.85, -0.1), (-1.4, -0.1, 1.6), (0, 1, 0))
    f = vtx.vs_fields(_t(xyuv), _t(np.zeros((1, 1))), _t(view[None]),
                      _t(_proj(0.001, width, height)[None]), _t(1.0), _t(1.0), width, height)
    winner, big, count = vtx.cover_plain(f, grid, width, height)
    corners = setup.grid_corners([f[:, k] for k in range(vtx.FIELDS)], grid)
    valid = setup.setup_fields_core(*corners, width, height)[5]
    clean = (corners[0][2] > 1e-8) & (corners[1][2] > 1e-8) & (corners[2][2] > 1e-8)
    assert bool((valid & ~clean).any()), "the camera must give valid w-crossing triangles"
    want = _jax_oracle(f[0].numpy(), grid, width, height)
    plain = vtx.render_gbuffer_vtx_batch(f, grid, width, height)
    corners_of = lambda fr, tr: vtx.tri_corners(f, grid, fr, tr)
    kept = vtx.resolve_gbuffer_plain(f, grid, _kept_tile_winner(
        corners_of, vtx.n_triangles(grid), winner, big, count))
    for got in (plain, kept):
        assert bool(got[3].any())
        assert_gbuffer_close([g[0] for g in got], want, "w-crossing g40 vs JAX")
        assert np.array_equal(got[3][0].numpy(), want[3])
