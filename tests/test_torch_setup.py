"""Vertex stage, triangle setup and binning of the PyTorch port (CPU).

Setup is compared on IDENTICAL clip coordinates: the JAX vertex stage's
output is fed to both packages' ``clip_to_fb`` -> ``triangle_setup``, so
the comparison isolates setup. Tolerances:
- bboxes and valid flags: exact;
- record columns 0..30: |d| <= 1e-5 * max(1, |x|) (XLA:CPU contracts the
  multiply-adds of the area and crossing terms, the port rounds twice);
- the vertex stage itself: sin/cos differ by ulps between jax-CPU and
  torch-CPU, so its outputs get a tolerance; its matrix products, fed the
  same world coordinates, are bit-equal to XLA's dot.
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vulkan_forge import _camera as jcam, _mesh as jmesh
from vulkan_forge._raster import setup as jsetup, transform as jtrans

from vulkan_forge_torch._raster import setup as tsetup, transform as ttrans

# The plain raster is a loop of small eager ops: one intra-op thread is the
# fastest setting on the CPU and keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)

RTOL = 1e-5

# (grid, W, H, eye, target, fovy, znear, zfar, height texture seed or None)
CASES = {
    "spike_default_g128_800x600": (128, 800, 600, (3.0, 2.0, 3.0), (0, 0, 0), 45.0, 0.1, 100.0, None),
    "golden_cam_g16_128x96": (16, 128, 96, (2.0, 1.5, 2.5), (0, 0, 0), 50.0, 0.1, 50.0, None),
    "heights_g32_160x120": (32, 160, 120, (1.0, 2.5, 3.5), (0, 0, 0), 45.0, 0.1, 100.0, 7),
    # Low cameras in the relief (cf. tests/test_clipping.py:198-206):
    # triangles crossing the near plane, and triangles crossing w = 0
    # (vertices behind the eye; conservative full-screen bboxes).
    "near_cross_g48_160x120": (48, 160, 120, (0.15, 0.7, 0.1), (1.5, -0.2, 1.5), 60.0, 0.5, 100.0, None),
    "w_cross_g12_160x120": (12, 160, 120, (0.0, 0.9, 0.0), (1.5, -0.2, 1.5), 60.0, 0.1, 100.0, None),
}


def _scene(case):
    grid, W, H, eye, target, fovy, zn, zf, hseed = CASES[case]
    xyuv, idx = jmesh.build_grid_xyuv(grid)
    view = jcam.look_at_rh(eye, target, (0, 1, 0))
    proj = jcam.perspective_wgpu(np.float32(math.radians(fovy)), np.float32(W / H),
                                 np.float32(zn), np.float32(zf))
    if hseed is None:
        heights = np.zeros((1, 1), np.float32)
    else:
        heights = np.random.default_rng(hseed).uniform(-0.3, 0.3, (33, 45)).astype(np.float32)
    return xyuv, idx.astype(np.int64).reshape(-1, 3), heights, view, proj, W, H


@jax.jit
def _jax_vs_jit(xyuv, heights, view, proj):
    return jtrans.terrain_vs(xyuv, heights, view, proj, jnp.float32(1.0), jnp.float32(1.0))


def _jax_vs(xyuv, heights, view, proj):
    clip, vary = _jax_vs_jit(*(jnp.asarray(a) for a in (xyuv, heights, view, proj)))
    return np.asarray(clip), np.asarray(vary)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _jax_setup(clip, vary, idx, W, H):
    x, y, z, w = jsetup.clip_to_fb(clip, W, H)
    recs, bbox = jsetup.triangle_setup(x, y, z, w, vary, idx, W, H)
    return (x, y, z, w), recs, bbox


@pytest.mark.parametrize("case", sorted(CASES))
def test_terrain_vs_matches(case):
    xyuv, _, heights, view, proj, _, _ = _scene(case)
    clip_j, vary_j = _jax_vs(xyuv, heights, view, proj)
    t = torch.from_numpy
    clip_t, vary_t = ttrans.terrain_vs(t(xyuv), t(heights), t(view), t(proj),
                                       torch.tensor(1.0), torch.tensor(1.0))
    np.testing.assert_allclose(vary_t.numpy(), vary_j, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(clip_t.numpy(), clip_j, rtol=1e-5, atol=1e-5)
    # Batched cameras give the per-camera rows.
    clip_b, _ = ttrans.terrain_vs(t(xyuv), t(heights), t(np.stack([view, view])),
                                  t(np.stack([proj, proj])), torch.tensor(1.0),
                                  torch.tensor(1.0))
    assert torch.equal(clip_b[0], clip_t) and torch.equal(clip_b[1], clip_t)


def test_vertex_matrix_products_bit_equal_xla():
    """Fed identical world coordinates, the port's written-out 4x4
    products give the bits of XLA:CPU's ``(world @ view.T) @ proj.T``."""
    xyuv, _, _, view, proj, _, _ = _scene("spike_default_g128_800x600")
    h = np.random.default_rng(0).uniform(-0.5, 0.5, xyuv.shape[0]).astype(np.float32)
    world = np.stack([xyuv[:, 0], h, xyuv[:, 1], np.ones_like(h)], -1)
    want = np.asarray((jnp.asarray(world) @ jnp.asarray(view).T) @ jnp.asarray(proj).T)
    w = [torch.from_numpy(np.ascontiguousarray(world[:, k])) for k in range(4)]
    got = torch.stack(ttrans._rows_times_mt(
        ttrans._rows_times_mt(w, torch.from_numpy(view)), torch.from_numpy(proj)), -1)
    np.testing.assert_array_equal(got.numpy(), want)


def _setup_both(case):
    xyuv, idx, heights, view, proj, W, H = _scene(case)
    clip, vary = _jax_vs(xyuv, heights, view, proj)
    (xj, yj, zj, wj), recs_j, bbox_j = _jax_setup(
        jnp.asarray(clip), jnp.asarray(vary), jnp.asarray(idx.astype(np.int32)), W, H)
    xt, yt, zt, wt = tsetup.clip_to_fb(torch.from_numpy(clip.copy()), W, H)
    recs_t, bbox_t = tsetup.triangle_setup(xt, yt, zt, wt, torch.from_numpy(vary.copy()),
                                           torch.from_numpy(idx), W, H)
    fb = ([np.asarray(a) for a in (xj, yj, zj, wj)], [a.numpy() for a in (xt, yt, zt, wt)])
    return np.asarray(recs_j), np.asarray(bbox_j), recs_t.numpy(), bbox_t.numpy(), fb


@pytest.mark.parametrize("case", sorted(CASES))
def test_triangle_setup_matches(case):
    recs_j, bbox_j, recs_t, bbox_t, (fb_j, fb_t) = _setup_both(case)
    for a, b in zip(fb_t, fb_j):
        np.testing.assert_array_equal(a, b)           # viewport transform: exact
    assert recs_t.shape == recs_j.shape and recs_t.dtype == np.float32
    assert bbox_t.dtype == np.int32
    np.testing.assert_array_equal(bbox_t, bbox_j)
    np.testing.assert_array_equal(recs_t[:, 24], recs_j[:, 24])   # valid flags
    d = np.abs(recs_t[:, :31].astype(np.float64) - recs_j[:, :31])
    assert np.all(d <= RTOL * np.maximum(1.0, np.abs(recs_j[:, :31]))), d.max()
    assert not np.any(recs_t[:, 31:]) and not np.any(recs_t[-1])   # spare cols, sentinel
    # The clipping cases exercise what they are meant to.
    valid = recs_j[:-1, 24] > 0
    if case.startswith("near_cross"):
        assert np.any(valid & np.any(recs_j[:-1, 25:28] < 0, axis=1))
    if case.startswith("w_cross"):
        full = np.all(bbox_j == [0, 159, 0, 119], axis=1)
        assert np.any(valid & full) and np.any(fb_j[3] <= 0)


def _brute_force_lists(bbox, width, height, tile):
    """{(frame, tile): [ids]} from every valid bbox overlapping every tile."""
    ntx, nty = -(-width // tile), -(-height // tile)
    out = []
    for b in range(bbox.shape[0]):
        x0, x1, y0, y1 = (bbox[b, :, k] for k in range(4))
        valid = x1 >= x0
        for ty in range(nty):
            rows_ok = valid & (y0 <= ty * tile + tile - 1) & (y1 >= ty * tile)
            for tx in range(ntx):
                hit = rows_ok & (x0 <= tx * tile + tile - 1) & (x1 >= tx * tile)
                out.append(np.nonzero(hit)[0])
    return out


@pytest.mark.parametrize("case", ["golden_cam_g16_128x96", "heights_g32_160x120",
                                  "near_cross_g48_160x120", "w_cross_g12_160x120"])
def test_bin_tiles_matches_brute_force(case):
    xyuv, idx, heights, view, proj, W, H = _scene(case)
    views = np.stack([view, jcam.look_at_rh((-2.0, 1.0, 2.5), (0, 0, 0), (0, 1, 0))])
    t = torch.from_numpy
    clip, vary = ttrans.terrain_vs(t(xyuv), t(heights), t(views), t(np.stack([proj, proj])),
                                   torch.tensor(1.0), torch.tensor(1.0))
    x, y, z, w = tsetup.clip_to_fb(clip, W, H)
    _, bbox = tsetup.triangle_setup(x, y, z, w, vary, t(idx), W, H)
    T = bbox.shape[1]
    binning = tsetup.bin_tiles(bbox, W, H)
    assert binning.rows.dtype == torch.int32 and binning.offsets.dtype == torch.int32
    rows, offs = binning.rows.numpy(), binning.offsets.numpy()
    want = _brute_force_lists(bbox.numpy(), W, H, tsetup.TILE)
    assert len(offs) == len(want) + 1 and offs[0] == 0
    ntiles = len(want) // 2
    for k, ids in enumerate(want):
        frame = k // ntiles
        got = rows[offs[k]:offs[k + 1]] - frame * (T + 1)
        np.testing.assert_array_equal(got, ids)
    assert offs[-1] == sum(len(i) for i in want) > 0


def test_bin_tiles_single_frame_and_empty():
    bbox = torch.tensor([[0, 40, 0, 20], [5, 4, 0, 3], [17, 17, 31, 31]], dtype=torch.int32)
    b = tsetup.bin_tiles(bbox, 48, 32)          # 3 x 2 tiles; triangle 1 invalid
    assert b.offsets.tolist() == [0, 1, 2, 3, 4, 6, 7]
    assert b.rows.tolist() == [0, 0, 0, 0, 0, 2, 0]
    none = tsetup.bin_tiles(torch.tensor([[9, 1, 9, 1]], dtype=torch.int32), 48, 32)
    assert none.rows.numel() == 0 and none.offsets.tolist() == [0] * 7
