"""The port's indexed-mesh route (``_raster/packed.py``) against the JAX
package's K5 spec and the port's record route (CPU).

On the CPU every packed wrapper runs its plain PyTorch version, which is
the specification ``csrc/packed.cu`` is held to on the card
(test_torch_cuda.py). Inputs are made in the JAX package: its extended
vertex stage and ``pipeline._terrain_cols`` (the columns K5 packs) for the
spec, and the same post-VS fields, carried across as numpy, for the port.
Tolerances:
- against ``packed.render_gbuffer_packed_ref`` (K5's pure-jnp spec): masks
  exact, varyings |d| <= 1e-5 * max(1, |x|);
- against the port's record route (setup.setup_cols + tiles.py) on the
  same fields: bit for bit, the two routes being independent code.
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vulkan_forge as vf
from vulkan_forge import _mesh as jmesh
from vulkan_forge._raster import packed as jpacked, pipeline as jpipe
from vulkan_forge._raster import setup as jsetup, transform as jtrans

from vulkan_forge_torch import _camera as tcam
from vulkan_forge_torch._parity import assert_gbuffer_close
from vulkan_forge_torch._raster import kernels, packed as tpacked, pipeline as tpipe
from vulkan_forge_torch._raster import setup as tsetup, tiles as ttiles, vtx as tvtx

# The plain raster is a loop of small eager ops: one intra-op thread is the
# fastest setting on the CPU and keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)


def _dem(rows, cols, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:rows, 0:cols] / np.float32(max(rows, cols))
    h = sum(rng.uniform(5, 20) * np.sin(2 * math.pi * (rng.uniform(1, 3) * x
                                                       + rng.uniform(1, 3) * y + rng.uniform()))
            for _ in range(4))
    return h.astype(np.float32)


def _renderer_mesh(rows, cols, W, H, seed):
    """A JAX Renderer's DEM frame: (xyuv, flipped int32 triangles, heights,
    view, proj) as ``vulkan_forge/_renderer.py:271-283`` builds them."""
    r = vf.Renderer(W, H)
    r.add_terrain(_dem(rows, cols, seed), (10.0, 12.0), 1.5, "terrain")
    terr = r._terrain
    xy, uv, idx = jmesh.make_grid(terr.width, terr.height, *terr.spacing)
    xyuv = np.concatenate([xy, uv], axis=1).astype(np.float32)
    tris = np.ascontiguousarray(np.asarray(idx, np.int32).reshape(-1, 3)[:, [0, 2, 1]])
    view, proj = r._default_terrain_camera(terr)
    return xyuv, tris, terr.heights, view, proj, 2 * (cols - 1)


def _camera(eye, target, fovy, znear, W, H):
    view = tcam.look_at_rh(eye, target, (0, 1, 0))
    proj = tcam.perspective_wgpu(np.float32(math.radians(fovy)), np.float32(W / H),
                                 np.float32(znear), np.float32(1e4))
    return view, proj


def _case(name):
    """(xyuv, tris, heights, view, proj, row_size, W, H) of a named case."""
    if name == "dem_renderer_cam":
        return (*_renderer_mesh(20, 26, 96, 72, 0), 96, 72)
    if name == "soup":
        # Arbitrary geometry, as K5 takes it: random vertices and a random
        # index buffer (back-facing, slivers and shared vertices included).
        rng = np.random.default_rng(3)
        n, t = 400, 1500
        xyuv = np.concatenate([rng.uniform(-60, 60, (n, 2)), rng.uniform(0, 1, (n, 2))],
                              axis=1).astype(np.float32)
        tris = rng.integers(0, n, (t, 3)).astype(np.int32)
        heights = rng.uniform(-20, 20, (9, 11)).astype(np.float32)
        return (xyuv, tris, heights, *_camera((-150, 110, 40), (0, 0, 0), 45.0, 0.5, 120, 90),
                t, 120, 90)
    xyuv, tris, heights, _, _, rs = _renderer_mesh(24, 24, 128, 96, 1)
    if name == "close_in":
        # Near the surface: cells span many pixels (the big-triangle pass).
        return (xyuv, tris, heights, *_camera((40, 60, 30), (-60, 0, -40), 60.0, 0.1, 128, 96),
                rs, 128, 96)
    # w_crossing: eye inside the relief, near plane closer than a cell, so
    # valid triangles cross w = 0 (full-screen bboxes) and the near plane.
    return (xyuv, tris, heights, *_camera((0, 15, 0), (100, -5, 90), 60.0, 0.001, 128, 96),
            rs, 128, 96)


CASES = ["dem_renderer_cam", "close_in", "w_crossing", "soup"]


@functools.partial(jax.jit, static_argnums=(5, 6))
def _jax_fields(xyuv, tris, heights, view, proj, W, H):
    """The JAX extended vertex stage's post-VS fields (pipeline.py:225-233)
    and K5's setup columns (``_terrain_cols``)."""
    x, z = xyuv[:, 0], xyuv[:, 1]
    h = jtrans.sample_height_nearest(heights, xyuv[:, 2:4])
    world = jnp.stack([x, h, z, jnp.ones_like(x)], axis=-1)
    xf, yf, zf, wf = jsetup.clip_to_fb((world @ view.T) @ proj.T, W, H)
    cols, bbox = jpipe._terrain_cols(xyuv, tris, heights, view, proj, jnp.float32(1.0),
                                     jnp.float32(1.0), W, H, "extended")
    return jnp.stack([xf, yf, wf, h, xyuv[:, 2], xyuv[:, 3], zf]), cols, bbox


_jax_spec = jax.jit(jpacked.render_gbuffer_packed_ref, static_argnums=(2, 3, 4))


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """(port fields (1, 7, N), int32 indices, W, H) and K5's spec g-buffer."""
    xyuv, tris, heights, view, proj, row_size, W, H = _case(name)
    fields, cols, bbox = _jax_fields(*(jnp.asarray(a) for a in (xyuv, tris, heights, view,
                                                                 proj)), W, H)
    spec = [np.asarray(a) for a in _jax_spec(cols, bbox, row_size, W, H)]
    return np.asarray(fields)[None], tris, W, H, spec


def _port(name):
    f, tris, W, H, _ = _inputs(name)
    return torch.from_numpy(f.copy()), torch.from_numpy(tris.copy()), W, H


def _record_route(fields, indices, W, H):
    """The port's slice-1 plain record route on the same fields."""
    records, bbox = tsetup.triangle_setup(
        fields[:, 0], fields[:, 1], fields[:, 6], fields[:, 2],
        fields[:, 3:6].transpose(1, 2), indices.to(torch.long), W, H)
    return ttiles.render_gbuffer(records.reshape(-1, tsetup.REC_WIDTH),
                                 tsetup.bin_tiles(bbox, W, H), fields.shape[0], W, H)


# ---------------- (a) the kernel function against K5's spec ----------------

@pytest.mark.parametrize("name", CASES)
def test_plain_indexed_gbuffer_matches_k5_spec(name):
    fields, indices, W, H = _port(name)
    got = tpacked.render_gbuffer_packed_batch(fields, indices, W, H)
    assert got[3].dtype == torch.bool and tuple(got[0].shape) == (1, H, W)
    assert 0 < int(got[3].sum()) < H * W
    assert_gbuffer_close([g[0] for g in got], _inputs(name)[4], name)


@pytest.mark.parametrize("name", CASES)
def test_plain_indexed_gbuffer_equals_record_route(name):
    fields, indices, W, H = _port(name)
    winner, big, count = kernels.packed_cover(fields, indices, W, H)
    if name in ("close_in", "w_crossing"):
        assert int(count[0]) > 0, "the camera must exercise the big-triangle pass"
    corners = tsetup.indexed_corners([fields[:, f] for f in range(tvtx.FIELDS)], indices)
    valid = tsetup.setup_fields_core(*corners, W, H)[5]
    clean = (corners[0][2] > 1e-8) & (corners[1][2] > 1e-8) & (corners[2][2] > 1e-8)
    if name == "w_crossing":
        assert bool((valid & ~clean).any()), "no valid triangle crosses w = 0"
    got = tpacked.render_gbuffer_packed_batch(fields, indices, W, H)
    for a, b in zip(got, _record_route(fields, indices, W, H)):
        assert torch.equal(a, b)


def test_batch_of_frames_equals_single_frames():
    """Frames are independent: a batch of two renders each as alone."""
    a, indices, W, H = _port("close_in")
    b = _port("w_crossing")[0]
    both = tpacked.render_gbuffer_packed_batch(torch.cat([a, b]), indices, W, H)
    for k, f in enumerate((a, b)):
        for x, y in zip(both, tpacked.render_gbuffer_packed_batch(f, indices, W, H)):
            assert torch.equal(x[k], y[0])


# ---------------- (b) the helpers and the big-triangle split ----------------

@pytest.mark.parametrize("seed", [0, 1])
def test_indexed_corners_feed_setup_cols(seed):
    """Corners in index order give setup_cols's 31 columns bit for bit,
    for int32 and int64 index buffers, and tri_corners reads the same."""
    rng = np.random.default_rng(seed)
    n, t = 50, 120
    fields = [torch.from_numpy(rng.uniform(-50, 250, (2, n)).astype(np.float32))
              for _ in range(tvtx.FIELDS)]
    fields[2] = torch.from_numpy(rng.uniform(-0.5, 3.0, (2, n)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n, (t, 3)).astype(np.int32))
    cols, _ = tsetup.setup_cols(fields[0], fields[1], fields[6], fields[2],
                                torch.stack(fields[3:6], dim=-1), idx.long(), 64, 48)
    for indices in (idx, idx.long()):
        got = tsetup.setup_fields_core(*tsetup.indexed_corners(fields, indices), 64, 48)[0]
        for a, b in zip(got, cols):
            assert torch.equal(torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0))
    frame = torch.arange(2).repeat_interleave(t)
    tri = torch.arange(t).repeat(2)
    decoded = tpacked.tri_corners(torch.stack(fields, dim=1), idx, frame, tri)
    for j, corner in enumerate(tsetup.indexed_corners(fields, idx)):
        for a, b in zip(decoded[j], corner):
            assert torch.equal(a, b.reshape(-1))


def test_big_pass_split_does_not_change_pixels(monkeypatch):
    fields, indices, W, H = _port("close_in")
    want = tpacked.render_gbuffer_packed_batch(fields, indices, W, H)
    for limit in (0, 1 << 30):
        monkeypatch.setattr(tvtx, "BIG_PIXELS", limit)
        _, _, count = tpacked.cover_plain(fields, indices, W, H)
        assert (int(count[0]) == 0) == (limit > 0)
        for a, b in zip(tpacked.render_gbuffer_packed_batch(fields, indices, W, H), want):
            assert torch.equal(a, b)


def test_packed_wrappers_take_cpu_tensors_to_plain():
    fields, indices, W, H = _port("close_in")
    names = ("packed_cover", "packed_cover_big", "packed_resolve_gbuffer")
    before = [getattr(kernels, n).launches for n in names]
    winner, big, count = kernels.packed_cover(fields, indices, W, H)
    for a, b in zip((winner, big, count), tpacked.cover_plain(fields, indices, W, H)):
        assert torch.equal(a, b)
    kernels.packed_cover_big(fields, indices, winner, big, count)
    gbuf = kernels.packed_resolve_gbuffer(fields, indices, winner)
    for a, b in zip(gbuf, tpacked.resolve_gbuffer_plain(fields, indices, winner)):
        assert torch.equal(a, b)
    assert [getattr(kernels, n).launches for n in names] == before


def test_packed_wrappers_reject_bad_inputs():
    fields, indices, W, H = _port("dem_renderer_cam")
    with pytest.raises(ValueError, match="fields"):
        kernels.packed_cover(fields.double(), indices, W, H)
    with pytest.raises(ValueError, match="fields"):
        kernels.packed_cover(fields[:, :6].contiguous(), indices, W, H)
    with pytest.raises(ValueError, match="indices"):
        kernels.packed_cover(fields, indices.long(), W, H)
    with pytest.raises(ValueError, match="indices"):
        kernels.packed_cover(fields, indices.t(), W, H)
    winner, big, count = kernels.packed_cover(fields, indices, W, H)
    with pytest.raises(ValueError, match="winner"):
        kernels.packed_resolve_gbuffer(fields, indices, winner.float())
    with pytest.raises(ValueError, match="big"):
        kernels.packed_cover_big(fields, indices, winner, big[:-1], count)
    with pytest.raises(ValueError, match="indices must lie in"):
        tpipe._tri_indices_i32(np.array([[0, 1, fields.shape[2]]]), fields.shape[2], "cpu")
    with pytest.raises(ValueError, match="indices must lie in"):
        tpipe._tri_indices_i32(np.array([[0, -1, 2]]), fields.shape[2], "cpu")


def test_route_choice():
    # The vertex-stream route keeps every mesh that names its grid.
    assert tpipe.use_vtx_route(64, 64 * 64, tvtx.n_triangles(64))
    # Without a grid, the extended shader takes the indexed route at every
    # size; the shipped shader keeps the record route (its fused kernel).
    assert tpipe.use_indexed_route(None, "extended")
    assert not tpipe.use_indexed_route(None, "shipped")
    assert not tpipe.use_indexed_route(64, "extended")


def test_pipeline_extended_frame_takes_indexed_route(monkeypatch):
    """render_terrain_u8 with the extended shader and no grid launches the
    indexed kernels' wrappers once each, and no record-route wrapper."""
    xyuv, tris, heights, view, proj, row_size, W, H = _case("dem_renderer_cam")
    calls = []
    for name in ("packed_cover", "packed_cover_big", "packed_resolve_gbuffer",
                 "raster_gbuffer", "raster_shade_shipped"):
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name,
                            lambda *a, _fn=fn, _n=name, **k: (calls.append(_n), _fn(*a, **k))[1])
    img = tpipe.render_terrain_u8(
        xyuv, tris, heights, view, proj, spacing=1.0, exaggeration=1.0, h_min=-30.0,
        h_max=60.0, exposure=1.1, sun_dir=np.array([0.3, 0.8, -0.4], np.float32),
        lut=np.ones((256, 4), np.float32), width=W, height=H, fs_mode="extended",
        normal_spacing=10.0, row_size=row_size, device="cpu")
    assert img.shape == (H, W, 4) and img.dtype == np.uint8
    assert calls == ["packed_cover", "packed_cover_big", "packed_resolve_gbuffer"]
    dev = tpipe.render_terrain_u8(
        xyuv, tris, heights, view, proj, spacing=1.0, exaggeration=1.0, h_min=-30.0,
        h_max=60.0, exposure=1.1, sun_dir=np.array([0.3, 0.8, -0.4], np.float32),
        lut=np.ones((256, 4), np.float32), width=W, height=H, fs_mode="extended",
        normal_spacing=10.0, device="cpu", as_device=True)
    assert dev.dtype == torch.uint32 and tuple(dev.shape) == (H, W)
    np.testing.assert_array_equal(dev.view(torch.int32).numpy().view(np.uint8).reshape(H, W, 4),
                                  img)
