"""The port's CUDA kernels on the card (marked ``gpu``; they skip without
one: a CUDA kernel has no CPU mode).

This file imports no jax, so it runs on the card machine, which has none:
``python3 -m pytest -m gpu tests/test_torch_cuda.py``. Each kernel is held
to its plain PyTorch version on the same CUDA tensors -- bit-equal, since
the kernels are built with -fmad=false and use the plain version's op
order -- the vertex-stream and indexed-mesh g-buffers to the record
kernel's, and the public API on ``device="cuda"`` to the same call on
``device="cpu"``, byte for byte or under the FS policy.
"""
import math

import numpy as np
import pytest
import torch

import vulkan_forge_torch as vt
from vulkan_forge_torch import _camera, _colormap, _mesh, _renderer as trend
from vulkan_forge_torch._parity import assert_fs_policy
from vulkan_forge_torch._raster import (fragment, hw_oracle, kernels, packed, pipeline,
                                        segments, setup, tiles, vtx)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _terrain(grid, W, H, eye, dev, batch=1, fill_rule="inclusive"):
    xyuv, idx = _mesh.build_grid_xyuv(grid)
    views = np.stack([_camera.look_at_rh(
        (eye[0] * math.cos(0.7 * b) - eye[2] * math.sin(0.7 * b), eye[1],
         eye[0] * math.sin(0.7 * b) + eye[2] * math.cos(0.7 * b)), (0, 0, 0), (0, 1, 0))
        for b in range(batch)])
    proj = _camera.perspective_wgpu(np.float32(math.radians(45)), np.float32(W / H),
                                    np.float32(0.1), np.float32(100))
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
    records, binning = pipeline.terrain_records(
        t(xyuv), torch.as_tensor(idx.astype(np.int64).reshape(-1, 3), device=dev),
        t(np.zeros((1, 1))), t(views), t(np.stack([proj] * batch)), t(1.0), t(1.0), W, H,
        fill_rule=fill_rule)
    lut, _ = _colormap.build_lut("terrain")
    shade = (t(lut), t(1.0), t(1.1), t([0.35, 0.9, 0.2]))
    return records, binning, shade


CASES = [(16, 128, 96, (2.0, 1.5, 2.5), 1), (32, 160, 120, (-2.0, 1.4, 2.6), 3),
         (128, 800, 600, (3.0, 2.0, 3.0), 2), (24, 161, 83, (0.4, 0.8, 0.5), 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("grid,W,H,eye,batch", CASES)
def test_gbuffer_kernel_matches_plain(cuda, grid, W, H, eye, batch):
    records, binning, _ = _terrain(grid, W, H, eye, cuda, batch)
    n = kernels.raster_gbuffer.launches
    got = kernels.raster_gbuffer(records, binning, batch, W, H)
    torch.cuda.synchronize()
    assert kernels.raster_gbuffer.launches == n + 1
    want = tiles.render_gbuffer(records, binning, batch, W, H)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("grid,W,H,eye,batch", CASES)
def test_shade_kernel_matches_plain(cuda, grid, W, H, eye, batch):
    records, binning, shade = _terrain(grid, W, H, eye, cuda, batch)
    n = kernels.raster_shade_shipped.launches
    img = kernels.raster_shade_shipped(records, binning, batch, W, H, *shade)
    torch.cuda.synchronize()
    assert kernels.raster_shade_shipped.launches == n + 1
    plain = fragment.terrain_fs(*tiles.render_gbuffer(records, binning, batch, W, H), *shade)
    assert_fs_policy(img, plain, "shade kernel vs plain")


@pytest.mark.gpu
@pytest.mark.parametrize("grid,W,H,eye,batch", CASES)
def test_hw_kernels_match_plain(cuda, grid, W, H, eye, batch):
    """The hardware fill rule: both _hw kernels against the plain raster
    over the same snapped records; only the _hw kernels launch."""
    records, binning, shade = _terrain(grid, W, H, eye, cuda, batch, fill_rule="hw")
    wrappers = (kernels.raster_gbuffer_hw, kernels.raster_shade_shipped_hw,
                kernels.raster_gbuffer, kernels.raster_shade_shipped)
    n = [f.launches for f in wrappers]
    got = kernels.raster_gbuffer_hw(records, binning, batch, W, H)
    img = kernels.raster_shade_shipped_hw(records, binning, batch, W, H, *shade)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [n[0] + 1, n[1] + 1, n[2], n[3]]
    want = tiles.render_gbuffer(records, binning, batch, W, H)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert_fs_policy(img, fragment.terrain_fs(*want, *shade), "hw shade kernel vs plain")


@pytest.mark.gpu
def test_hw_kernel_equals_fixed_point_oracle(cuda):
    """The grid-16 160x120 scene of tests/test_packed.py:261-283: the hw
    kernel's coverage is the int64 oracle's, bit for bit."""
    W, H = 160, 120
    xyuv, idx = _mesh.build_grid_xyuv(16)
    x, z = xyuv[:, 0], xyuv[:, 1]
    h = np.sin(x * 1.3) * 0.25 + np.cos(z * 1.1) * 0.25
    view = _camera.look_at_rh((3.0, 2.0, 3.0), (0, 0, 0), (0, 1, 0))
    proj = _camera.perspective_wgpu(np.float32(math.radians(45.0)), np.float32(W / H),
                                    np.float32(0.1), np.float32(100.0))
    clip = (np.stack([x, h, z, np.ones_like(x)], axis=-1) @ view.T) @ proj.T
    vary = np.stack([h, x, z], axis=-1)
    indices = idx.astype(np.int64).reshape(-1, 3)
    xf, yf, zf, wf = setup.clip_to_fb(torch.as_tensor(clip, device=cuda), W, H)
    records, bbox = setup.triangle_setup(xf, yf, zf, wf, torch.as_tensor(vary, device=cuda),
                                         torch.as_tensor(indices, device=cuda), W, H, "hw")
    mask = kernels.raster_gbuffer_hw(records, setup.bin_tiles(bbox, W, H), 1, W, H)[3]
    wid, _ = hw_oracle.rasterize_hw(clip, vary, indices, W, H)
    np.testing.assert_array_equal(mask[0].cpu().numpy(), wid >= 0)


def _api_hw(name, device):
    if name == "renderer_160x120":
        r = vt.Renderer(160, 120, device=device)
        r.add_terrain(_dem(40, 56, 7), (10.0, 12.0), 1.5, "terrain")
        r.upload_height_r32f()
        return r.render_rgba()
    return _api(name, device)


@pytest.mark.gpu
@pytest.mark.parametrize("name,kernel", [
    ("triangle_97x61", "raster_gbuffer_hw"), ("scene_magma_160x120_g32", "raster_shade_shipped_hw"),
    ("spike_terrain_128x96_g16_cam", "raster_shade_shipped_hw"),
    ("renderer_160x120", "raster_gbuffer_hw")])
def test_hw_public_api_cuda_equals_cpu(cuda, name, kernel, monkeypatch):
    """Under VF_FILL_RULE=hw every frame takes the record route: one _hw
    kernel launches and no vtx, indexed or inclusive kernel; the CUDA image
    is held to the CPU image under the FS policy."""
    monkeypatch.setenv("VF_FILL_RULE", "hw")
    wrappers = ("raster_gbuffer_hw", "raster_shade_shipped_hw", "raster_gbuffer",
                "raster_shade_shipped", "vtx_cover", "packed_cover")
    counts = lambda: [getattr(kernels, w).launches for w in wrappers]
    before = counts()
    got = _api_hw(name, "cuda")
    torch.cuda.synchronize()
    assert counts() == [n + (w == kernel) for w, n in zip(wrappers, before)]
    assert_fs_policy(got, _api_hw(name, "cpu"), f"{name} under hw, cuda vs cpu")


@pytest.mark.gpu
def test_kernels_reject_mixed_devices(cuda):
    records, binning, shade = _terrain(16, 128, 96, (2.0, 1.5, 2.5), cuda)
    with pytest.raises(ValueError, match="binning.rows"):
        kernels.raster_gbuffer(records, binning._replace(rows=binning.rows.cpu()), 1, 128, 96)
    with pytest.raises(ValueError, match="lut"):
        kernels.raster_shade_shipped(records, binning, 1, 128, 96, shade[0].cpu(), *shade[1:])


def _golden_height():
    return (np.outer(np.sin(np.linspace(0, 3, 33)),
                     np.cos(np.linspace(0, 2, 45))) * 0.3).astype(np.float32)


def _api(name, device):
    if name.startswith("triangle"):
        return vt.render_triangle_rgba(*{"triangle_97x61": (97, 61),
                                         "triangle_800x600": (800, 600)}[name], device=device)
    if name == "scene_magma_160x120_g32":
        s = vt.Scene(160, 120, 32, "magma", device=device)
        s.set_height_from_r32f(_golden_height())
        return s.render_rgba()
    if name == "spike_terrain_128x96_g16_cam":
        t = vt.TerrainSpike(128, 96, 16, "terrain", device=device)
        t.set_camera_look_at((2.0, 1.5, 2.5), (0, 0, 0), (0, 1, 0), 50.0, 0.1, 50.0)
        return t.render_rgba()
    return vt.make_terrain(800, 600, 128, device=device).render_rgba()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["triangle_97x61", "triangle_800x600",
                                  "scene_magma_160x120_g32", "spike_terrain_128x96_g16_cam",
                                  "spike_default_800x600_g128"])
def test_public_api_cuda_equals_cpu(cuda, name):
    # One image-producing launch: the triangle's g-buffer kernel, or the
    # vtx route's shading resolve (a TerrainSpike/Scene names its grid).
    finals = (kernels.raster_gbuffer, kernels.raster_shade_shipped,
              kernels.vtx_resolve_shade_shipped)
    n = sum(f.launches for f in finals)
    got = _api(name, "cuda")
    torch.cuda.synchronize()
    assert sum(f.launches for f in finals) == n + 1
    np.testing.assert_array_equal(got, _api(name, "cpu"))


# ---------------- vertex-stream route (csrc/vtx.cu) ----------------

def _vtx_fields(grid, W, H, eye, dev, batch=1, fs_mode="shipped", near=0.1):
    """Post-VS fields of ``batch`` cameras turning about ``eye``, fovy 60 (a
    close ``eye`` gives near-camera triangles; with a near plane closer
    than a cell, valid triangles crossing w = 0)."""
    xyuv, _ = _mesh.build_grid_xyuv(grid)
    views = np.stack([_camera.look_at_rh(
        (eye[0] * math.cos(0.7 * b) - eye[2] * math.sin(0.7 * b), eye[1],
         eye[0] * math.sin(0.7 * b) + eye[2] * math.cos(0.7 * b)), (0, 0, 0), (0, 1, 0))
        for b in range(batch)])
    proj = _camera.perspective_wgpu(np.float32(math.radians(60)), np.float32(W / H),
                                    np.float32(near), np.float32(100))
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
    heights = t(np.random.default_rng(grid).uniform(-0.3, 0.3, (9, 11)))
    return vtx.vs_fields(t(xyuv), heights, t(views), t(np.stack([proj] * batch)),
                         t(0.9), t(1.2), W, H, fs_mode)


VTX_CASES = [(24, 128, 96, (2.0, 1.5, 2.5), 2, 0.1), (64, 161, 83, (-2.0, 1.4, 2.6), 1, 0.1),
             (48, 160, 120, (0.15, 0.7, 0.1), 1, 0.1),    # close in: big triangles
             (128, 200, 150, (0.3, 0.35, 0.2), 2, 0.001),  # inside: w-crossing triangles
             (256, 800, 600, (3.0, 2.0, 3.0), 2, 0.1)]


@pytest.mark.gpu
@pytest.mark.parametrize("grid,W,H,eye,batch,near", VTX_CASES)
def test_vtx_kernels_match_plain(cuda, grid, W, H, eye, batch, near):
    fields = _vtx_fields(grid, W, H, eye, cuda, batch, near=near)
    n = [f.launches for f in (kernels.vtx_cover, kernels.vtx_cover_big,
                              kernels.vtx_resolve_gbuffer)]
    winner, big, count = kernels.vtx_cover(fields, grid, W, H)
    p_winner, p_big, p_count = vtx.cover_plain(fields, grid, W, H)
    assert torch.equal(winner, p_winner) and torch.equal(count, p_count)
    k = int(count[0])
    assert torch.equal(torch.sort(big[:k]).values, p_big[:k])
    kernels.vtx_cover_big(fields, grid, winner, big, count)
    vtx.cover_big_plain(fields, grid, p_winner, p_big, p_count)
    assert torch.equal(winner, p_winner)
    got = kernels.vtx_resolve_gbuffer(fields, grid, winner)
    torch.cuda.synchronize()
    assert [f.launches for f in (kernels.vtx_cover, kernels.vtx_cover_big,
                                 kernels.vtx_resolve_gbuffer)] == [m + 1 for m in n]
    for a, b in zip(got, vtx.resolve_gbuffer_plain(fields, grid, winner)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("grid,W,H,eye,batch,near", VTX_CASES)
def test_vtx_shade_kernel_matches_plain(cuda, grid, W, H, eye, batch, near):
    fields = _vtx_fields(grid, W, H, eye, cuda, batch, near=near)
    lut, _ = _colormap.build_lut("terrain")
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=cuda)
    shade = (t(lut), t(1.0), t(1.1), t([0.35, 0.9, 0.2]))
    n = kernels.vtx_resolve_shade_shipped.launches
    img = vtx.render_image_vtx_batch(fields, *shade, grid, W, H)
    torch.cuda.synchronize()
    assert kernels.vtx_resolve_shade_shipped.launches == n + 1
    assert img.dtype == torch.uint32 and tuple(img.shape) == (batch, H, W)
    winner = vtx.cover_big_plain(fields, grid, *vtx.cover_plain(fields, grid, W, H))
    assert_fs_policy(img, vtx.resolve_shade_shipped_plain(fields, grid, winner, *shade),
                     "vtx shade kernel vs plain")


@pytest.mark.gpu
@pytest.mark.parametrize("grid,W,H,eye,batch,near", VTX_CASES[1:4])
def test_vtx_route_matches_record_route_on_card(cuda, grid, W, H, eye, batch, near):
    """Two independent kernels on one scene: the vtx g-buffer equals the
    record kernel's bit for bit."""
    fields = _vtx_fields(grid, W, H, eye, cuda, batch, near=near)
    _, idx = _mesh.build_grid_xyuv(grid)
    x, y, w = fields[:, 0], fields[:, 1], fields[:, 2]
    records, bbox = setup.triangle_setup(
        x, y, fields[:, 6], w, fields[:, 3:6].transpose(1, 2),
        torch.as_tensor(idx.astype(np.int64).reshape(-1, 3), device=cuda), W, H)
    want = kernels.raster_gbuffer(records.reshape(-1, setup.REC_WIDTH),
                                  setup.bin_tiles(bbox, W, H), batch, W, H)
    for a, b in zip(vtx.render_gbuffer_vtx_batch(fields, grid, W, H), want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["vtx", "packed"])
def test_big_kernel_walks_the_mirrors_tiles(cuda, route):
    """At a w-crossing camera each big-triangle kernel walks, for each list
    entry, the tiles the torch mirror of its rejects keeps
    (vtx.big_tile_walk, the same f64 ops), and its winners equal the plain
    full-bbox walk's."""
    if route == "vtx":
        grid, W, H = 128, 200, 150
        fields = _vtx_fields(grid, W, H, (0.3, 0.35, 0.2), cuda, 2, near=0.001)
        winner, big, count = kernels.vtx_cover(fields, grid, W, H)
        _, p_big, p_count = vtx.cover_plain(fields, grid, W, H)
        run = lambda w, walked: kernels.vtx_cover_big(fields, grid, w, big, count, walked)
        plain = vtx.cover_big_plain(fields, grid, winner.clone(), big, count)
        want = vtx.big_walk_counts(fields, grid, p_big, p_count, W, H)
    else:
        fields, idx, W, H = _indexed_inputs("w_cross", cuda)
        winner, big, count = kernels.packed_cover(fields, idx, W, H)
        _, p_big, p_count = packed.cover_plain(fields, idx, W, H)
        run = lambda w, walked: kernels.packed_cover_big(fields, idx, w, big, count, walked)
        plain = packed.cover_big_plain(fields, idx, winner.clone(), big, count)
        want = packed.big_walk_counts(fields, idx, p_big, p_count, W, H)
    k = int(count[0])
    assert k > 0, "the camera must exercise the big-triangle pass"
    walked = torch.full_like(big, -1)
    got = run(winner, walked)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    order = torch.argsort(big[:k])
    assert torch.equal(big[:k][order], p_big[:k])
    assert torch.equal(walked[:k][order], want)
    assert 0 < int(want.sum()) and int((want == 0).sum()) > 0


@pytest.mark.gpu
def test_vtx_kernels_reject_bad_inputs(cuda):
    fields = _vtx_fields(8, 32, 24, (2.0, 1.5, 2.5), cuda)
    with pytest.raises(ValueError, match="fields"):
        kernels.vtx_cover(fields[:, :6], 8, 32, 24)
    winner, big, count = kernels.vtx_cover(fields, 8, 32, 24)
    with pytest.raises(ValueError, match="winner is on"):
        kernels.vtx_resolve_gbuffer(fields, 8, winner.cpu())
    with pytest.raises(ValueError, match="count is on"):
        kernels.vtx_cover_big(fields, 8, winner, big, count.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("fs_mode", ["shipped", "extended"])
def test_vtx_public_api_cuda_equals_cpu(cuda, fs_mode):
    """grid=256 takes the vertex-stream route on both devices and no
    record-route kernel runs. The CUDA image is held to the CPU image under
    the FS policy: the shipped shader's sinf/cosf/powf differ from the host
    library by ulps (2 bytes of 307,200 off by 1 at this camera)."""
    W, H, grid = 320, 240, 256
    s = vt.make_terrain(W, H, grid, device="cpu")
    s.set_camera_look_at((1.5, 0.9, 1.2), (0, 0, 0), (0, 1, 0), 50.0, 0.1, 50.0)
    g = s._globals
    args = dict(spacing=g.spacing, exaggeration=g.exaggeration, h_min=g.h_min,
                h_max=g.h_max, exposure=g.exposure, sun_dir=g.sun_dir, lut=s._lut,
                width=W, height=H, fs_mode=fs_mode, grid_n=grid)
    heights = np.random.default_rng(3).uniform(-0.4, 0.4, (33, 45)).astype(np.float32)
    counts = lambda: (kernels.vtx_cover.launches, kernels.raster_gbuffer.launches,
                      kernels.raster_shade_shipped.launches)
    before = counts()
    got = pipeline.render_terrain_u8(s._xyuv, s._indices, heights, s._view, s._proj,
                                     device="cuda", **args)
    torch.cuda.synchronize()
    after = counts()
    assert after[0] == before[0] + 1 and after[1:] == before[1:]
    want = pipeline.render_terrain_u8(s._xyuv, s._indices, heights, s._view, s._proj,
                                      device="cpu", **args)
    assert_fs_policy(got, want, f"vtx route, {fs_mode}, cuda vs cpu")


# ---------------- indexed-mesh route (csrc/packed.cu) ----------------

def _dem(rows, cols, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:rows, 0:cols] / np.float32(max(rows, cols))
    h = sum(rng.uniform(5, 30) * np.sin(2 * math.pi * (rng.uniform(1, 3) * x
                                                       + rng.uniform(1, 3) * y + rng.uniform()))
            for _ in range(5))
    return h.astype(np.float32)


def _indexed_inputs(case, dev):
    """(fields (B, 7, N), int32 indices, W, H) of a Renderer DEM frame at
    its default camera, close in, with w-crossing triangles, with a near
    plane that cuts the mesh, or a random triangle soup."""
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
    if case == "soup":
        rng = np.random.default_rng(5)
        n, tris = 3000, 20000
        xyuv = np.concatenate([rng.uniform(-60, 60, (n, 2)), rng.uniform(0, 1, (n, 2))], 1)
        idx = torch.as_tensor(rng.integers(0, n, (tris, 3)), dtype=torch.int32, device=dev)
        heights = rng.uniform(-20, 20, (9, 11))
        W, H = 200, 150
        view = _camera.look_at_rh((-150, 110, 40), (0, 0, 0), (0, 1, 0))
        proj = _camera.perspective_wgpu(np.float32(math.radians(45)), np.float32(W / H),
                                        np.float32(0.5), np.float32(1e4))
        views, projs = view[None], proj[None]
    else:
        rows, cols, W, H = {"renderer": (64, 80, 160, 120), "close": (48, 48, 160, 120),
                            "w_cross": (96, 96, 200, 150), "batch": (128, 128, 320, 240),
                            "near_cut": (64, 80, 160, 120)}[case]
        r = vt.Renderer(W, H, device="cpu")
        r.add_terrain(_dem(rows, cols, rows), (10.0, 12.0), 1.5, "terrain")
        xyuv, idx = trend.grid_mesh(cols, rows, 10.0, 12.0, "cpu")
        idx = idx.to(dev)
        heights = r._terrain.heights
        view, proj = r._default_terrain_camera(r._terrain)
        views, projs = view[None], proj[None]
        if case in ("close", "w_cross"):
            near = 0.1 if case == "close" else 0.001
            eye, target = (((40, 60, 30), (-60, 0, -40)) if case == "close"
                           else ((0, 15, 0), (100, -5, 90)))
            views = _camera.look_at_rh(eye, target, (0, 1, 0))[None]
            projs = _camera.perspective_wgpu(np.float32(math.radians(60)), np.float32(W / H),
                                             np.float32(near), np.float32(1e4))[None]
        if case == "near_cut":
            # The default camera with its near plane at 0.8 of the distance
            # to the DEM centre, which cuts the mesh.
            near = 0.8 * math.sqrt(2.0) * 0.9 * max((cols - 1) * 10.0, (rows - 1) * 12.0)
            projs = _camera.perspective_wgpu(np.float32(math.radians(45)), np.float32(W / H),
                                             np.float32(near), np.float32(1e4))[None]
        if case == "batch":
            views = np.stack([view, _camera.look_at_rh((300, 500, 200), (0, 0, 0), (0, 1, 0))])
            projs = np.stack([proj, proj])
    fields = vtx.vs_fields(t(xyuv), t(heights), t(views), t(projs), t(1.0), t(1.0), W, H,
                           "extended")
    return fields, idx, W, H


PACKED_CASES = ["renderer", "close", "w_cross", "soup", "batch"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", PACKED_CASES)
def test_packed_kernels_match_plain(cuda, case):
    fields, idx, W, H = _indexed_inputs(case, cuda)
    wrappers = (kernels.packed_cover, kernels.packed_cover_big, kernels.packed_resolve_gbuffer)
    n = [f.launches for f in wrappers]
    winner, big, count = kernels.packed_cover(fields, idx, W, H)
    p_winner, p_big, p_count = packed.cover_plain(fields, idx, W, H)
    assert torch.equal(winner, p_winner) and torch.equal(count, p_count)
    k = int(count[0])
    if case in ("close", "w_cross"):
        assert k > 0, "the camera must exercise the big-triangle pass"
    assert torch.equal(torch.sort(big[:k]).values, p_big[:k])
    kernels.packed_cover_big(fields, idx, winner, big, count)
    packed.cover_big_plain(fields, idx, p_winner, p_big, p_count)
    assert torch.equal(winner, p_winner)
    got = kernels.packed_resolve_gbuffer(fields, idx, winner)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [m + 1 for m in n]
    for a, b in zip(got, packed.resolve_gbuffer_plain(fields, idx, winner)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["renderer", "w_cross", "soup"])
def test_packed_route_matches_record_route_on_card(cuda, case):
    """Two independent kernels on one frame: the indexed g-buffer equals
    the record kernel's bit for bit."""
    fields, idx, W, H = _indexed_inputs(case, cuda)
    records, bbox = setup.triangle_setup(
        fields[:, 0], fields[:, 1], fields[:, 6], fields[:, 2], fields[:, 3:6].transpose(1, 2),
        idx.long(), W, H)
    want = kernels.raster_gbuffer(records.reshape(-1, setup.REC_WIDTH),
                                  setup.bin_tiles(bbox, W, H), fields.shape[0], W, H)
    for a, b in zip(packed.render_gbuffer_packed_batch(fields, idx, W, H), want):
        assert torch.equal(a, b)


def _walk_inputs(case, rule, dev):
    """(records, binning, frames, W, H) of a record-kernel case under
    ``rule``: the triangle (one full-box pair per inner tile; 97x61 has
    partial right and bottom tiles), a watertight quad (pixel centres on
    edges), the spike g64 from inside the relief
    (w-crossing full-screen bboxes, tiles of more than 256 pairs), and
    _indexed_inputs' DEM frames through setup (close-in, w-crossing, a
    batch of two)."""
    if case.startswith("triangle"):
        W, H = (int(v) for v in case.split()[1].split("x"))
        return (*pipeline.triangle_records(W, H, dev, rule), 1, W, H)
    if case.startswith("quad"):
        # Corners and the shared diagonal on pixel centres
        # (tests/test_fillrule.py:51-79): the hw thresholds decide ties;
        # "quad x20" draws it 20 times, so its tiles take the chunked walk.
        W, H = 128, 96
        ndc = lambda px, py: (2 * (px + 0.5) / W - 1, 1 - 2 * (py + 0.5) / H)
        clip = torch.tensor([[x, y, 0.5, 1.0] for x, y in (ndc(10, 10), ndc(70, 10),
                                                           ndc(70, 70), ndc(10, 70))],
                            dtype=torch.float32, device=dev)
        x, y, z, w = setup.clip_to_fb(clip, W, H)
        records, bbox = setup.triangle_setup(
            x, y, z, w, torch.ones((4, 3), device=dev),
            torch.tensor([[0, 2, 1], [0, 3, 2]] * (20 if case == "quad x20" else 1),
                         device=dev), W, H, rule)
        return records.reshape(-1, setup.REC_WIDTH), setup.bin_tiles(bbox, W, H), 1, W, H
    if case == "g64 w-crossing":
        W, H = 97, 61
        xyuv, idx = _mesh.build_grid_xyuv(64)
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
        view = _camera.look_at_rh((0.0, 0.9, 0.0), (1.5, -0.2, 1.5), (0, 1, 0))
        proj = _camera.perspective_wgpu(np.float32(math.radians(60)), np.float32(W / H),
                                        np.float32(0.001), np.float32(1e4))
        return (*pipeline.terrain_records(
            t(xyuv), torch.as_tensor(idx.astype(np.int64).reshape(-1, 3), device=dev),
            t(np.zeros((1, 1))), t(view[None]), t(proj[None]), t(1.0), t(1.0), W, H,
            fill_rule=rule), 1, W, H)
    fields, idx, W, H = _indexed_inputs(case, dev)
    records, bbox = setup.triangle_setup(
        fields[:, 0], fields[:, 1], fields[:, 6], fields[:, 2], fields[:, 3:6].transpose(1, 2),
        idx.long(), W, H, rule)
    return (records.reshape(-1, setup.REC_WIDTH), setup.bin_tiles(bbox, W, H),
            fields.shape[0], W, H)


WALK_CASES = ["triangle 97x61", "triangle 800x600", "quad", "quad x20", "g64 w-crossing",
              "close", "w_cross", "batch"]


def _bits(planes):
    return [p.view(torch.int32) if p.dtype == torch.float32 else p for p in planes]


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["inclusive", "hw"])
@pytest.mark.parametrize("case", WALK_CASES)
def test_record_kernels_walk_their_boxes(cuda, case, rule):
    """The four record kernels against the plain raster, bit for bit
    (images under the FS policy), and their evaluated items equal to
    tiles.tile_work; each call launches its kernel once."""
    records, binning, B, W, H = _walk_inputs(case, rule, cuda)
    gbuffer, shade_fn = ((kernels.raster_gbuffer_hw, kernels.raster_shade_shipped_hw)
                         if rule == "hw" else
                         (kernels.raster_gbuffer, kernels.raster_shade_shipped))
    shade = _terrain(16, W, H, (2.0, 1.5, 2.5), cuda)[2]
    ntx, nty = setup.tile_grid(W, H)
    ev = [torch.full((B, nty * ntx), -1, dtype=torch.int32, device=cuda) for _ in range(2)]
    n = [gbuffer.launches, shade_fn.launches]
    got = gbuffer(records, binning, B, W, H, evaluated=ev[0])
    img = shade_fn(records, binning, B, W, H, *shade, evaluated=ev[1])
    torch.cuda.synchronize()
    assert [gbuffer.launches, shade_fn.launches] == [n[0] + 1, n[1] + 1]
    want = tiles.render_gbuffer(records, binning, B, W, H)
    for a, b in zip(_bits(got), _bits(want)):
        assert torch.equal(a, b)
    assert_fs_policy(img, fragment.terrain_fs(*want, *shade), f"{case} {rule} shade vs plain")
    work = tiles.tile_work(binning).view(B, -1).to(torch.int32)
    assert torch.equal(ev[0], work) and torch.equal(ev[1], work)
    counts = binning.offsets[1:] - binning.offsets[:-1]
    if case in ("g64 w-crossing", "batch"):
        assert int(counts.max()) > 256, "the case must walk more than one chunk per tile"
    assert int(want[3].sum()) > 0


@pytest.mark.gpu
def test_record_kernels_reject_bad_walk_inputs(cuda):
    records, binning, B, W, H = _walk_inputs("close", "hw", cuda)
    ntx, nty = setup.tile_grid(W, H)
    with pytest.raises(ValueError, match="boxes is on"):
        kernels.raster_gbuffer_hw(records, binning._replace(boxes=binning.boxes.cpu()), B, W, H)
    with pytest.raises(ValueError, match="evaluated is on"):
        kernels.raster_gbuffer_hw(records, binning, B, W, H,
                                  evaluated=torch.zeros(B, nty * ntx, dtype=torch.int32))


@pytest.mark.gpu
def test_packed_kernels_reject_bad_inputs(cuda):
    fields, idx, W, H = _indexed_inputs("renderer", cuda)
    with pytest.raises(ValueError, match="indices is on"):
        kernels.packed_cover(fields, idx.cpu(), W, H)
    with pytest.raises(ValueError, match="indices"):
        kernels.packed_cover(fields, idx.long(), W, H)
    winner, big, count = kernels.packed_cover(fields, idx, W, H)
    with pytest.raises(ValueError, match="winner is on"):
        kernels.packed_resolve_gbuffer(fields, idx, winner.cpu())


@pytest.mark.gpu
def test_renderer_cuda_equals_cpu(cuda):
    """Renderer(device=None) renders on the card through the indexed route
    (no record kernel), and its frame is held to device="cpu" under the FS
    policy; the height texture lives on the card."""
    def make(device):
        r = vt.Renderer(320, 240, device=device)
        r.add_terrain(_dem(200, 256, 7), (30.0, 30.0), 1.5, "terrain")
        r.upload_height_r32f()
        r.set_sun(35.0, 120.0)
        r.set_exposure(1.2)
        return r
    gpu = make(None)
    assert gpu.device.type == "cuda" and gpu._height_tex.device.type == "cuda"
    counts = lambda: (kernels.packed_cover.launches, kernels.packed_resolve_gbuffer.launches,
                      kernels.raster_gbuffer.launches, kernels.raster_shade_shipped.launches)
    before = counts()
    got = gpu.render_rgba()
    after = counts()
    assert after[:2] == (before[0] + 1, before[1] + 1) and after[2:] == before[2:]
    assert gpu.render_metrics()["render_ms"] > 0.0
    np.testing.assert_array_equal(gpu.debug_read_height_patch(3, 4, 5, 6),
                                  make("cpu").debug_read_height_patch(3, 4, 5, 6))
    assert_fs_policy(got, make("cpu").render_rgba(), "Renderer cuda vs cpu")


def test_renderer_device_none_raises_without_card(monkeypatch):
    """device=None means "cuda": without a card the Renderer raises, and
    nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        vt.Renderer(64, 48)


# ---------------- the cover passes' bbox test (vf_vtx_cover, vf_packed_cover) ----------------

# (grid, W, H, eye, batch, near) of _vtx_fields: orbit, close in, w-crossing
# triangles, and a near plane (3.5) that cuts the grid.
COVER_VTX_CASES = {"orbit": (64, 161, 83, (-2.0, 1.4, 2.6), 2, 0.1),
                   "close-in": (48, 160, 120, (0.15, 0.7, 0.1), 1, 0.1),
                   "w-crossing": (128, 200, 150, (0.3, 0.35, 0.2), 2, 0.001),
                   "near-cut": (128, 200, 150, (3.0, 2.0, 0.0), 2, 3.5)}
COVER_PACKED_CASES = {"orbit": "batch", "close-in": "close", "w-crossing": "w_cross",
                      "near-cut": "near_cut", "soup": "soup"}


def _check_cover(cover, plain, corners, W, H, batch, case):
    """A cover kernel against its plain version: winner plane bit-equal,
    the big list equal as a set, survivors equal to the plain count."""
    survivors = torch.full((batch,), -1, dtype=torch.int32, device="cuda")
    stats = {}
    winner, big, count = cover(survivors)
    p_winner, p_big, p_count = plain(stats)
    torch.cuda.synchronize()
    assert torch.equal(winner, p_winner) and torch.equal(count, p_count)
    k = int(count[0])
    assert torch.equal(torch.sort(big[:k]).values, p_big[:k])
    assert torch.equal(survivors.long(), stats["survivors"])
    assert int(survivors.min()) > 0
    if case == "near-cut":
        valid = setup.setup_fields_core(*corners, W, H)[5]
        assert int(setup.near_cut(*corners, valid).sum()) > 0, "the near plane must cut the mesh"


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(COVER_VTX_CASES))
def test_vtx_cover_survivors_equal_plain(cuda, case):
    grid, W, H, eye, batch, near = COVER_VTX_CASES[case]
    fields = _vtx_fields(grid, W, H, eye, cuda, batch, near=near)
    _check_cover(lambda s: kernels.vtx_cover(fields, grid, W, H, survivors=s),
                 lambda st: vtx.cover_plain(fields, grid, W, H, st),
                 setup.grid_corners([fields[:, f] for f in range(vtx.FIELDS)], grid),
                 W, H, batch, case)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(COVER_PACKED_CASES))
def test_packed_cover_survivors_equal_plain(cuda, case):
    fields, idx, W, H = _indexed_inputs(COVER_PACKED_CASES[case], cuda)
    _check_cover(lambda s: kernels.packed_cover(fields, idx, W, H, survivors=s),
                 lambda st: packed.cover_plain(fields, idx, W, H, st),
                 setup.indexed_corners([fields[:, f] for f in range(vtx.FIELDS)], idx),
                 W, H, fields.shape[0], case)


# ---------------- the resolves on ragged frames (vf::resolve_tile) ----------------

# (grid, W, H, eye, batch, near): frames whose sizes are not multiples of
# the resolve tile (97x61, 801x599, 33x7, 201x149; batches of 1, 2 and 5),
# a close-in camera looking down at which every pixel is covered, and a
# w-crossing one (near plane closer than a cell).
RESOLVE_CASES = {"97x61": (64, 97, 61, (2.0, 1.5, 2.5), 1, 0.1),
                 "801x599 x5": (256, 801, 599, (3.0, 2.0, 3.0), 5, 0.1),
                 "33x7 x5": (32, 33, 7, (2.0, 1.5, 2.5), 5, 0.1),
                 "full cover": (48, 97, 61, (0.05, 0.6, 0.04), 1, 0.1),
                 "w-crossing": (128, 201, 149, (0.3, 0.35, 0.2), 2, 0.001)}


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["vtx", "packed"])
@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_resolves_match_plain_on_ragged_frames(cuda, route, case):
    """Each resolve against its plain version on the plain cover's winners
    and on an all-uncovered winner plane: varyings and masks bit-equal, the
    shaded image under the FS policy and its uncovered pixels the plain
    clear colour's word exactly; one launch per call. The indexed resolve
    reads the same grid through its index buffer."""
    grid, W, H, eye, batch, near = RESOLVE_CASES[case]
    fields = _vtx_fields(grid, W, H, eye, cuda, batch, near=near)
    _, idx = _mesh.build_grid_xyuv(grid)
    idx = torch.as_tensor(idx.astype(np.int32).reshape(-1, 3), device=cuda)
    winner = vtx.cover_big_plain(fields, grid, *vtx.cover_plain(fields, grid, W, H))
    if case == "full cover":
        assert bool((winner > 0).all())
    if case == "w-crossing":
        corners = setup.grid_corners([fields[:, f] for f in range(vtx.FIELDS)], grid)
        valid = setup.setup_fields_core(*corners, W, H)[5]
        assert bool((valid & (torch.stack([c[2] for c in corners]) <= 1e-8).any(0)).any())
    lut, _ = _colormap.build_lut("terrain")
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=cuda)
    shade = (t(lut), t(1.0), t(1.1), t([0.35, 0.9, 0.2]))
    for w in (winner, torch.zeros_like(winner)):
        if route == "vtx":
            n = kernels.vtx_resolve_gbuffer.launches
            got = kernels.vtx_resolve_gbuffer(fields, grid, w)
            want = vtx.resolve_gbuffer_plain(fields, grid, w)
            m = kernels.vtx_resolve_shade_shipped.launches
            img = kernels.vtx_resolve_shade_shipped(fields, grid, w, *shade)
            torch.cuda.synchronize()
            assert kernels.vtx_resolve_shade_shipped.launches == m + 1
            want_img = vtx.resolve_shade_shipped_plain(fields, grid, w, *shade)
            assert_fs_policy(img, want_img, f"vtx shaded resolve, {case}")
            assert torch.equal(img.view(torch.int32)[w == 0],
                               want_img.view(torch.int32)[w == 0])
            assert kernels.vtx_resolve_gbuffer.launches == n + 1
        else:
            n = kernels.packed_resolve_gbuffer.launches
            got = kernels.packed_resolve_gbuffer(fields, idx, w)
            want = packed.resolve_gbuffer_plain(fields, idx, w)
            torch.cuda.synchronize()
            assert kernels.packed_resolve_gbuffer.launches == n + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)


# ---------------- tall-frame route (csrc/segments.cu) ----------------

# (grid, W, H, eye, batch, near, columns): tall frames (H >= 4089) of the
# spike grid; a close-in camera, a w-crossing one (near plane closer than a
# cell), a forced column-major walk and a batch of two frames; a close-in
# camera at g256 whose walk the skip tests cut to 22% (485,248 walked
# pairs, 108,512 overlapping), and a grazing camera at g512 whose busiest
# tile row walks 448 of 511 mesh rows (881,751 walked pairs, 40,083
# overlapping).
SEG_CASES = [(64, 256, 4352, (2.0, 1.5, 2.5), 1, 0.1, False),
             (64, 256, 4352, (2.0, 1.5, 2.5), 1, 0.1, True),
             (96, 200, 4100, (0.15, 0.7, 0.1), 1, 0.1, False),
             (128, 160, 4096, (0.3, 0.35, 0.2), 1, 0.001, False),
             (48, 130, 4200, (-2.0, 1.4, 2.6), 2, 0.1, False),
             (256, 256, 4352, (0.2, 0.15, 0.2), 1, 0.1, False),
             (512, 256, 4352, (3.0, 0.3, 3.0), 1, 0.1, False)]


def _segment_inputs(grid, W, H, eye, batch, near, columns, dev):
    """The stacked segment-walk inputs of ``batch`` frames of the spike grid
    (``pipeline.segment_frame`` on the vtx route's fields), or of the
    column-major walk, forced."""
    fields = _vtx_fields(grid, W, H, eye, dev, batch, near=near)
    _, idx = _mesh.build_grid_xyuv(grid)
    frames = []
    for b in range(batch):
        f = fields[b:b + 1]
        if not columns:
            frames.append(pipeline.segment_frame(f, idx, grid, W, H))
            continue
        records, bbox = setup.corner_records(
            *setup.grid_corners([f[:, k] for k in range(vtx.FIELDS)], grid), W, H)
        perm = segments.column_major_perm(grid - 1, grid - 1, dev)
        frames.append((*segments.compact_valid(records[0], bbox[0][perm], perm),
                       segments.segment_bin(bbox[0][perm], W, H, 2 * (grid - 1))))
    return segments.stack_frames(frames)


@pytest.mark.gpu
@pytest.mark.parametrize("grid,W,H,eye,batch,near,columns", SEG_CASES)
def test_segment_kernels_match_plain(cuda, grid, W, H, eye, batch, near, columns):
    """Both kernels bit-equal to the plain walk over every interval; the
    pairs each tile evaluated equal the torch mirror of the skip tests
    (``segments.overlap_walk``)."""
    records, ids, bbox, binning = _segment_inputs(grid, W, H, eye, batch, near, columns, cuda)
    lut, _ = _colormap.build_lut("terrain")
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=cuda)
    shade = (t(lut), t(1.0), t(1.1), t([0.35, 0.9, 0.2]))
    evaluated = [torch.full(binning.tile_order.shape, -1, dtype=torch.int32, device=cuda)
                 for _ in range(2)]
    n = (kernels.seg_gbuffer.launches, kernels.seg_shade_shipped.launches)
    got = kernels.seg_gbuffer(records, ids, bbox, binning, batch, W, H, evaluated=evaluated[0])
    img = kernels.seg_shade_shipped(records, ids, bbox, binning, batch, W, H, *shade,
                                    evaluated=evaluated[1])
    torch.cuda.synchronize()
    assert (kernels.seg_gbuffer.launches, kernels.seg_shade_shipped.launches) == (n[0] + 1,
                                                                                 n[1] + 1)
    offsets = segments.overlap_walk(bbox, binning, batch, W, H)[1]
    mirror = (offsets[1:] - offsets[:-1]).view(batch, -1).to(torch.int32)
    assert int(mirror.sum()) > 0
    for e in evaluated:
        assert torch.equal(e, mirror)
    want = segments.render_gbuffer_segments_plain(records, ids, binning, batch, W, H)
    assert 0 < int(want[3].sum())
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert_fs_policy(img, fragment.terrain_fs(*want, *shade), "segment shade kernel vs plain")


@pytest.mark.gpu
def test_segment_kernels_reject_bad_inputs(cuda):
    records, ids, bbox, binning = _segment_inputs(16, 64, 4096, (2.0, 1.5, 2.5), 1, 0.1, False,
                                                  cuda)
    with pytest.raises(ValueError, match="ids is on"):
        kernels.seg_gbuffer(records, ids.cpu(), bbox, binning, 1, 64, 4096)
    with pytest.raises(ValueError, match="bbox is on"):
        kernels.seg_gbuffer(records, ids, bbox.cpu(), binning, 1, 64, 4096)
    with pytest.raises(ValueError, match="binning.row_base is on"):
        kernels.seg_gbuffer(records, ids, bbox, binning._replace(row_base=binning.row_base.cpu()),
                            1, 64, 4096)
    with pytest.raises(ValueError, match="binning.seg_y is on"):
        kernels.seg_gbuffer(records, ids, bbox, binning._replace(seg_y=binning.seg_y.cpu()),
                            1, 64, 4096)
    with pytest.raises(ValueError, match="ids must be original"):
        kernels.seg_gbuffer(records, ids - 2**30 - 1, bbox, binning, 1, 64, 4096)


@pytest.mark.gpu
@pytest.mark.parametrize("frame", ["spike", "renderer"])
def test_tall_frame_launches_only_segment_kernels(cuda, frame):
    """A tall single frame (H >= 4089, T > 20,000) through the public API
    launches one segment kernel and nothing else; its CUDA image is held to
    device="cpu" under the FS policy."""
    def render(device):
        if frame == "spike":
            return vt.make_terrain(256, 4096, 128, device=device).render_rgba()
        r = vt.Renderer(256, 4096, device=device)
        r.add_terrain(_dem(120, 130, 9), (30.0, 30.0), 1.5, "terrain")
        r.upload_height_r32f()
        return r.render_rgba()
    wrappers = ("seg_gbuffer", "seg_shade_shipped", "raster_gbuffer", "raster_shade_shipped",
                "raster_gbuffer_hw", "raster_shade_shipped_hw", "vtx_cover", "packed_cover")
    launched = "seg_shade_shipped" if frame == "spike" else "seg_gbuffer"
    counts = lambda: [getattr(kernels, w).launches for w in wrappers]
    before = counts()
    got = render("cuda")
    torch.cuda.synchronize()
    assert counts() == [n + (w == launched) for w, n in zip(wrappers, before)]
    assert_fs_policy(got, render("cpu"), f"tall {frame} cuda vs cpu")


@pytest.mark.gpu
def test_render_spike_frames_on_card(cuda):
    """render_spike_frames on the default devices (every card) takes the
    vtx route's shaded kernels; each frame equals TerrainSpike's on the
    card and, under the FS policy, on the CPU. Four eyes on one card also
    pad to any device count."""
    eyes = [(3.0, 2.0, 3.0), (-3.0, 2.0, 3.0), (0.0, 2.5, 4.0), (2.0, 1.5, -2.5)]
    wrappers = (kernels.vtx_cover, kernels.vtx_cover_big, kernels.vtx_resolve_shade_shipped)
    before = [w.launches for w in wrappers]
    imgs = vt.render_spike_frames(160, 120, 16, eyes)
    torch.cuda.synchronize()
    assert all(w.launches > n for w, n in zip(wrappers, before))
    assert imgs.shape == (4, 120, 160, 4) and imgs.dtype == np.uint8
    spike = {d: vt.TerrainSpike(160, 120, 16, device=d) for d in ("cuda", "cpu")}
    for eye, img in zip(eyes, imgs):
        for d, t in spike.items():
            t.set_camera_look_at(eye, (0, 0, 0), (0, 1, 0), 45.0, 0.1, 100.0)
        np.testing.assert_array_equal(img, spike["cuda"].render_rgba())
        assert_fs_policy(img, spike["cpu"].render_rgba(), str(eye))
    two = vt.render_spike_frames(160, 120, 16, eyes[:3], devices=["cuda", "cuda:0"])
    np.testing.assert_array_equal(two, imgs[:3])
