"""The port's CUDA kernels on the card (marked ``gpu``; they skip without
one: a CUDA kernel has no CPU mode).

This file imports no jax, so it runs on the card machine, which has none:
``python3 -m pytest -m gpu tests/test_torch_cuda.py``. Each kernel is held
to its plain PyTorch version on the same CUDA tensors -- bit-equal, since
the kernels are built with -fmad=false and use the plain version's op
order -- the vertex-stream g-buffer to the record kernel's, and the public
API on ``device="cuda"`` to the same call on ``device="cpu"``, byte for
byte.
"""
import math

import numpy as np
import pytest
import torch

import vulkan_forge_torch as vt
from vulkan_forge_torch import _camera, _colormap, _mesh
from vulkan_forge_torch._parity import assert_fs_policy
from vulkan_forge_torch._raster import fragment, kernels, pipeline, setup, tiles, vtx


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _terrain(grid, W, H, eye, dev, batch=1):
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
        t(np.zeros((1, 1))), t(views), t(np.stack([proj] * batch)), t(1.0), t(1.0), W, H)
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
