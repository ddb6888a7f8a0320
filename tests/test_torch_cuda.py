"""The port's CUDA kernels on the card (marked ``gpu``; they skip without
one: a CUDA kernel has no CPU mode).

This file imports no jax, so it runs on the card machine, which has none:
``python3 -m pytest -m gpu tests/test_torch_cuda.py``. Each kernel is held
to its plain PyTorch version on the same CUDA tensors -- bit-equal, since
the kernels are built with -fmad=false and use the plain version's op
order -- and the public API on ``device="cuda"`` to the same call on
``device="cpu"``, byte for byte.
"""
import math

import numpy as np
import pytest
import torch

import vulkan_forge_torch as vt
from vulkan_forge_torch import _camera, _colormap, _mesh
from vulkan_forge_torch._parity import assert_fs_policy
from vulkan_forge_torch._raster import fragment, kernels, pipeline, setup, tiles


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
    n = kernels.raster_gbuffer.launches + kernels.raster_shade_shipped.launches
    got = _api(name, "cuda")
    torch.cuda.synchronize()
    assert kernels.raster_gbuffer.launches + kernels.raster_shade_shipped.launches == n + 1
    np.testing.assert_array_equal(got, _api(name, "cpu"))
