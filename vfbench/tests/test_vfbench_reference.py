"""The plain reference against the port on the CPU at a tiny grid and DEM:
the frames byte for byte, and each host piece it works out again (mesh,
cameras, sun, LUT, height range) bit for bit."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import vulkan_forge_torch as vt
from vulkan_forge_torch import _camera, _colormap, _dem, _mesh, _renderer, _uniforms
from vfbench import inputs
from vfbench.reference import host, raster, scenes

W, H = 96, 64


@pytest.mark.parametrize("grid", [2, 17, 24])
@pytest.mark.parametrize("phase", [0.0, 2.5])
def test_spike_frames_equal_the_port(grid, phase):
    eyes = inputs.orbit_eyes(3, phase)
    got = vt.render_spike_frames(W, H, grid, eyes, devices=["cpu"])
    want = scenes.spike_frames(W, H, grid, eyes, "viridis", "cpu")
    assert np.array_equal(got, want)


def test_turntable_frame_equals_the_port():
    eye = inputs.orbit_eyes(1, 1.234)[0]
    spike = vt.TerrainSpike(W, H, 20, device="cpu")
    spike.set_camera_look_at(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 45.0, 0.1, 100.0)
    want = scenes.spike_frames(W, H, 20, [eye], "viridis", "cpu")
    assert np.array_equal(spike.render_rgba()[None], want)


@pytest.mark.parametrize("n, seed", [(33, 1), (40, 3000000077)])
@pytest.mark.parametrize("sun, exposure", [((35.0, 120.0), 1.1), ((12.5, 301.0), 0.6)])
def test_renderer_frame_equals_the_port(n, seed, sun, exposure):
    dem = inputs.dem_tile(n, seed, 0, "cpu")
    r = vt.Renderer(W, H, device="cpu")
    r.add_terrain(dem, (30.0, 30.0), 1.5, "terrain")
    r.upload_height_r32f()
    r.set_sun(*sun)
    r.set_exposure(exposure)
    want = scenes.renderer_frame(dem, (30.0, 30.0), 1.5, "terrain", sun, exposure, W, H,
                                 "cpu")
    got = r.render_rgba()[None]
    assert (got[..., :3] != got[0, 0, 0, :3]).any()     # the terrain is in view
    assert np.array_equal(got, want)


def test_spike_mesh_is_the_ports():
    xyuv, tris = host.spike_mesh(9)
    want_xyuv, want_idx = _mesh.build_grid_xyuv(9)
    assert np.array_equal(xyuv, want_xyuv)
    assert np.array_equal(tris.reshape(-1), want_idx.astype(np.int64))


def test_dem_mesh_is_the_renderers():
    xyuv, tris = host.dem_mesh(5, 7, 30.0, 20.0)
    want_xyuv, want_tris = _renderer.grid_mesh(7, 5, 30.0, 20.0, "cpu")
    assert np.array_equal(xyuv, want_xyuv.numpy())
    assert np.array_equal(tris, want_tris.numpy())


@pytest.mark.parametrize("n", [33, 300])
def test_height_range_is_the_renderers(n):
    heights = inputs.dem_tile(n, 9, 1, "cpu") * np.float32(1.5)
    meta = _dem.TerrainMeta()
    meta.compute_and_store_h_range(heights.reshape(-1))
    assert host.height_range(heights) == (meta.h_min, meta.h_max)


def test_cameras_sun_and_lut_are_the_ports():
    views, projs = host.orbit_cameras(4, 0.7, 800, 600)
    eyes = inputs.orbit_eyes(4, 0.7)
    for v, p, e in zip(views, projs, eyes):
        assert np.array_equal(v, _camera.look_at_rh(e, (0, 0, 0), (0, 1, 0)))
        assert np.array_equal(p, _camera.perspective_wgpu(np.float32(np.radians(45.0)),
                                                          np.float32(800) / np.float32(600),
                                                          np.float32(0.1), np.float32(100.0)))
    r = vt.Renderer(800, 600, device="cpu")
    terr = _renderer.TerrainData(3601, 3601, (30.0, 30.0), 1.5, "terrain", np.zeros(1))
    for a, b in zip(host.dem_camera(3601, 3601, (30.0, 30.0), 800, 600),
                    r._default_terrain_camera(terr)):
        assert np.array_equal(a, b)
    assert np.array_equal(host.sun_dir_spherical(33.0, 250.0),
                          _uniforms.sun_dir_spherical(33.0, 250.0))
    for name in ("viridis", "terrain"):
        assert np.array_equal(host.lut(name), _colormap.build_lut(name)[0])


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -12), 3.0e38])
    got = raster.round_tf32(x)
    assert got.tolist()[:5] == [1.0, 1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -9, -1.0]
    assert torch.isfinite(got[5])


def test_dem_tile_is_seeded():
    a = inputs.dem_tile(17, 3000000123, 2, "cpu")
    assert a.dtype == np.float32 and a.shape == (17, 17)
    assert np.array_equal(a, inputs.dem_tile(17, 3000000123, 2, "cpu"))
    assert not np.array_equal(a, inputs.dem_tile(17, 3000000123, 3, "cpu"))
    assert 200.0 < np.ptp(a) < 4000.0
