"""The port's main path end to end against ``vulkan_forge`` (CPU).

Scenes are built once in the reference and carried across with
``_convert.scene_from_reference`` (identical mesh, camera, heights, LUT and
globals), or built through each package's public API. Images are held to
the FS policy (every differing byte off by 1, on at most 1e-4 of the
bytes); the port's own CPU bytes are pinned below.
"""
import hashlib
import math

import numpy as np
import pytest
import torch

import vulkan_forge as vf
from vulkan_forge import _camera as jcam, _colormap as jcmap, _mesh as jmesh
from vulkan_forge._raster import pipeline as jpipe

import vulkan_forge_torch as vt
from vulkan_forge_torch import _convert, _formats
from vulkan_forge_torch._parity import assert_fs_policy
from vulkan_forge_torch._raster import pipeline as tpipe

# The plain raster is a loop of small eager ops: one intra-op thread is the
# fastest setting on the CPU and keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)

# The port's CPU SHA-256 of raw RGBA bytes. All but the spike are the scenes
# of tests/test_goldens.py:53-70 and equal its "any"/"cpu" pins byte for
# byte (the Renderer's frame since the port rounds the raster's
# multiply-adds as XLA:CPU does); test_torch_cuda.py holds the port's CUDA
# bytes to its CPU bytes.
GOLDEN_CPU = {
    "triangle_64x64": "17b914e0b79230e3ae5af70e3531cf1cec7ca7b66039b5ca68cc7b6adb0e3b96",
    "triangle_97x61": "3c6acfe5a502df35a7b2a3485ef9a89302af7d8df9ef37db2c8c8553af827653",
    "scene_magma_160x120_g32": "d83c1fb300de7c421569932a0cb20dd61f38f04a4a6143a31165928aa6c354db",
    "spike_terrain_128x96_g16_cam": "fd0bab706d6f3e780385290a56006b9fe46d8fb35245b6852804ae541f01b333",
    "spike_default_800x600_g128": "b3597e370c985f81289f272eee2c5e89eac87e6ac0c1596e504129dbf9ef4f5f",
    "renderer_extended_96x96": "e6be6cf78b5231cdaa7ce8d521e2468fae85cede2f386dd515e8e7bcac4394e7",
}


def _golden_height():
    return (np.outer(np.sin(np.linspace(0, 3, 33)),
                     np.cos(np.linspace(0, 2, 45))) * 0.3).astype(np.float32)


def _render(mod, name, **dev):
    """The golden scenes through one package's public API."""
    if name.startswith("triangle"):
        w, h = (int(v) for v in name.split("_")[1].split("x"))
        return mod.render_triangle_rgba(w, h, **dev)
    if name == "scene_magma_160x120_g32":
        s = mod.Scene(160, 120, 32, "magma", **dev)
        s.set_height_from_r32f(_golden_height())
        return s.render_rgba()
    if name == "spike_terrain_128x96_g16_cam":
        t = mod.TerrainSpike(128, 96, 16, "terrain", **dev)
        t.set_camera_look_at((2.0, 1.5, 2.5), (0, 0, 0), (0, 1, 0), 50.0, 0.1, 50.0)
        return t.render_rgba()
    if name == "renderer_extended_96x96":
        r = mod.Renderer(96, 96, **dev)
        dem = (np.outer(np.linspace(0, 1, 32), np.linspace(0, 1, 48)) * 40).astype(np.float32)
        r.add_terrain(dem, (10.0, 12.0), 1.5, "viridis")
        r.set_sun(40.0, 135.0)
        r.set_exposure(1.2)
        return r.render_rgba()
    return mod.make_terrain(800, 600, 128, **dev).render_rgba()


@pytest.mark.parametrize("name", sorted(GOLDEN_CPU))
def test_golden_scene_matches_reference(name):
    got = _render(vt, name, device="cpu")
    assert got.dtype == np.uint8 and got.shape[2] == 4
    assert hashlib.sha256(got.tobytes()).hexdigest() == GOLDEN_CPU[name]
    assert_fs_policy(got, _render(vf, name), name)


def test_carried_state_renders_like_the_reference():
    """A reference Scene with non-default globals, carried across."""
    ref = vf.Scene(200, 150, 40, "terrain")
    ref.set_height_from_r32f(np.random.default_rng(11).uniform(-0.4, 0.4, (20, 30))
                             .astype(np.float32))
    ref.set_camera_look_at((-2.5, 1.8, 1.5), (0.2, 0, 0), (0, 1, 0), 55.0, 0.2, 30.0)
    g = ref._globals
    g.exposure, g.spacing, g.h_min, g.h_max, g.exaggeration = 1.3, 0.8, -0.7, 0.6, 1.4
    g.sun_dir = np.array([0.1, 0.7, -0.7], np.float32)
    port = _convert.scene_from_reference(ref, device="cpu")
    assert isinstance(port, vt.Scene) and port.device == torch.device("cpu")
    np.testing.assert_array_equal(port.debug_uniforms_f32(),
                                  ref._globals.to_uniforms(ref._view, ref._proj))
    state = _convert.scene_state_from_reference(ref)
    assert state["exposure"] == pytest.approx(1.3) and state["kind"] == "Scene"
    assert_fs_policy(port.render_rgba(), ref.render_rgba(), "carried Scene")
    # The carried object is the port's own: the same state built natively
    # renders the same bytes.
    native = _convert.scene_from_state(state, device="cpu")
    np.testing.assert_array_equal(native.render_rgba(), port.render_rgba())


def _orbit(n, W, H):
    views, projs = [], []
    for i in range(n):
        a = 2 * math.pi * i / n + 0.3
        views.append(jcam.look_at_rh((3 * math.cos(a), 2.0, 3 * math.sin(a)), (0, 0, 0),
                                     (0, 1, 0)))
        projs.append(jcam.perspective_wgpu(np.float32(math.radians(45)), np.float32(W / H),
                                           np.float32(0.1), np.float32(100)))
    return np.stack(views), np.stack(projs)


def test_batch_matches_per_frame_reference():
    W, H, grid = 320, 240, 128
    xyuv, idx = jmesh.build_grid_xyuv(grid)
    lut, _ = jcmap.build_lut("viridis")
    views, projs = _orbit(4, W, H)
    sun = np.array([0.5, 1.0, 0.3], np.float32) / np.float32(np.linalg.norm([0.5, 1.0, 0.3]))
    args = dict(spacing=1.0, exaggeration=1.0, h_min=-0.5, h_max=0.5, exposure=1.0,
                sun_dir=sun, lut=lut, width=W, height=H)
    heights = np.zeros((1, 1), np.float32)
    imgs = tpipe.render_terrain_batch_u32(xyuv, idx, heights, views, projs,
                                          device="cpu", **args)
    assert imgs.dtype == torch.uint32 and tuple(imgs.shape) == (4, H, W)
    rgba = _formats.u32_image_to_rgba_u8(imgs).numpy()
    for b in range(4):
        want = jpipe.render_terrain_u8(xyuv, idx, heights, views[b], projs[b],
                                       backend="jnp", fs_mode="shipped", **args)
        assert_fs_policy(rgba[b], want, f"batch frame {b}")
        one = tpipe.render_terrain_u8(xyuv, idx, heights, views[b], projs[b],
                                      device="cpu", **args)
        np.testing.assert_array_equal(one, rgba[b])


def test_render_png_writes_the_frame(tmp_path):
    t = vt.make_terrain(64, 48, 8, device="cpu")
    path = tmp_path / "spike.png"
    t.render_png(str(path))
    from PIL import Image
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), t.render_rgba())


def test_unported_modes_raise(monkeypatch):
    # VF_FILL_RULE=hw is ported (tests/test_torch_fillrule.py holds it to
    # the reference): it renders as vulkan_forge does.
    monkeypatch.setenv("VF_FILL_RULE", "hw")
    assert_fs_policy(vt.render_triangle_rgba(16, 16, device="cpu"),
                     vf.render_triangle_rgba(16, 16), "hw triangle 16x16")
    assert_fs_policy(vt.make_terrain(16, 16, 4, device="cpu").render_rgba(),
                     vf.make_terrain(16, 16, 4).render_rgba(), "hw terrain 16x16 g4")
    monkeypatch.delenv("VF_FILL_RULE")
    s = vt.make_terrain(16, 16, 4, device="cpu")
    args = dict(spacing=1.0, exaggeration=1.0, h_min=-0.5, h_max=0.5, exposure=1.0,
                sun_dir=s._globals.sun_dir, lut=s._lut, width=16, height=16, device="cpu")
    # The extended shader is ported (tests/test_torch_vtx.py holds it to the
    # reference); an unknown shader is refused.
    img = tpipe.render_terrain_u8(s._xyuv, s._indices, s._heights, s._view, s._proj,
                                  fs_mode="extended", **args)
    assert img.shape == (16, 16, 4) and img.dtype == np.uint8
    with pytest.raises(ValueError, match="fs_mode"):
        tpipe.render_terrain_u8(s._xyuv, s._indices, s._heights, s._view, s._proj,
                                fs_mode="fancy", **args)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        s.render_rgba()
