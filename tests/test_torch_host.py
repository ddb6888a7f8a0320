"""Host layer of the PyTorch port against ``vulkan_forge``.

The port carries numpy-only copies of the reference's host modules (mesh,
camera, LUT, uniforms, validators) because importing ``vulkan_forge`` loads
jax. These copies must give byte-equal outputs and the same error strings.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import vulkan_forge as vf
from vulkan_forge import _camera as jcam, _colormap as jcmap, _mesh as jmesh
from vulkan_forge import _uniforms as juni, _validate as jval

import vulkan_forge_torch as vt
from vulkan_forge_torch import _camera as tcam, _colormap as tcmap, _mesh as tmesh
from vulkan_forge_torch import _device as tdev, _io as tio
from vulkan_forge_torch import _uniforms as tuni, _validate as tval

# The plain raster is a loop of small eager ops: one intra-op thread is the
# fastest setting on the CPU and keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n", [2, 16, 128])
def test_build_grid_xyuv_byte_equal(n):
    for a, b in zip(tmesh.build_grid_xyuv(n), jmesh.build_grid_xyuv(n)):
        _same(a, b)


@pytest.mark.parametrize("nx,nz,spacing", [(3, 2, (1.0, 1.0)), (33, 17, (0.5, 2.0)),
                                           (160, 130, (1.0, 1.0))])
def test_grid_generate_byte_equal(nx, nz, spacing):
    # 160x130 >= 16384 vertices: the reference takes its native path there.
    for a, b in zip(vt.grid_generate(nx, nz, spacing), vf.grid_generate(nx, nz, spacing)):
        _same(a, b)
    assert vt.generate_grid is vt.grid_generate


CAMERAS = [((3.0, 2.0, 3.0), (0, 0, 0), (0, 1, 0), 45.0, 0.1, 100.0),
           ((2.0, 1.5, 2.5), (0, 0, 0), (0, 1, 0), 50.0, 0.1, 50.0),
           ((-0.3, 0.05, 0.2), (1.5, -0.2, 1.5), (0, 1, 0), 70.0, 0.01, 10.0)]


@pytest.mark.parametrize("cam", CAMERAS)
def test_camera_matrices_byte_equal(cam):
    eye, target, up, fovy, zn, zf = cam
    _same(tcam.look_at_rh(eye, target, up), jcam.look_at_rh(eye, target, up))
    _same(tcam.camera_look_at(eye, target, up), jcam.camera_look_at(eye, target, up))
    for clip in ("wgpu", "gl"):
        _same(tcam.camera_perspective(fovy, 1.5, zn, zf, clip),
              jcam.camera_perspective(fovy, 1.5, zn, zf, clip))
        _same(tcam.camera_view_proj(eye, target, up, fovy, 1.25, zn, zf, clip),
              jcam.camera_view_proj(eye, target, up, fovy, 1.25, zn, zf, clip))


@pytest.mark.parametrize("name", ["viridis", "magma", "terrain"])
@pytest.mark.parametrize("unorm", [False, True])
def test_build_lut_byte_equal(name, unorm, monkeypatch):
    if unorm:
        monkeypatch.setenv("VF_FORCE_LUT_UNORM", "1")
    lut_t, fmt_t = tcmap.build_lut(name)
    lut_j, fmt_j = jcmap.build_lut(name)
    _same(lut_t, lut_j)
    assert fmt_t == fmt_j


def test_uniforms_byte_equal():
    view = jcam.look_at_rh((3, 2, 3), (0, 0, 0), (0, 1, 0))
    proj = jcam.perspective_wgpu(np.float32(0.7), np.float32(1.3), np.float32(0.1),
                                 np.float32(100))
    _same(tuni.pack_uniforms(view, proj, [0.1, 0.9, 0.2], 1.2, 0.5, 2.0, 1.5),
          juni.pack_uniforms(view, proj, [0.1, 0.9, 0.2], 1.2, 0.5, 2.0, 1.5))
    _same(tuni.Globals().to_uniforms(view, proj), juni.Globals().to_uniforms(view, proj))
    for a, b in zip(tuni.default_view_proj(800, 600), juni.default_view_proj(800, 600)):
        _same(a, b)
    _same(tuni.sun_dir_spherical(35.0, 120.0), juni.sun_dir_spherical(35.0, 120.0))


def _error_of(fn, *args):
    try:
        fn(*args)
    except Exception as err:  # noqa: BLE001 -- comparing what each side raises
        return type(err), str(err)
    return None


@pytest.mark.parametrize("fn_name,args", [
    ("size_wh", (0, 10)), ("size_wh", (9000, 0)), ("size_wh", (9000, 10)),
    ("size_wh", ("x", 10)), ("grid", (1,)), ("grid", (5000,)), ("grid", (None,)),
    ("png_path", ("out.jpg",)), ("png_path", ("/nonexistent_dir_vf/x.png",)),
])
def test_validator_errors_match(fn_name, args):
    want = _error_of(getattr(jval, fn_name), *args)
    assert want is not None
    assert _error_of(getattr(tval, fn_name), *args) == want


@pytest.mark.parametrize("args", [
    ((0, 0, 0), (0, 0, 0), (0, 1, 0), 45, 0.1, 10),       # degenerate view dir
    ((0, 5, 0), (0, 0, 0), (0, 1, 0), 45, 0.1, 10),       # up colinear
    ((1, 1, 1), (0, 0, 0), (0, 1, 0), 180, 0.1, 10),      # fovy
    ((1, 1, 1), (0, 0, 0), (0, 1, 0), 45, 0.0, 10),       # znear
    ((1, 1, 1), (0, 0, 0), (0, 1, 0), 45, 1.0, 0.5),      # zfar
    ((float("nan"), 1, 1), (0, 0, 0), (0, 1, 0), 45, 0.1, 10),
])
def test_camera_errors_match(args):
    want = _error_of(jcam.validate_camera_params, *args)
    assert want is not None
    assert _error_of(tcam.validate_camera_params, *args) == want
    assert _error_of(vt.camera_look_at, *args[:3]) == \
        _error_of(vf.camera_look_at, *args[:3])
    assert _error_of(vt.camera_perspective, 45, 0.0, 0.1, 10) == \
        _error_of(vf.camera_perspective, 45, 0.0, 0.1, 10)
    assert _error_of(vt.camera_perspective, 45, 1.0, 0.1, 10, "dx") == \
        _error_of(vf.camera_perspective, 45, 1.0, 0.1, 10, "dx")


def test_public_api_errors_match(tmp_path):
    assert vt.colormap_supported() == vf.colormap_supported()
    cases = [
        (lambda m: m.Scene(16, 16, 4, "plasma"),),
        (lambda m: m.make_terrain(0, 10),),
        (lambda m: m.make_terrain(10, 10, grid=1),),
        (lambda m: m.make_terrain(10, 10, grid=5000),),
        (lambda m: m.render_triangle_rgba(8193, 10),),
        (lambda m: m.render_triangle_png(str(tmp_path / "x.jpg"), 8, 8),),
        (lambda m: m.Scene(16, 16, 4).set_height_from_r32f(np.zeros((2, 2))),),
        (lambda m: m.Scene(16, 16, 4).set_height_from_r32f(
            np.zeros((4, 4), np.float32)[:, ::2]),),
        (lambda m: m.TerrainSpike(16, 16, 4).set_camera_look_at(
            (0, 5, 0), (0, 0, 0), (0, 1, 0), 45, 0.1, 10),),
    ]
    for (fn,) in cases:
        want = _error_of(fn, vf)
        assert want is not None
        assert _error_of(fn, vt) == want


def test_scene_defaults_match():
    for cls in ("TerrainSpike", "Scene"):
        a = getattr(vt, cls)(64, 48, 1, None, device="cpu")
        b = getattr(vf, cls)(64, 48, 1, None)
        assert a.grid == b.grid == 2          # silent clamp, _scene.py:41
        for name in ("_xyuv", "_indices", "_view", "_proj", "_lut", "_heights"):
            _same(getattr(a, name), getattr(b, name))
        _same(a._globals.sun_dir, b._globals.sun_dir)
        _same(a.debug_uniforms_f32(), b.debug_uniforms_f32())
        assert a.debug_lut_format() == b.debug_lut_format()
        a.set_camera_look_at((2, 1, 2), (0, 0, 0), (0, 1, 0), 40.0, 0.2, 20.0)
        b.set_camera_look_at((2, 1, 2), (0, 0, 0), (0, 1, 0), 40.0, 0.2, 20.0)
        _same(a.debug_uniforms_f32(), b.debug_uniforms_f32())


def _png_decode(path) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        assert im.mode == "RGBA"
        return np.asarray(im)


@pytest.mark.parametrize("h,w", [(1, 1), (7, 13), (64, 48)])
def test_png_writer_round_trips(tmp_path, h, w):
    img = np.random.default_rng(h * 100 + w).integers(0, 256, (h, w, 4), dtype=np.uint8)
    path = tmp_path / "img.png"
    tio.save_png_rgba(str(path), img)
    np.testing.assert_array_equal(_png_decode(path), img)
    with pytest.raises(RuntimeError, match="Invalid image buffer"):
        tio.save_png_rgba(str(path), img[..., :3])


def test_triangle_png_matches_rgba(tmp_path):
    path = tmp_path / "tri.png"
    vt.render_triangle_png(str(path), 40, 24, device="cpu")
    np.testing.assert_array_equal(_png_decode(path),
                                  vt.render_triangle_rgba(40, 24, device="cpu"))


def test_port_imports_without_jax():
    code = ("import sys, vulkan_forge_torch, vulkan_forge_torch._convert, "
            "vulkan_forge_torch._parity, vulkan_forge_torch._raster.kernels; "
            "assert 'jax' not in sys.modules, 'jax was imported'; "
            "assert 'vulkan_forge' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_device_resolution():
    assert tdev.resolve_device("cpu") == torch.device("cpu")
    assert tdev.resolve_device(None).type == ("cuda" if torch.cuda.is_available() else "cpu")
    with pytest.raises(ValueError):
        tdev.resolve_device("meta")
    info = tdev.device_info("cpu")
    assert info["torch"] == torch.__version__ and info["name"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tdev.resolve_device("cuda")
