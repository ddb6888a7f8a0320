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
from vulkan_forge import _dem as jdem, _uniforms as juni, _validate as jval

import vulkan_forge_torch as vt
from vulkan_forge_torch import _camera as tcam, _colormap as tcmap, _mesh as tmesh
from vulkan_forge_torch import _dem as tdem, _device as tdev, _io as tio
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


def test_dem_module_is_the_reference_copy():
    """The numpy copy of _dem gives the reference's values bit for bit:
    the percentile range with and without stride sampling, the f32 stats,
    both normalizations and the stored height range."""
    data = np.random.default_rng(4).normal(size=200_000).astype(np.float32)
    for clamp in (True, False):
        assert tdem.min_max(data, clamp) == jdem.min_max(data, clamp)
    small = data[:1000]
    assert tdem.min_max(small, True) == jdem.min_max(small, True)
    assert tdem.dem_stats_from_slice(data) == jdem.dem_stats_from_slice(data)
    stats = jdem.dem_stats_from_slice(data)
    for mode in ("minmax", "zscore"):
        a = tdem.normalize_in_place(data, mode, 1e-8, (0.0, 2.0), stats)
        b = jdem.normalize_in_place(data, mode, 1e-8, (0.0, 2.0), stats)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    ta, ja = tdem.TerrainMeta(), jdem.TerrainMeta()
    for m in (ta, ja):
        m.compute_and_store_h_range(data)
    assert (ta.h_min, ta.h_max) == (ja.h_min, ja.h_max)


def test_hw_oracle_is_the_reference_copy():
    """The port's copy of the fixed-point fill-rule oracle has the
    original's code, constants and answers: a random soup whose triangles
    cross the near plane, the far plane and w = 0 rasterizes to the same
    winners and attributes bit for bit."""
    import inspect
    from vulkan_forge._raster import hw_oracle as jhw
    from vulkan_forge_torch._raster import hw_oracle as thw
    for name in ("_clip_polygon", "_is_top_left", "rasterize_hw", "_raster_tri"):
        assert inspect.getsource(getattr(thw, name)) == inspect.getsource(getattr(jhw, name))
    for name in ("SUBPIX", "ONE", "HALF", "EPS_W"):
        assert getattr(thw, name) == getattr(jhw, name)
    rng = np.random.default_rng(9)
    n = 60
    w = rng.uniform(-0.3, 2.0, n * 3)
    clip = np.stack([rng.uniform(-1.2, 1.2, n * 3) * w, rng.uniform(-1.2, 1.2, n * 3) * w,
                     rng.uniform(-0.2, 1.2, n * 3) * w, w], axis=1)
    attrs = rng.uniform(-3, 3, (n * 3, 3))
    indices = np.arange(n * 3).reshape(-1, 3)
    (wid_t, out_t), (wid_j, out_j) = (m.rasterize_hw(clip, attrs, indices, 48, 40)
                                      for m in (thw, jhw))
    assert (wid_t >= 0).sum() > 100
    _same(wid_t, wid_j)
    _same(out_t, out_j)


def test_package_data_ships_every_csrc_include():
    """Every source in csrc/ and every file it includes with #include "..."
    is matched by pyproject.toml's package-data globs, so an installed
    vulkan_forge_torch can build its kernels."""
    import fnmatch
    import re
    import tomllib
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["vulkan_forge_torch"]
    pkg = os.path.join(REPO, "vulkan_forge_torch")
    csrc = os.path.join(pkg, "csrc")
    needed = set()
    for name in os.listdir(csrc):
        if name.endswith((".cu", ".cuh")):
            needed.add(f"csrc/{name}")
            with open(os.path.join(csrc, name)) as f:
                needed.update(f"csrc/{inc}" for inc in re.findall(r'#include "([^"]+)"', f.read()))
    assert {"csrc/raster_common.cuh", "csrc/packed.cu"} <= needed
    for rel in sorted(needed):
        assert os.path.exists(os.path.join(pkg, rel)), rel
        assert any(fnmatch.fnmatch(rel, g) for g in globs), f"{rel} is not in package-data"


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
    # The port's calls name the CPU (device=None means "cuda").
    cases = [
        (lambda m, **d: m.Scene(16, 16, 4, "plasma", **d),),
        (lambda m, **d: m.make_terrain(0, 10, **d),),
        (lambda m, **d: m.make_terrain(10, 10, grid=1, **d),),
        (lambda m, **d: m.make_terrain(10, 10, grid=5000, **d),),
        (lambda m, **d: m.render_triangle_rgba(8193, 10, **d),),
        (lambda m, **d: m.render_triangle_png(str(tmp_path / "x.jpg"), 8, 8, **d),),
        (lambda m, **d: m.Scene(16, 16, 4, **d).set_height_from_r32f(np.zeros((2, 2))),),
        (lambda m, **d: m.Scene(16, 16, 4, **d).set_height_from_r32f(
            np.zeros((4, 4), np.float32)[:, ::2]),),
        (lambda m, **d: m.TerrainSpike(16, 16, 4, **d).set_camera_look_at(
            (0, 5, 0), (0, 0, 0), (0, 1, 0), 45, 0.1, 10),),
    ]
    for (fn,) in cases:
        want = _error_of(fn, vf)
        assert want is not None
        assert _error_of(lambda m: fn(m, device="cpu"), vt) == want


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


def test_resolve_device_none_raises_without_card(monkeypatch):
    """None means "cuda": without a card it raises, and nothing falls back
    to the CPU (public entry points included)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="is_available"):
            tdev.resolve_device(device)
    with pytest.raises(RuntimeError, match="is_available"):
        vt.make_terrain(16, 16, 4)
    with pytest.raises(RuntimeError, match="is_available"):
        vt.render_triangle_rgba(16, 16)
    assert tdev.resolve_device("cpu") == torch.device("cpu")


TOOLS = ("device_diagnostics", "terrain_spike", "determinism_harness", "perf_sanity",
         "backends_runner", "parity_report")


def test_port_imports_without_jax():
    tools = ", ".join(f"vulkan_forge_torch.tools.{t}" for t in TOOLS)
    code = ("import sys, vulkan_forge_torch, vulkan_forge_torch._convert, "
            "vulkan_forge_torch._parity, vulkan_forge_torch._raster.kernels, "
            "vulkan_forge_torch._raster.hw_oracle, vulkan_forge_torch._parallel, "
            "vulkan_forge_torch._vulkan_forge, vulkan_forge_torch.types, "
            f"{tools}; "
            "assert 'jax' not in sys.modules, 'jax was imported'; "
            "assert 'vulkan_forge' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_api_surface_covers_the_reference():
    """Every name of the reference's ``__all__`` is exported, the compiled
    module's path is kept, and the package is typed (PEP 561)."""
    import inspect

    import vulkan_forge._vulkan_forge as jext
    import vulkan_forge_torch._vulkan_forge as ext
    from vulkan_forge import types as jtypes
    from vulkan_forge_torch import types as ttypes
    assert set(vf.__all__) <= set(vt.__all__)
    for name in vt.__all__:
        assert hasattr(vt, name), name
    assert ext.Renderer is vt.Renderer
    assert set(ext.__all__) == set(jext.__all__)
    for name in ext.__all__:
        assert getattr(ext, name) is getattr(vt, name), name
    assert (inspect.signature(ttypes.SupportsPNG.render_png)
            == inspect.signature(jtypes.SupportsPNG.render_png))
    assert os.path.exists(os.path.join(REPO, "vulkan_forge_torch", "py.typed"))
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        assert '"py.typed"' in f.read().split("vulkan_forge_torch = [")[1].split("]")[0]


def test_device_resolution():
    assert tdev.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert tdev.resolve_device(None).type == "cuda"
    with pytest.raises(ValueError):
        tdev.resolve_device("meta")
    info = tdev.device_info("cpu")
    assert info["torch"] == torch.__version__ and info["name"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tdev.resolve_device("cuda")
