"""The port's ``Renderer`` against ``vulkan_forge.Renderer`` (CPU).

(b) Frames: a reference Renderer is set up through its public API and
carried across with ``_convert.renderer_from_reference`` (the same DEM,
height range, sun, exposure and height texture), and each package renders
it. Images are held to the FS policy (every differing byte off by 1, on at
most 1e-4 of the bytes); the port's frames take the indexed-mesh route.
(c) The API: behaviour and error strings of every method, mirroring
tests/test_height_roundtrip.py, tests/test_dem.py and tests/test_lighting.py
on both packages.
"""
import json
import math

import numpy as np
import pytest
import torch

import vulkan_forge as vf

import vulkan_forge_torch as vt
from vulkan_forge_torch import _convert, _mesh as tmesh, _renderer as trend
from vulkan_forge_torch._parity import assert_fs_policy
from vulkan_forge_torch._raster import kernels

# The plain raster is a loop of small eager ops: one intra-op thread is the
# fastest setting on the CPU and keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)


def _dem(rows, cols, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:rows, 0:cols] / np.float32(max(rows, cols))
    h = sum(rng.uniform(5, 30) * np.sin(2 * math.pi * (rng.uniform(1, 3) * x
                                                       + rng.uniform(1, 3) * y + rng.uniform()))
            for _ in range(5))
    return h.astype(np.float32)


def _ramp(shape, dtype=np.float32):
    h, w = shape
    return np.linspace(0.0, 1.0, num=h * w, dtype=dtype).reshape(h, w)


# ---------------- (b) frames against the reference ----------------

# name -> (DEM rows, cols, W, H, spacing, exaggeration, colormap, sun, exposure, upload)
FRAMES = {
    # Cells of ~25 px: most triangles exceed the 64-pixel bbox of the
    # cover pass and take the big-triangle pass.
    "dem_9x12_200x150_big": (9, 12, 200, 150, (30.0, 30.0), 1.5, "terrain", (35.0, 120.0),
                             1.0, True),
    "dem_40x56_160x120": (40, 56, 160, 120, (10.0, 12.0), 2.0, "magma", (50.0, 300.0),
                          1.3, False),
    # T = 2 * 109 * 95 = 20,710: above the JAX package's 20,000-triangle
    # packed-kernel threshold (pipeline.py:66).
    "dem_96x110_128x96": (96, 110, 128, 96, (5.0, 5.0), 1.0, "viridis", (25.0, 45.0),
                          0.8, True),
}


def _reference(name):
    rows, cols, W, H, spacing, exag, cmap, sun, exposure, upload = FRAMES[name]
    r = vf.Renderer(W, H)
    r.add_terrain(_dem(rows, cols, rows * cols), spacing, exag, cmap)
    r.set_sun(*sun)
    r.set_exposure(exposure)
    if upload:
        r.upload_height_r32f()
    return r


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_renderer_frame_matches_reference(name, monkeypatch):
    ref = _reference(name)
    port = _convert.renderer_from_reference(ref, device="cpu")
    calls = []
    fn = kernels.packed_resolve_gbuffer
    monkeypatch.setattr(kernels, "packed_resolve_gbuffer",
                        lambda *a, **k: (calls.append(1), fn(*a, **k))[1])
    got = port.render_rgba()
    assert calls == [1], "the Renderer's frame must take the indexed-mesh route"
    assert got.dtype == np.uint8 and got.shape == (ref.height, ref.width, 4)
    assert_fs_policy(got, ref.render_rgba(), name)
    # The same state built natively through the port's API renders the same bytes.
    rows, cols, W, H, spacing, exag, cmap, sun, exposure, upload = FRAMES[name]
    native = vt.Renderer(W, H, device="cpu")
    native.add_terrain(_dem(rows, cols, rows * cols), spacing, exag, cmap)
    native.set_sun(*sun)
    native.set_exposure(exposure)
    if upload:
        native.upload_height_r32f()
    np.testing.assert_array_equal(native.render_rgba(), got)


def test_carried_state_round_trips():
    ref = _reference("dem_9x12_200x150_big")
    ref.set_height_range(-3.0, 40.0)
    state = _convert.renderer_state_from_reference(ref)
    assert state["h_min"] == -3.0 and state["h_max"] == 40.0
    assert state["terrain"]["colormap"] == "terrain"
    port = _convert.renderer_from_state(state, device="cpu")
    assert isinstance(port, vt.Renderer) and port.device == torch.device("cpu")
    np.testing.assert_array_equal(port.read_full_height_texture(),
                                  ref.read_full_height_texture())
    assert port.terrain_stats() == ref.terrain_stats()
    np.testing.assert_array_equal(port._globals.sun_dir, ref._globals.sun_dir)
    bare = _convert.renderer_from_reference(vf.Renderer(8, 8), device="cpu")
    assert bare._terrain is None and bare._height_tex is None
    with pytest.raises(TypeError, match="Renderer"):
        _convert.renderer_state_from_reference(vf.Scene(8, 8, 2))


@pytest.mark.parametrize("rows,cols,dx,dy", [(2, 2, 1.0, 1.0), (5, 9, 10.0, 12.0),
                                             (33, 17, 0.5, 3.0), (260, 300, 30.0, 30.0)])
def test_grid_mesh_equals_make_grid(rows, cols, dx, dy):
    """The device mesh is make_grid's, with the Renderer's [0, 2, 1] flip
    (vulkan_forge/_renderer.py:271-279), bit for bit."""
    xy, uv, idx = tmesh.make_grid(cols, rows, dx, dy)
    xyuv, tris = trend.grid_mesh(cols, rows, dx, dy, "cpu")
    np.testing.assert_array_equal(xyuv.numpy(), np.concatenate([xy, uv], axis=1))
    assert tris.dtype == torch.int32
    np.testing.assert_array_equal(tris.numpy(),
                                  np.asarray(idx, np.int64).reshape(-1, 3)[:, [0, 2, 1]])


# ---------------- (c) the API against the reference ----------------

def _error_of(fn):
    try:
        fn()
    except Exception as err:  # noqa: BLE001 -- comparing what each side raises
        return type(err), str(err)
    return None


def _new(mod, w=8, h=8):
    return mod.Renderer(w, h, device="cpu") if mod is vt else mod.Renderer(w, h)


def _with_terrain(mod, hm=None, upload=False):
    r = _new(mod)
    r.add_terrain(_ramp((4, 4)) if hm is None else hm, (1.0, 1.0), 1.0, "viridis")
    if upload:
        r.upload_height_r32f()
    return r


ERROR_CASES = {
    "spacing": lambda m: _new(m).add_terrain(_ramp((4, 4)), (0.0, 1.0), 1.0, "viridis"),
    "exaggeration": lambda m: _new(m).add_terrain(_ramp((4, 4)), (1.0, 1.0), 0.0, "viridis"),
    "int_heightmap": lambda m: _new(m).add_terrain(_ramp((4, 4)).astype(np.int32), (1.0, 1.0)),
    "1d_heightmap": lambda m: _new(m).add_terrain(np.zeros(5, np.float32), (1.0, 1.0)),
    "fortran_heightmap": lambda m: _new(m).add_terrain(np.asfortranarray(_ramp((4, 5))),
                                                       (1.0, 1.0)),
    "empty_heightmap": lambda m: _new(m).add_terrain(np.zeros((0, 3), np.float32), (1.0, 1.0)),
    "colormap": lambda m: _new(m).add_terrain(_ramp((4, 4)), (1.0, 1.0), 1.0, "plasma"),
    "stats_no_terrain": lambda m: _new(m).terrain_stats(),
    "upload_no_terrain": lambda m: _new(m).upload_height_r32f(),
    "render_no_terrain": lambda m: _new(m).render_rgba(),
    "normalize_no_terrain": lambda m: _new(m).normalize_terrain("minmax"),
    "normalize_mode": lambda m: _with_terrain(m).normalize_terrain("median"),
    "full_texture_no_upload": lambda m: _with_terrain(m).read_full_height_texture(),
    "patch_zero": lambda m: _with_terrain(m, upload=True).debug_read_height_patch(0, 0, 0, 2),
    "patch_x": lambda m: _with_terrain(m, upload=True).debug_read_height_patch(2, 0, 3, 4),
    "patch_y": lambda m: _with_terrain(m, upload=True).debug_read_height_patch(0, 2, 4, 3),
    "range_equal": lambda m: _new(m).set_height_range(1.0, 1.0),
    "range_reversed": lambda m: _new(m).set_height_range(2.0, -3.0),
    "range_nan": lambda m: _new(m).set_height_range(float("nan"), 1.0),
    "exposure_zero": lambda m: _new(m).set_exposure(0.0),
    "exposure_inf": lambda m: _new(m).set_exposure(float("inf")),
    "sun_nan": lambda m: _new(m).set_sun(float("nan"), 0.0),
    "png_path": lambda m: _with_terrain(m).render_png("/nonexistent_dir_vf/x.png"),
    "dem_stats_1d": lambda m: m.dem_stats(np.zeros(4, dtype=np.float32)),
    "dem_stats_int": lambda m: m.dem_stats(np.zeros((4, 4), dtype=np.int32)),
    "dem_stats_fortran": lambda m: m.dem_stats(np.asfortranarray(np.zeros((4, 5), np.float32))),
    "dem_normalize_mode": lambda m: m.dem_normalize(_ramp((4, 4)), mode="log"),
}


@pytest.mark.parametrize("name", sorted(ERROR_CASES))
def test_api_errors_match_reference(name):
    want = _error_of(lambda: ERROR_CASES[name](vf))
    assert want is not None
    assert _error_of(lambda: ERROR_CASES[name](vt)) == want


def test_height_texture_round_trip():
    """tests/test_height_roundtrip.py on the port: exact f32 round trips at
    widths whose rows are not 256-byte aligned, patches, zeros before an
    upload, and normalize_terrain reaching the next upload."""
    assert np.all(_new(vt).debug_read_height_patch(0, 0, 4, 2) == 0.0)
    assert _new(vt).debug_read_height_patch(0, 0, 4, 2).shape == (2, 4)
    for h, w in [(5, 7), (3, 255), (17, 61)]:
        hm = np.arange(w * h, dtype=np.float32).reshape(h, w) / (w * h)
        a, b = _with_terrain(vt, hm, upload=True), _with_terrain(vf, hm, upload=True)
        assert a._height_tex.dtype == torch.float32 and a._height_tex.device.type == "cpu"
        np.testing.assert_array_equal(a.read_full_height_texture(), hm)
        for args in [(1, 1, 3, 2), (0, 0, w, 1), (w - 1, h - 1, 1, 1)]:
            got = a.debug_read_height_patch(*args)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, b.debug_read_height_patch(*args))
    for m in (vt, vf):
        r = _with_terrain(m, upload=True)
        before = r.read_full_height_texture().copy()
        r.normalize_terrain("minmax", range=(10.0, 20.0), eps=None)
        np.testing.assert_array_equal(r.read_full_height_texture(), before)
        r.upload_height_r32f()
        assert r.read_full_height_texture().min() >= 9.99
    np.testing.assert_array_equal(_with_terrain(vt, upload=True).read_full_height_texture(),
                                  _with_terrain(vf, upload=True).read_full_height_texture())


def test_stats_normalize_and_range_match_reference():
    """tests/test_dem.py on both packages: identical values."""
    for m_a, m_b in [(vt, vf)]:
        for mode, rng, eps in [("minmax", (10.0, 20.0), None), ("zscore", None, 1e-6),
                               ("MinMax", None, None)]:
            a = _new(m_a)
            b = _new(m_b)
            hm = np.linspace(0.0, 1.0, 16, dtype=np.float64).reshape(4, 4)
            for r in (a, b):
                r.add_terrain(hm, (1.0, 1.0), 2.0, colormap="magma")
                r.normalize_terrain(mode, range=rng, eps=eps)
            assert a.terrain_stats() == b.terrain_stats()
            np.testing.assert_array_equal(a._terrain.heights, b._terrain.heights)
        a, b = _new(m_a), _new(m_b)
        h = np.linspace(-10.0, 50.0, 32 * 32, dtype=np.float32).reshape(32, 32)
        for r in (a, b):
            r.add_terrain(h, (1.0, 1.0), 1.0, "viridis")
        assert (a._terrain_meta.h_min, a._terrain_meta.h_max) == \
            (b._terrain_meta.h_min, b._terrain_meta.h_max)
        for r in (a, b):
            r.set_height_range(-5.0, 40.0)
        assert (a._terrain_meta.h_min, a._terrain_meta.h_max) == (-5.0, 40.0)


@pytest.mark.parametrize("fn,args,kw", [
    ("dem_stats", (), {}),
    ("dem_normalize", (), {"mode": "minmax", "out_range": (2.0, 5.0)}),
    ("dem_normalize", (), {"mode": "zscore", "return_stats": True}),
])
def test_dem_helpers_match_reference(fn, args, kw):
    z = np.sin(np.linspace(-1, 1, 20 * 16, dtype=np.float32)).reshape(16, 20)

    def flat(x):
        return [a for v in x for a in flat(v)] if isinstance(x, tuple) else [np.asarray(x)]
    got, want = flat(getattr(vt, fn)(z, *args, **kw)), flat(getattr(vf, fn)(z, *args, **kw))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_metrics_trace_info_and_png(tmp_path, monkeypatch):
    r = _new(vt, 64, 48)
    assert r.info() == vf.Renderer(64, 48).info() == "Renderer 64x48, format=Rgba8UnormSrgb"
    empty = r.render_metrics()
    assert empty == vf.Renderer(64, 48).render_metrics()
    trace = tmp_path / "trace.jsonl"
    monkeypatch.setenv("VF_TRACE", str(trace))
    r.add_terrain(_dem(12, 14, 1), (10.0, 10.0), 1.0, "terrain")
    img = r.render_rgba()
    m = r.render_metrics()
    assert set(m) == set(empty)
    assert m["bytes"] == 64 * 48 * 4 and (m["width"], m["height"]) == (64, 48)
    assert m["render_ms"] >= 0.0 and m["readback_ms"] >= 0.0
    assert m["total_ms"] == pytest.approx(m["render_ms"] + m["readback_ms"])
    lines = trace.read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == m
    path = tmp_path / "dem.png"
    r.render_png(str(path))
    from PIL import Image
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
    assert len(trace.read_text().splitlines()) == 2
    tri = r.render_triangle_rgba()
    np.testing.assert_array_equal(tri, vt.render_triangle_rgba(64, 48, device="cpu"))
    np.testing.assert_array_equal(tri, vf.Renderer(64, 48).render_triangle_rgba())
    r.render_triangle_png(str(path))
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), tri)


def test_default_camera_matches_reference():
    for rows, cols, sp in [(9, 12, (30.0, 30.0)), (100, 40, (5.0, 2.0))]:
        a, b = _new(vt, 160, 90), _new(vf, 160, 90)
        for r in (a, b):
            r.add_terrain(_ramp((rows, cols)), sp, 1.0, "viridis")
        for x, y in zip(a._default_terrain_camera(a._terrain),
                        b._default_terrain_camera(b._terrain)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_sun_and_exposure_change_the_frame():
    """tests/test_lighting.py's east/west flip and exposure order, on the port."""
    def render(azimuth, exposure=1.0):
        r = vt.Renderer(96, 96, device="cpu")
        yy, xx = np.mgrid[0:64, 0:64]
        bump = (50.0 * np.exp(-((xx - 31.5) ** 2 + (yy - 31.5) ** 2) / (64 ** 2) / 0.0648))
        r.add_terrain(bump.astype(np.float32), (30.0, 30.0), 1.0, "viridis")
        r.set_sun(45.0, azimuth)
        r.set_exposure(exposure)
        rgb = r.render_rgba()[..., :3].astype(np.float32) / 255.0
        return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    east, west = render(90.0), render(270.0)
    rows = range(48 - 12, 48 + 13, 3)
    assert all(east[y, 48 + 12] > east[y, 48 - 12] for y in rows)
    assert all(west[y, 48 - 12] > west[y, 48 + 12] for y in rows)
    assert render(90.0, 2.0).mean() > render(90.0, 0.5).mean()


def test_device_none_means_cuda(monkeypatch):
    """Renderer(..., device=None) targets the card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        vt.Renderer(16, 16)
    assert vt.Renderer(16, 16, device="cpu").device == torch.device("cpu")

