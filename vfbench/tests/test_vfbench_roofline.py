"""The frame roofline's count: the same bytes and operations for a frame
whichever route renders it, and a count by hand for a 2 x 2 grid."""
from __future__ import annotations

import numpy as np
import pytest

from vulkan_forge_torch import _colormap, _formats, _mesh
from vulkan_forge_torch._camera import look_at_rh, perspective_wgpu
from vulkan_forge_torch._raster import pipeline
from vfbench import roofline
from vfbench.reference import raster

W, H, GRID = 80, 60, 12


def frame_through(route_grid_n):
    """The spike at GRID drawn with the extended shader through the vtx
    route (``grid_n`` given) or the indexed route (None), one camera."""
    xyuv, idx = _mesh.build_grid_xyuv(GRID)
    heights = (np.arange(GRID * GRID, dtype=np.float32).reshape(GRID, GRID) % 7) * 0.05
    view = look_at_rh((2.5, 2.0, 2.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))[None]
    proj = perspective_wgpu(np.float32(np.radians(45.0)), np.float32(W / H),
                            np.float32(0.1), np.float32(100.0))[None]
    img = pipeline.render_terrain_batch_u32(
        xyuv, idx, heights, view, proj, spacing=1.0, exaggeration=1.0, h_min=-0.5,
        h_max=0.5, exposure=1.0, sun_dir=np.array([0.5, 0.8, 0.3], np.float32),
        lut=_colormap.build_lut("terrain")[0], width=W, height=H, fs_mode="extended",
        grid_n=route_grid_n, device="cpu")
    return _formats.u32_image_to_rgba_u8(img).numpy()


def test_same_count_whichever_route():
    assert pipeline.use_vtx_route(GRID, GRID * GRID, 2 * (GRID - 1) ** 2)
    assert pipeline.use_indexed_route(None, "extended")
    vtx, indexed = frame_through(GRID), frame_through(None)
    assert np.array_equal(vtx, indexed)
    f = {"frames": 1, "vertices": GRID * GRID, "triangles": 2 * (GRID - 1) ** 2,
         "texels": GRID * GRID, "shader": "extended", "width": W, "height": H}
    clear = raster.clear_bytes()
    counts = [roofline.request_work(f, roofline.covered_pixels(img, clear))
              for img in (vtx, indexed)]
    assert counts[0] == counts[1]
    assert 0 < roofline.covered_pixels(vtx, clear) < W * H


def test_hand_count_of_a_2x2_grid():
    """4 vertices, 2 triangles, one 8 x 6 frame of which 10 pixels are
    covered, shipped shader, the 1 x 1 height texture."""
    f = {"frames": 1, "vertices": 4, "triangles": 2, "texels": 1, "shader": "shipped",
         "width": 8, "height": 6}
    nbytes, ops = roofline.request_work(f, 10)
    # texture 4 + LUT 4096 + view and projection 128 + frame 8*6*4 = 192
    assert nbytes == 4 + 4096 + 128 + 192
    # vertices 4 * (21 shared + 66 a frame), triangle tests 2 * 100,
    # pixels 10 * (52 evaluate + 5 resolve + 75 shade)
    assert ops == 4 * (21 + 66) + 2 * 100 + 10 * (52 + 5 + 75)
    # two frames share the texture, the LUT and the vertices' shared work
    nbytes2, ops2 = roofline.request_work({**f, "frames": 2}, 20)
    assert nbytes2 == 4 + 4096 + 2 * (128 + 192)
    assert ops2 == 4 * (21 + 2 * 66) + 2 * 2 * 100 + 20 * 132


def test_covered_pixels_and_bound():
    clear = raster.clear_bytes()
    frames = np.tile(np.array(clear, np.uint8), (2, 3, 4, 1))
    frames[0, 1, 2] = (40, 39, 48, 255)
    frames[1, 0, 0, 3] = 254
    assert roofline.covered_pixels(frames, clear) == 2
    b = roofline.bound_of(3.35e9, 67e9)
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "bytes"
    assert roofline.bound_of(1, 67e12)["bound_by"] == "operations"
