"""``TerrainSpike`` and ``Scene`` API objects on torch.

Port of ``vulkan_forge/_scene.py:33-134``: the same defaults, error strings
and the silent clamp ``grid = max(grid, 2)``. The scene state stays numpy
on the host (mesh, camera matrices, height texture, LUT, globals); each
render copies it to ``self.device`` and runs the shipped terrain pipeline
there (``_raster/pipeline.py``).
"""
from __future__ import annotations

import math

import numpy as np

from . import _colormap, _mesh
from ._camera import look_at_rh, perspective_wgpu, validate_camera_params
from ._device import resolve_device
from ._io import save_png_rgba
from ._raster import pipeline as _pipeline
from ._uniforms import Globals, default_view_proj

TEXTURE_FORMAT = "Rgba8UnormSrgb"


class _TerrainObjectBase:
    """Shared state + render path for TerrainSpike/Scene."""

    _seed_sun_from_light: bool  # TerrainSpike seeds sun from the light vec

    def __init__(self, width: int, height: int, grid: "int | None" = 128,
                 colormap: "str | None" = "viridis", device=None):
        grid = 128 if grid is None else int(grid)
        grid = max(grid, 2)
        colormap_name = "viridis" if colormap is None else str(colormap)
        if colormap_name not in _colormap.SUPPORTED:
            raise _colormap.unknown_colormap_error(colormap_name)

        self.device = resolve_device(device)
        self.width = int(width)
        self.height = int(height)
        self.grid = grid

        self._xyuv, self._indices = _mesh.build_grid_xyuv(grid)
        view, proj, light = default_view_proj(self.width, self.height)
        self._view = view
        self._proj = proj

        self._globals = Globals()
        if self._seed_sun_from_light:
            self._globals.sun_dir = light  # src/terrain/mod.rs:327

        self._lut, self._lut_format = _colormap.build_lut(colormap_name)
        self._colormap_name = colormap_name
        self._heights = self._default_height()
        self._last_uniforms = self._globals.to_uniforms(self._view, self._proj)

    def _default_height(self) -> np.ndarray:
        raise NotImplementedError

    # ---- camera / uniforms ----

    def set_camera_look_at(self, eye, target, up, fovy_deg: float,
                           znear: float, zfar: float) -> None:
        """Parity: src/terrain/mod.rs:498-535 / src/scene/mod.rs:208-224."""
        validate_camera_params(eye, target, up, fovy_deg, znear, zfar)
        aspect = np.float32(self.width) / np.float32(self.height)
        self._view = look_at_rh(eye, target, up)
        self._proj = perspective_wgpu(
            np.float32(math.radians(float(fovy_deg))), aspect,
            np.float32(znear), np.float32(zfar))
        self._last_uniforms = self._globals.to_uniforms(self._view, self._proj)

    def debug_uniforms_f32(self) -> np.ndarray:
        """Raw 44-float UBO image (column-major matrices)."""
        return self._last_uniforms.copy()

    def debug_lut_format(self) -> str:
        return self._lut_format

    # ---- render ----

    def render_rgba(self) -> np.ndarray:
        """Shipped terrain pipeline -> (H, W, 4) uint8."""
        g = self._globals
        return _pipeline.render_terrain_u8(
            self._xyuv, self._indices.astype(np.int64).reshape(-1, 3),
            self._heights, self._view, self._proj,
            spacing=g.spacing, exaggeration=g.exaggeration,
            h_min=g.h_min, h_max=g.h_max,
            exposure=g.exposure, sun_dir=g.sun_dir,
            lut=self._lut, width=self.width, height=self.height,
            fs_mode="shipped", device=self.device)

    def render_png(self, path: str) -> None:
        save_png_rgba(str(path), self.render_rgba())


class TerrainSpike(_TerrainObjectBase):
    """Analytic terrain spike (parity: src/terrain/mod.rs:221-547)."""

    _seed_sun_from_light = True

    def _default_height(self) -> np.ndarray:
        # 1x1 zero dummy height texture (src/terrain/mod.rs:341-356).
        return np.zeros((1, 1), dtype=np.float32)


class Scene(_TerrainObjectBase):
    """Scene object with height upload (parity: src/scene/mod.rs:24-348)."""

    _seed_sun_from_light = False

    def _default_height(self) -> np.ndarray:
        # 2x2 gradient dummy so the first frame has variance
        # (src/scene/mod.rs:157).
        return np.array([[0.00, 0.25], [0.50, 0.75]], dtype=np.float32)

    def set_height_from_r32f(self, height_r32f) -> None:
        """Replace the height texture (parity: src/scene/mod.rs:227-276)."""
        a = height_r32f
        if not (isinstance(a, np.ndarray) and a.ndim == 2 and a.dtype == np.float32):
            raise TypeError("argument 'height_r32f': expected float32[H,W] ndarray")
        if not a.flags["C_CONTIGUOUS"]:
            raise RuntimeError("height must be C-contiguous float32[H,W]")
        self._heights = np.ascontiguousarray(a)
