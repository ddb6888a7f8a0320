"""vulkan-forge on PyTorch + CUDA: a port of the ``vulkan_forge`` package.

The same public API and error strings as ``vulkan_forge`` (the JAX/Pallas
reference, ``vulkan_forge/__init__.py:120-129``) for the part ported so
far, with an explicit ``device=`` argument ("cuda", "cpu", or None, which
means "cuda" and raises without a card). On a CUDA device the raster stage
runs the hand-written kernels in ``csrc/raster.cu`` (triangle records),
``csrc/vtx.cu`` (dense grid meshes), ``csrc/packed.cu`` (indexed meshes:
the Renderer's DEMs) and ``csrc/segments.cu`` (tall single frames); on the
CPU it runs their plain PyTorch versions. This package imports torch and
never jax.

Ported: Renderer, TerrainSpike, Scene, make_terrain,
render_triangle_rgba/png, camera_look_at/perspective/view_proj,
colormap_supported, dem_stats/dem_normalize, grid_generate/generate_grid,
the extended fragment shader. Not yet: device_probe/enumerate_adapters,
render_spike_frames (ROADMAP queue 1).
"""
from __future__ import annotations

from ._validate import size_wh, png_path, grid as _grid

from ._renderer import Renderer
from ._scene import Scene, TerrainSpike
from ._camera import camera_look_at, camera_perspective, camera_view_proj
from ._colormap import colormap_supported
from ._dem import dem_normalize, dem_stats
from ._io import save_png_rgba as _save_png_rgba
from ._mesh import grid_generate
from ._raster import pipeline as _pipeline

__version__ = "0.2.0"


def render_triangle_rgba(width: int, height: int, device=None):
    """Render a deterministic triangle and return (H, W, 4) uint8."""
    w, h = size_wh(width, height)
    return _pipeline.render_triangle_u8(w, h, device=device)


def render_triangle_png(path: str, width: int, height: int, device=None) -> None:
    """Render a deterministic triangle and write it as a PNG file to `path`."""
    w, h = size_wh(width, height)
    _save_png_rgba(png_path(path), _pipeline.render_triangle_u8(w, h, device=device))


def make_terrain(width: int, height: int, grid: int = 128, device=None):
    """Helper constructor for TerrainSpike."""
    w, h = size_wh(width, height)
    g = _grid(grid)
    return TerrainSpike(w, h, g, device=device)


# Legacy alias for T11 compatibility
generate_grid = grid_generate

__all__ = [
    "Renderer", "render_triangle_rgba", "render_triangle_png", "make_terrain",
    "colormap_supported", "camera_look_at", "camera_perspective",
    "camera_view_proj", "__version__",
    "TerrainSpike", "Scene",
    "dem_stats", "dem_normalize",
    "grid_generate", "generate_grid",
]
