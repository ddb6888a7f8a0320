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

Ported: every name of the reference's ``__all__`` -- Renderer,
TerrainSpike, Scene, make_terrain, render_triangle_rgba/png,
camera_look_at/perspective/view_proj, colormap_supported,
dem_stats/dem_normalize, grid_generate/generate_grid,
enumerate_adapters/device_probe (CUDA, CPU, AUTO = the card) and
render_spike_frames (frames spread over torch devices) -- the
``_vulkan_forge`` module path, ``types.SupportsPNG``, and the six CLI tools
as ``python -m vulkan_forge_torch.tools.<name>``. Not ported: the JAX
package's relay and platform helpers, its ``__graft_entry__`` hooks and the
``vshade`` alias (ROADMAP).
"""
from __future__ import annotations

from ._validate import size_wh, png_path, grid as _grid

from ._renderer import Renderer
from ._scene import Scene, TerrainSpike
from ._camera import camera_look_at, camera_perspective, camera_view_proj
from ._colormap import colormap_supported
from ._dem import dem_normalize, dem_stats
from ._device import device_probe, enumerate_adapters
from ._io import save_png_rgba as _save_png_rgba
from ._mesh import grid_generate
from ._parallel import render_spike_frames
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
    "enumerate_adapters", "device_probe",
    "render_spike_frames",
]

# Static-typing surface (PEP 561: see py.typed), as the reference's
# (vulkan_forge/__init__.py:134-152), with ``device=``; these annotate the
# runtime functions above for type checkers only.
from typing import TYPE_CHECKING as _TYPE_CHECKING

if _TYPE_CHECKING:
    from typing import Tuple as _Tuple

    import numpy as _np

    def grid_generate(  # noqa: F811 (typing overlay of the runtime fn)
        nx: int,
        nz: int,
        spacing: "_Tuple[float, float]" = (1.0, 1.0),
        origin: str = "center",
    ) -> "_Tuple[_np.ndarray, _np.ndarray, _np.ndarray]": ...

    generate_grid = grid_generate

    def render_triangle_rgba(width: int, height: int, device=None) -> "_np.ndarray": ...
    def render_triangle_png(path: str, width: int, height: int, device=None) -> None: ...
    def make_terrain(width: int, height: int, grid: int = 128,
                     device=None) -> "TerrainSpike": ...
