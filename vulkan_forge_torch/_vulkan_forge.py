"""Module-path shim mirroring the compiled ``_vulkan_forge`` extension.

The reference exposes its PyO3 module as ``vulkan_forge._vulkan_forge``, and
``vulkan_forge/_vulkan_forge.py`` keeps that path for the JAX package
(registration parity: src/lib.rs:962-976). This module carries the same
names, re-exported from the port.
"""
from __future__ import annotations

from ._camera import camera_look_at, camera_perspective, camera_view_proj
from ._colormap import colormap_supported
from ._device import device_probe, enumerate_adapters
from ._mesh import grid_generate
from ._renderer import Renderer
from ._scene import Scene, TerrainSpike

__all__ = [
    "Renderer", "TerrainSpike", "Scene",
    "enumerate_adapters", "device_probe", "grid_generate",
    "colormap_supported",
    "camera_look_at", "camera_perspective", "camera_view_proj",
]
