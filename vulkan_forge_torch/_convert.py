"""Scene state carried across from a ``vulkan_forge`` object.

The renderer's equivalent of loading weights: ``scene_state_from_reference``
reads the numpy state of a ``vulkan_forge`` ``TerrainSpike``/``Scene`` (mesh,
height texture, camera, LUT, globals) and ``scene_from_reference`` builds
the port's object from it on a given device; ``renderer_state_from_reference``
and ``renderer_from_reference`` do the same for a ``Renderer`` (its DEM,
height range, sun, exposure and uploaded height texture). All work by duck
typing on attribute names, so this module imports nothing of
``vulkan_forge``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ._renderer import Renderer, TerrainData
from ._scene import Scene, TerrainSpike
from ._uniforms import Globals

_ARRAYS = ("_xyuv", "_indices", "_heights", "_view", "_proj", "_lut")
_GLOBALS = ("exposure", "spacing", "h_min", "h_max", "exaggeration")


def scene_state_from_reference(obj) -> Dict[str, Any]:
    """Copy the render state of a reference TerrainSpike/Scene into numpy."""
    kind = type(obj).__name__
    if kind not in ("TerrainSpike", "Scene"):
        raise TypeError(f"expected a TerrainSpike or Scene, got {kind}")
    state: Dict[str, Any] = {"kind": kind, "width": int(obj.width),
                             "height": int(obj.height), "grid": int(obj.grid),
                             "colormap": str(obj._colormap_name),
                             "lut_format": str(obj._lut_format)}
    for name in _ARRAYS:
        state[name.lstrip("_")] = np.array(getattr(obj, name), copy=True)
    g = obj._globals
    state["sun_dir"] = np.array(g.sun_dir, dtype=np.float32, copy=True)
    for name in _GLOBALS:
        state[name] = float(getattr(g, name))
    return state


def scene_from_state(state: Dict[str, Any], device=None):
    """Build the port's TerrainSpike/Scene from ``scene_state_from_reference``."""
    cls = {"TerrainSpike": TerrainSpike, "Scene": Scene}[state["kind"]]
    obj = cls(state["width"], state["height"], state["grid"], state["colormap"],
              device=device)
    for name in _ARRAYS:
        setattr(obj, name, np.array(state[name.lstrip("_")], copy=True))
    obj._lut_format = state["lut_format"]
    obj._globals = Globals(sun_dir=np.array(state["sun_dir"], dtype=np.float32),
                           **{k: state[k] for k in _GLOBALS})
    obj._last_uniforms = obj._globals.to_uniforms(obj._view, obj._proj)
    return obj


def scene_from_reference(obj, device=None):
    """The port's equivalent of a reference TerrainSpike/Scene, on ``device``."""
    return scene_from_state(scene_state_from_reference(obj), device=device)


_TERRAIN = ("width", "height", "spacing", "exaggeration", "colormap")


def renderer_state_from_reference(r) -> Dict[str, Any]:
    """Copy the state of a reference ``Renderer`` into numpy: its size, the
    stored (exaggerated) heights with spacing, exaggeration and colormap
    (or None without a terrain), h_min/h_max, sun_dir, exposure, and the
    uploaded height texture (or None if none was uploaded)."""
    kind = type(r).__name__
    if kind != "Renderer":
        raise TypeError(f"expected a Renderer, got {kind}")
    terr = r._terrain
    tex = r._height_tex
    return {
        "width": int(r.width), "height": int(r.height),
        "terrain": None if terr is None else {
            **{name: getattr(terr, name) for name in _TERRAIN},
            "heights": np.array(terr.heights, dtype=np.float32, copy=True)},
        "h_min": float(r._terrain_meta.h_min), "h_max": float(r._terrain_meta.h_max),
        "sun_dir": np.array(r._globals.sun_dir, dtype=np.float32, copy=True),
        "exposure": float(r._globals.exposure),
        "height_tex": None if tex is None else np.array(tex, dtype=np.float32, copy=True),
    }


def renderer_from_state(state: Dict[str, Any], device=None) -> Renderer:
    """Build the port's Renderer from ``renderer_state_from_reference``."""
    r = Renderer(state["width"], state["height"], device=device)
    if state["terrain"] is not None:
        t = state["terrain"]
        r._terrain = TerrainData(**{name: t[name] for name in _TERRAIN},
                                 heights=np.array(t["heights"], dtype=np.float32, copy=True))
    r._terrain_meta.h_min, r._terrain_meta.h_max = state["h_min"], state["h_max"]
    r._globals.sun_dir = np.array(state["sun_dir"], dtype=np.float32, copy=True)
    r._globals.exposure = state["exposure"]
    if state["height_tex"] is not None:
        r._height_tex = torch.as_tensor(np.array(state["height_tex"], dtype=np.float32),
                                        device=r.device)
    return r


def renderer_from_reference(r, device=None) -> Renderer:
    """The port's equivalent of a reference ``Renderer``, on ``device``."""
    return renderer_from_state(renderer_state_from_reference(r), device=device)
