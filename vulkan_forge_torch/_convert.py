"""Scene state carried across from a ``vulkan_forge`` object.

The renderer's equivalent of loading weights: ``scene_state_from_reference``
reads the numpy state of a ``vulkan_forge`` ``TerrainSpike``/``Scene`` (mesh,
height texture, camera, LUT, globals) and ``scene_from_reference`` builds
the port's object from it on a given device. Both work by duck typing on
attribute names, so this module imports nothing of ``vulkan_forge``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

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
