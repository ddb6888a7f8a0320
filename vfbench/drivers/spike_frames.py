"""``vulkan_forge_torch.render_spike_frames``: each call renders
``eyes_per_call`` cameras on ``bench.py``'s orbit, at a phase drawn
uniformly from [0, 2 pi), over every device of the run."""
from __future__ import annotations

import math

import numpy as np

from .. import inputs as seeded
from ..generator import CALL_SPAN, Driver
from ..reference import scenes


def spike_work(config: dict, frames: int) -> dict:
    """``frame_inputs`` of ``frames`` spike frames: the grid's vertices and
    triangles, the 1 x 1 height texture, the shipped shader."""
    n = config["grid"]
    return {"frames": frames, "vertices": n * n, "triangles": 2 * (n - 1) ** 2, "texels": 1,
            "shader": "shipped", "width": config["width"], "height": config["height"]}


class Entry(Driver):

    entry = "render_spike_frames"

    def setup(self) -> None:
        import vulkan_forge_torch as vt
        self.vt = vt

    def inputs(self, k: int, stream: int = 0) -> dict:
        phase = float(self.draws(stream, k).uniform(0.0, 2.0 * math.pi))
        return {"phase": phase,
                "eyes": seeded.orbit_eyes(self.mix["eyes_per_call"], phase)}

    def call(self, inp: dict) -> np.ndarray:
        with self.span(f"{CALL_SPAN}.{self.entry}"):
            return self.vt.render_spike_frames(
                self.width, self.height, self.config["grid"], inp["eyes"],
                colormap=self.config["colormap"], devices=self.devices)

    def reference(self, inp: dict, device, tf32: bool = False) -> np.ndarray:
        return scenes.spike_frames(self.width, self.height, self.config["grid"],
                                   inp["eyes"], self.config["colormap"], device, tf32)

    def frame_inputs(self, inp: dict) -> dict:
        return spike_work(self.config, len(inp["eyes"]))
