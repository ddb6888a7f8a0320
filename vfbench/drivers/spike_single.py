"""One ``vulkan_forge_torch.TerrainSpike`` on the run's first device; each
call moves its camera (``set_camera_look_at``, fovy 45, near 0.1, far 100)
to the next eye on ``bench.py``'s orbit, ``step_deg`` on from the last,
from a seeded start, then calls ``render_rgba``."""
from __future__ import annotations

import math

import numpy as np

from .. import inputs as seeded
from ..generator import CALL_SPAN, Driver
from ..reference import scenes
from .spike_frames import spike_work


class Entry(Driver):

    entry = "TerrainSpike.render_rgba"

    def setup(self) -> None:
        import vulkan_forge_torch as vt
        self.obj = vt.TerrainSpike(self.width, self.height, self.config["grid"],
                                   colormap=self.config["colormap"], device=self.device)
        self.start = float(self.draws(2, 0).uniform(0.0, 360.0))

    def inputs(self, k: int, stream: int = 0) -> dict:
        # The warm-up (stream 1) steps back from the start, the window on.
        step = k if stream == 0 else -1 - k
        deg = (self.start + step * self.mix["step_deg"]) % 360.0
        return {"angle_deg": deg, "eye": seeded.orbit_eyes(1, math.radians(deg))[0]}

    def call(self, inp: dict) -> np.ndarray:
        with self.span(f"{CALL_SPAN}.{self.entry}"):
            self.obj.set_camera_look_at(inp["eye"], (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                                        45.0, 0.1, 100.0)
            return self.obj.render_rgba()[None]

    def reference(self, inp: dict, device, tf32: bool = False) -> np.ndarray:
        return scenes.spike_frames(self.width, self.height, self.config["grid"],
                                   [inp["eye"]], self.config["colormap"], device, tf32)

    def frame_inputs(self, inp: dict) -> dict:
        return spike_work(self.config, 1)

    def close(self) -> None:
        self.obj = None
