"""One ``vulkan_forge_torch.Renderer`` on the run's first device, over a
pool of ``tiles`` seeded DEMs of the configuration's size. With
``ingest_each_call`` a call first loads the next tile of the pool
(``add_terrain`` and ``upload_height_r32f``); otherwise the set-up loads
tile 0 once. Then the call sets the sun (``sun_elevation_deg``,
``sun_azimuth_deg``) and the exposure, each a number or a [lo, hi) range
drawn per call, and calls ``render_rgba``."""
from __future__ import annotations

import numpy as np

from .. import inputs as seeded
from ..generator import CALL_SPAN, INGEST_SPAN, Driver, uniform_or_fixed
from ..reference import scenes


class Entry(Driver):

    entry = "Renderer.render_rgba"

    def setup(self) -> None:
        import vulkan_forge_torch as vt
        n = self.config["dem"]
        self.pool = [seeded.dem_tile(n, self.seed, k, self.device)
                     for k in range(self.mix["tiles"])]
        self.start = int(self.draws(2, 0).integers(self.mix["tiles"]))
        self.obj = vt.Renderer(self.width, self.height, device=self.device)
        if not self.mix["ingest_each_call"]:
            self._ingest(0)

    def _ingest(self, tile: int) -> None:
        cfg = self.config
        self.obj.add_terrain(self.pool[tile], tuple(cfg["spacing"]), cfg["exaggeration"],
                             cfg["colormap"])
        self.obj.upload_height_r32f()

    def inputs(self, k: int, stream: int = 0) -> dict:
        draws = self.draws(stream, k)
        # The warm-up (stream 1) steps back from the start, the window on,
        # so that the window's first call loads another tile than the last.
        step = k if stream == 0 else -1 - k
        tile = (self.start + step) % len(self.pool) if self.mix["ingest_each_call"] else 0
        return {"tile": tile,
                "sun": [uniform_or_fixed(draws, self.mix["sun_elevation_deg"]),
                        uniform_or_fixed(draws, self.mix["sun_azimuth_deg"])],
                "exposure": uniform_or_fixed(draws, self.mix["exposure"])}

    def call(self, inp: dict) -> np.ndarray:
        with self.span(f"{CALL_SPAN}.{self.entry}"):
            if self.mix["ingest_each_call"]:
                with self.span(INGEST_SPAN):
                    self._ingest(inp["tile"])
            self.obj.set_sun(*inp["sun"])
            self.obj.set_exposure(inp["exposure"])
            return self.obj.render_rgba()[None]

    def reference(self, inp: dict, device, tf32: bool = False) -> np.ndarray:
        cfg = self.config
        return scenes.renderer_frame(self.pool[inp["tile"]], tuple(cfg["spacing"]),
                                     cfg["exaggeration"], cfg["colormap"], inp["sun"],
                                     inp["exposure"], self.width, self.height, device, tf32)

    def frame_inputs(self, inp: dict) -> dict:
        n = self.config["dem"]
        return {"frames": 1, "vertices": n * n, "triangles": 2 * (n - 1) ** 2,
                "texels": n * n, "shader": "extended", "width": self.width,
                "height": self.height}

    def close(self) -> None:
        self.obj = None
