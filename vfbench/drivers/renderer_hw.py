"""``renderer``'s calls under the configuration's fill rule: each call sets
``VF_FILL_RULE`` to the configuration's ``fill_rule`` ("hw": the 8.8
snap and the top-left rule, which take every frame through the record
route) and puts the previous value back when the call returns, so that
nothing else in the process sees it. The reference is
``raster_hw.renderer_frame_hw``."""
from __future__ import annotations

import contextlib
import os

import numpy as np

from ..reference import raster_hw
from . import renderer

VARIABLE = "VF_FILL_RULE"


@contextlib.contextmanager
def fill_rule(rule: str):
    """``VF_FILL_RULE`` set to ``rule`` inside, as it was after."""
    before = os.environ.get(VARIABLE)
    os.environ[VARIABLE] = rule
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(VARIABLE, None)
        else:
            os.environ[VARIABLE] = before


class Entry(renderer.Entry):

    def call(self, inp: dict) -> np.ndarray:
        with fill_rule(self.config["fill_rule"]):
            return super().call(inp)

    def reference(self, inp: dict, device, tf32: bool = False) -> np.ndarray:
        cfg = self.config
        return raster_hw.renderer_frame_hw(self.pool[inp["tile"]], tuple(cfg["spacing"]),
                                           cfg["exaggeration"], cfg["colormap"], inp["sun"],
                                           inp["exposure"], self.width, self.height, device,
                                           tf32)
