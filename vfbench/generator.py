"""The one general traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and drives one public entry of the program in a
closed loop with one client.

A mix names its ``entry``: the driver module ``drivers/<entry>.py``,
found by name, whose class ``Entry`` drives that public entry with the
mix's parameters; a configuration (``configs/<config>.json``) gives the
scene. A later mix that only changes parameters (more eyes a call, other
sun ranges, a larger tile pool) adds a data file, a later scene size a
configuration file, and a later public entry a driver module (with its
plain reference under ``reference/``): files, never an edit.

Every driver has:

- ``setup()``: builds the program's objects and whatever the calls share;
- ``inputs(k)``: the k-th call's inputs, a JSON-able dict drawn from the
  seed (stream 0 for the window, stream 1 for the warm-up);
- ``call(inputs)``: the public call(s) of one request, returning the
  (B, H, W, 4) uint8 frames the caller gets;
- ``reference(inputs, device, tf32)``: the plain reference's frames of the
  same request;
- ``frame_inputs(inputs)``: what the frame roofline counts (see
  ``roofline.py``).

A driver runs on ``devices``, one per chip the cell asks for: an entry
that takes a device list gets them all, an object of one device the first.
"""
from __future__ import annotations

import contextlib
import importlib

import numpy as np

from . import inputs as seeded

# Record-function ranges the traced run opens around the public calls.
CALL_SPAN = "vfbench.call"
INGEST_SPAN = "vfbench.ingest"


def uniform_or_fixed(draws, value):
    """A number stays as it is; [lo, hi] is drawn uniformly from [lo, hi)."""
    if isinstance(value, (int, float)):
        return float(value)
    lo, hi = value
    return float(draws.uniform(lo, hi))


class Driver:
    """What every driver shares: the scene, the frame, the seed and the
    devices."""

    entry = ""

    def __init__(self, config: dict, mix: dict, seed: int, devices, span=None):
        self.config, self.mix, self.seed = config, mix, seed
        self.devices = list(devices)
        self.device = self.devices[0]
        self.width, self.height = config["width"], config["height"]
        self.span = span or (lambda name: contextlib.nullcontext())

    def draws(self, stream: int, k: int) -> np.random.Generator:
        return seeded.rng(self.seed, stream, k)

    def close(self) -> None:
        """Drop the program's objects."""


def driver_class(entry: str):
    """The ``Entry`` class of ``drivers/<entry>.py``."""
    return importlib.import_module(f"vfbench.drivers.{entry}").Entry


def build(config: dict, mix: dict, seed: int, devices, span=None) -> Driver:
    """The driver that ``mix["entry"]`` names, for this scene, seed and
    devices."""
    if config["scene"] not in mix["scenes"]:
        raise ValueError(f"traffic {mix['name']!r} drives {mix['scenes']} scenes, "
                         f"not {config['scene']!r}")
    return driver_class(mix["entry"])(config, mix, seed, devices, span)
