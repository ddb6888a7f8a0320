"""The comparison that decides ``correct``: the frames the timed path
returned, for a sample of the window's calls drawn from the seed, against
the plain reference's frames of the same inputs.

Two numbers, each against the cell's limit in ``limits/<cell>.json``:

- ``max_byte_gap``: the largest difference of one byte, over every byte of
  the compared frames;
- ``px_off_ppm``: pixels with any byte different, per million compared.

A frame of another shape reads 255 and 1e6.
"""
from __future__ import annotations

import numpy as np

from . import inputs as seeded

NUMBERS = ("max_byte_gap", "px_off_ppm")


class Sample:
    """A uniform sample of ``size`` of a stream of calls, drawn from the
    seed (reservoir sampling): which calls it keeps depends only on the
    seed and the number of calls."""

    def __init__(self, size: int, seed: int):
        self.size, self.kept, self.seen = size, [], 0
        self._draws = seeded.rng(seed, 3)

    def offer(self, inputs: dict, frames: np.ndarray) -> None:
        if len(self.kept) < self.size:
            self.kept.append((inputs, frames))
        else:
            j = int(self._draws.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = (inputs, frames)
        self.seen += 1


def compare(pairs) -> dict:
    """``NUMBERS`` over (got, want) pairs of (B, H, W, 4) uint8 frames."""
    gap, off, px = 0, 0, 0
    for got, want in pairs:
        if got.shape != want.shape:
            return {"max_byte_gap": 255, "px_off_ppm": 1e6}
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        gap = max(gap, int(d.max()))
        off += int(np.any(d > 0, axis=-1).sum())
        px += int(np.prod(d.shape[:-1]))
    return {"max_byte_gap": gap, "px_off_ppm": off / px * 1e6 if px else 1e6}


def judge(numbers: dict, limits: dict, failed: int) -> tuple:
    """(correct, checks): each number beside its limit, the failed calls
    beside 0; correct when none is over."""
    checks = {"failed_calls": {"value": failed, "limit": 0}}
    for name in NUMBERS:
        checks[name] = {"value": numbers[name], "limit": limits[name]}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
