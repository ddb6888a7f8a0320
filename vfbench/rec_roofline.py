"""The least time of the record route's g-buffer kernel under the hardware
fill rule, ``vf_raster_gbuffer_hw`` (``vulkan_forge_torch/csrc/raster.cu``),
on what one call's frames hand it: ``chip_smoke.record_bound``'s rules
with ``hw=True`` and no fused shader.

Bytes: each binned record's cover columns and its three edge thresholds
read once (a culled record is never read), the varying columns of each
winner (at most min(covered pixels, binned records) of them) read once,
each (tile, record) pair's row and box read once, the tiles' offsets read
once, and each pixel's g-buffer written once (three f32 varyings and a
mask byte). Operations: COVER_OPS for every (pair, box pixel) item the
kernel walks, EVAL_OPS for every covered pixel (its winner's
evaluation), and the resolve per pixel. The peaks, EVAL_OPS and
RESOLVE_OPS are ``roofline``'s; the other constants are copied from
``chip_smoke.py``.
"""
from __future__ import annotations

from .roofline import EVAL_OPS, RESOLVE_OPS, bound_of

# chip_smoke.COVER_COLS: what the cover test reads of a binned record
# (columns 0..11 and 21..30) ...
COVER_COLS = 22
# ... and under hw its three edge thresholds (columns 31..33).
HW_COLS = 3
# chip_smoke.VARYING_COLS: what the resolve reads besides of each winner
# (the varying numerators, columns 12..20).
VARYING_COLS = 9
# chip_smoke.COVER_OPS: one pixel of a cover walk.
COVER_OPS = 38
# A pair's row and box, an offset (int32 each).
PAIR_BYTES = 2 * 4
OFFSET_BYTES = 4
# A pixel's g-buffer: v0, v1, v2 (f32) and the mask byte.
GBUFFER_PIXEL_BYTES = 3 * 4 + 1


def rec_bound(binned: float, pairs: float, offsets: float, items: float,
              covered: float, pixels: float) -> dict:
    """``roofline.bound_of`` the work of ``binned`` records with a pair,
    ``pairs`` (tile, record) pairs, ``offsets`` offset entries, ``items``
    walked (pair, box pixel) items, ``covered`` covered pixels and
    ``pixels`` frame pixels."""
    nbytes = (binned * (COVER_COLS + HW_COLS) * 4 + min(covered, binned) * VARYING_COLS * 4
              + pairs * PAIR_BYTES + offsets * OFFSET_BYTES + pixels * GBUFFER_PIXEL_BYTES)
    ops = items * COVER_OPS + covered * EVAL_OPS + pixels * RESOLVE_OPS
    return bound_of(nbytes, ops)
