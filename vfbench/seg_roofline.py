"""The least time of the segment walk's g-buffer kernel, ``vf_seg_gbuffer``
(``vulkan_forge_torch/csrc/segments.cu``), on what one call's frame hands
it: ``chip_smoke.seg_bound``'s rules for a g-buffer launch (no fused
shader).

Bytes: each compacted record read once (its 31 live columns, its id and
its 4-word bbox), the walk tables the kernel reads read once, and each
pixel's g-buffer written once (three f32 varyings and a mask byte).
Operations: EVAL_OPS for every pixel of every (8x128 tile, record) pair
the kernel evaluates, and the resolve per pixel. The peaks, EVAL_OPS and
RESOLVE_OPS are ``roofline``'s, copied from ``chip_smoke.py``.
"""
from __future__ import annotations

from .roofline import EVAL_OPS, RESOLVE_OPS, bound_of

# chip_smoke.seg_bound: a record's setup.NUM_COLS (31) live columns, its
# id and its bbox, 4 bytes each ...
RECORD_WORDS = 31 + 1 + 4
# ... and a pixel's g-buffer: v0, v1, v2 (f32) and the mask byte.
GBUFFER_PIXEL_BYTES = 3 * 4 + 1
# The pixels of the walk's tile, segments.TILE_H x TILE_W.
TILE_PIXELS = 8 * 128
# vf_seg_gbuffer's device kernel as the trace names it (the shipped
# shader's is seg_kernel<true>).
KERNEL = "seg_kernel<false>"


def seg_bound(records: float, table_bytes: float, pairs: float, pixels: float) -> dict:
    """``roofline.bound_of`` the work of ``records`` compacted records,
    ``table_bytes`` of walk tables, ``pairs`` evaluated (tile, record)
    pairs and ``pixels`` frame pixels."""
    nbytes = records * RECORD_WORDS * 4 + table_bytes + pixels * GBUFFER_PIXEL_BYTES
    ops = pairs * TILE_PIXELS * EVAL_OPS + pixels * RESOLVE_OPS
    return bound_of(nbytes, ops)
