"""The least time one request's frames could take on the card, counted per
frame from what the frame must read, write and compute, whatever kernels
and routes render it.

Peaks and the f32 operation counts of the raster work are copied from
``chip_smoke.py`` (``PEAK_BYTES``, ``PEAK_F32``, ``EVAL_OPS``,
``RESOLVE_OPS``, ``SHADE_OPS``, ``TEST_OPS``, ``bound_of``): one H100 SXM at
700 W, HBM 3.35 TB/s and 67 TFLOP/s in f32 outside the tensor cores. The
vertex stages and the extended shader are counted here from the port's
sources by the same rules: add, sub, mul, div, min, max, compare,
floor/ceil and conversions count one, a fused multiply-add two,
sin/cos/pow/sqrt one each; selects, gathers and predicate logic nothing.

Bytes: each input counted once, the returned frames written once. The
grid's topology and x/z positions follow from its size and are not
counted, nor is an index buffer. Counted: the height texture, the LUT
(256 x 4 f32), each frame's view and projection (2 x 64 bytes) and its
RGBA8 frame. Operations: the vertex stage per vertex, the triangle test
per triangle, and the evaluation, resolve and shader per covered pixel.
A covered pixel is one whose returned bytes are not the clear colour, so
a covered pixel shaded exactly as the clear colour is not counted: the
count can only fall short, and the share only read low.
"""
from __future__ import annotations

import numpy as np

PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
EVAL_OPS, RESOLVE_OPS, SHADE_OPS, TEST_OPS = 52, 5, 75, 100

# The vertex stage (transform.py, setup.clip_to_fb). Once per vertex,
# whatever the camera: the nearest height sample 10 (u*w, floor, clamp as
# 2, conversion; for u and v) and the world position's 3 multiplies; the
# shipped stage adds the analytic relief 7 (two mul, sin and cos, two mul
# by 0.25, an add) and its sum 1. Once per vertex and frame: two 4x4
# transforms 56 (4 x (4 mul + 3 add) each) and clip_to_fb 10 (the |w|
# test, three divides, two viewport maps of 3).
VS_SHARED_OPS = {"shipped": 10 + 3 + 7 + 1, "extended": 10 + 3}
VS_FRAME_OPS = 56 + 10
# The extended shader per pixel (fragment.terrain_fs_extended): height
# normalisation 4, bilinear LUT 21 (coordinate 11, weight 1, three channels
# of two multiplies and an add), texel indices 10, neighbours 8, steps 4,
# two slopes 10, normal length 6, Lambert 7, ambient 2, exposure and
# Reinhard 12, sRGB encode 24 (8 a channel), quantisation 18 (6 a channel).
EXTENDED_SHADE_OPS = 4 + 21 + 10 + 8 + 4 + 10 + 6 + 7 + 2 + 12 + 24 + 18
PIXEL_OPS = {"shipped": EVAL_OPS + RESOLVE_OPS + SHADE_OPS,
             "extended": EVAL_OPS + RESOLVE_OPS + EXTENDED_SHADE_OPS}
LUT_BYTES = 256 * 4 * 4
CAMERA_BYTES = 2 * 16 * 4


def bound_of(nbytes, ops, peak=PEAK_F32):
    """The least time for the work: the larger of its bytes over HBM's rate
    and its operations over the peak rate; and what binds."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
    return {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "ops": ops}


def covered_pixels(frames: np.ndarray, clear) -> int:
    """Pixels of (B, H, W, 4) uint8 ``frames`` whose bytes are not ``clear``."""
    return int(np.any(frames != np.asarray(clear, dtype=np.uint8), axis=-1).sum())


def request_work(frame_inputs: dict, covered: int):
    """(bytes, ops) one request must move and compute: ``frame_inputs``
    from the driver (frames, vertices, triangles, texels, shader, width,
    height) and the request's covered pixels over all its frames."""
    f = frame_inputs
    frames = f["frames"]
    nbytes = (f["texels"] * 4 + LUT_BYTES
              + frames * (CAMERA_BYTES + f["width"] * f["height"] * 4))
    ops = (f["vertices"] * (VS_SHARED_OPS[f["shader"]] + frames * VS_FRAME_OPS)
           + frames * f["triangles"] * TEST_OPS + covered * PIXEL_OPS[f["shader"]])
    return nbytes, ops
