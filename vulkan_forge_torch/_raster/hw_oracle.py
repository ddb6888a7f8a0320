"""Hardware-rule reference rasterizer (CPU, numpy, int64 fixed point).

The production rasterizer uses f32 edge functions with ALL edges inclusive
(deterministic under the max-id painter rule, docs/PARITY.md "Known
deltas"). Real GPUs rasterize on a snapped subpixel grid with the
top-left fill rule (Vulkan spec 25.8 "Basic Polygon Rasterization";
256 subpixel positions), so shared-edge pixels are covered by EXACTLY one
of two adjacent triangles. This module implements those hardware rules
bit-honestly -- 8.8 fixed-point vertex snapping, int64 edge functions
(exact: no rounding anywhere in coverage), top-left tie rule -- as the
yardstick for quantifying our fill-rule delta (python/tools/parity_report.py,
tests/test_fillrule.py).

Clipping: geometry is clipped against the WebGPU volume (0 <= z <= w,
w > 0) with float64 homogeneous Sutherland-Hodgman before snapping, the
same order hardware applies.

This is a verification oracle: O(T * bbox) Python/numpy, small scenes only.

Reference behavior anchors: CCW front + back-cull, no depth
(src/terrain/pipeline.rs:107-140); painter order = draw order.

A numpy-only copy of ``vulkan_forge/_raster/hw_oracle.py``: importing
``vulkan_forge`` loads jax, and ``chip_smoke.py`` holds the port's
``VF_FILL_RULE=hw`` coverage to this oracle on a machine without it.
``tests/test_torch_host.py`` holds the copy to the original.
"""
from __future__ import annotations

import numpy as np

SUBPIX = 8              # fractional bits (Vulkan minimum for fixed-point)
ONE = 1 << SUBPIX
HALF = ONE // 2
EPS_W = 1e-8


def _clip_polygon(verts, attrs):
    """S-H clip in homogeneous f64 against z>=0, w-z>=0, w>=EPS_W.

    verts: list of (4,) clip coords; attrs: list of (A,) attributes.
    """
    poly = list(zip(verts, attrs))
    for plane in (lambda v: v[2], lambda v: v[3] - v[2],
                  lambda v: v[3] - EPS_W):
        out = []
        n = len(poly)
        for i in range(n):
            a, aa = poly[i]
            b, ab = poly[(i + 1) % n]
            ha, hb = plane(a), plane(b)
            if ha >= 0:
                out.append((a, aa))
            if (ha >= 0) != (hb >= 0):
                t = ha / (ha - hb)
                out.append((a + t * (b - a), aa + t * (ab - aa)))
        poly = out
        if len(poly) < 3:
            return []
    return poly


def _is_top_left(ax, ay, bx, by):
    """Top-left classification of directed edge a->b (snapped ints,
    y-down framebuffer coords, interior on the POSITIVE side of our
    negated edge function).

    For a front (CCW in wgpu terms == clockwise in y-down pixel coords)
    polygon, interior-left edges run upward (by < ay) and the top edge
    runs rightward (by == ay and bx > ax).
    """
    if ay == by:
        return bx > ax          # horizontal: top edge
    return by < ay              # left edge


def rasterize_hw(clip, attrs, indices, width, height):
    """Rasterize with hardware rules.

    clip: (N, 4) float clip coords; attrs: (N, A) vertex attributes
    (perspective-interpolated); indices: (T, 3) draw order.
    Returns (winner_id (H,W) int32 [-1 empty], attr images (H,W,A) f64).
    """
    clip = np.asarray(clip, np.float64)
    attrs = np.asarray(attrs, np.float64)
    A = attrs.shape[1]
    wid = np.full((height, width), -1, np.int32)
    out = np.zeros((height, width, A))

    for t, tri in enumerate(np.asarray(indices)):
        poly = _clip_polygon([clip[i] for i in tri], [attrs[i] for i in tri])
        if len(poly) < 3:
            continue
        # project + snap to the subpixel grid
        pts = []
        for c, a in poly:
            x = (c[0] / c[3] * 0.5 + 0.5) * width
            y = (0.5 - c[1] / c[3] * 0.5) * height
            pts.append((int(round(x * ONE)), int(round(y * ONE)),
                        1.0 / c[3], a / c[3]))
        # post-clip orientation cull (shoelace in y-down snapped coords;
        # front == negative area, matching setup.py's convention)
        area = 0
        for i in range(len(pts)):
            x0, y0 = pts[i][0], pts[i][1]
            x1, y1 = pts[(i + 1) % len(pts)][0], pts[(i + 1) % len(pts)][1]
            area += x0 * y1 - x1 * y0
        if area >= 0:
            continue
        for k in range(1, len(pts) - 1):
            _raster_tri(pts[0], pts[k], pts[k + 1], t, wid, out,
                        width, height)
    return wid, out


def _raster_tri(p0, p1, p2, tid, wid, out, width, height):
    (x0, y0, rw0, a0), (x1, y1, rw1, a1), (x2, y2, rw2, a2) = p0, p1, p2
    xmin = max(min(x0, x1, x2), 0)
    xmax = min(max(x0, x1, x2), width * ONE)
    ymin = max(min(y0, y1, y2), 0)
    ymax = min(max(y0, y1, y2), height * ONE)
    px0 = max((xmin - HALF + ONE - 1) // ONE, 0)
    px1 = min((xmax - HALF) // ONE, width - 1)
    py0 = max((ymin - HALF + ONE - 1) // ONE, 0)
    py1 = min((ymax - HALF) // ONE, height - 1)
    if px0 > px1 or py0 > py1:
        return

    xs = (np.arange(px0, px1 + 1, dtype=np.int64) * ONE + HALF)[None, :]
    ys = (np.arange(py0, py1 + 1, dtype=np.int64) * ONE + HALF)[:, None]

    def edge(ax, ay, bx, by):
        # our negated-edge convention: interior >= 0 for front triangles
        e = ((np.int64(by) - ay) * (xs - ax)
             - (np.int64(bx) - ax) * (ys - ay))
        tie = _is_top_left(ax, ay, bx, by)
        return np.where(e > 0, True, (e == 0) & tie), e

    c0, e0 = edge(x1, y1, x2, y2)     # edge opposite v0
    c1, e1 = edge(x2, y2, x0, y0)
    c2, e2 = edge(x0, y0, x1, y1)
    cov = c0 & c1 & c2
    if not cov.any():
        return

    f0 = e0.astype(np.float64)
    f1 = e1.astype(np.float64)
    f2 = e2.astype(np.float64)
    aw = f0 * rw0 + f1 * rw1 + f2 * rw2
    with np.errstate(divide="ignore", invalid="ignore"):
        vals = (f0[..., None] * a0[None, None, :]
                + f1[..., None] * a1[None, None, :]
                + f2[..., None] * a2[None, None, :]) / aw[..., None]
    sly = slice(py0, py1 + 1)
    slx = slice(px0, px1 + 1)
    # painter: draw order overwrites (sub-triangles of one polygon never
    # overlap under the top-left rule)
    wid[sly, slx] = np.where(cov, tid, wid[sly, slx])
    out[sly, slx] = np.where(cov[..., None], vals, out[sly, slx])
