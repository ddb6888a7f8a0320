"""Triangle setup and framebuffer-tile binning on torch tensors.

Port of ``vulkan_forge/_raster/setup.py`` (conventions, record layout and
the near/far clip functionals are documented there, lines 1-74). Records
are (..., T+1, REC_WIDTH) f32 rows, columns 0..30 in the layout of
``setup.py:21-39`` (and, under the "hw" fill rule, the per-edge coverage
thresholds at 31..33), row T an all-zero sentinel. Every column is computed
with the same f32 ops in the same order as ``setup_fields_core``; torch
evaluates each op with one rounding, so the port is bit-equal to XLA where
XLA does not contract a multiply-add (ROADMAP queue 3).

All functions accept a leading batch axis (one frame per camera) on the
per-vertex inputs; the mesh ``indices`` are shared by all frames.

Binning is the port's own (``bin_tiles``): the JAX ``bin_triangles``
builds a (tiles x triangles) overlap matrix with a static capacity because
XLA needs static shapes; eager torch does not, so the port lists
(tile, triangle) pairs in triangle order and sorts them stably by tile.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _trace

REC_WIDTH = 40
NUM_COLS = 31

# The port's raster tile: 16 x 16 pixels, one CUDA thread per pixel. It
# must equal kTile in csrc/raster.cu, which kernels.load() checks.
TILE = 16

_W_EPS = 1e-8   # "in front of camera" threshold on clip w (hardware: w > 0)

# Fill rules. "inclusive" (the default) covers every pixel centre on an
# edge; "hw" is Vulkan's fixed-point rule (``VF_FILL_RULE=hw``,
# ``vulkan_forge/_raster/setup.py:116-129``): vertices snap to the 8.8
# subpixel grid and records carry one coverage threshold per edge at
# columns 31..33 -- 0 for top-left edges (e == 0 covered), _HW_BIAS for the
# rest (e == 0 excluded). Snapped edge functions are multiples of 2^-16, so
# "e > 0" is "e >= 2^-16" exactly while the f32 edge products stay exact.
FILL_RULES = ("inclusive", "hw")
BIAS0_COL, BIAS1_COL, BIAS2_COL = 31, 32, 33
HW_COLS = 34                # live record columns under the hw rule
_HW_SNAP = 256.0            # 8.8 fixed point (Vulkan's minimum subpixel bits)
_HW_BIAS = 2.0 ** -16       # one lattice step of the snapped edge function


def snap_hw(v: torch.Tensor) -> torch.Tensor:
    """Framebuffer coordinates on the 8.8 subpixel grid: round half to even,
    as ``jnp.round`` and the oracle's ``round`` do; exact in f32 for
    |v| < 2^15 (1/256 is a power of two)."""
    return torch.round(v * _HW_SNAP) * (1.0 / _HW_SNAP)


def check_fill_rule(fill_rule: str) -> str:
    if fill_rule not in FILL_RULES:
        raise ValueError(f"fill_rule must be one of {FILL_RULES}, got {fill_rule!r}")
    return fill_rule


def clip_to_fb(clip: torch.Tensor, width: int, height: int):
    """Clip space -> framebuffer coords (WebGPU viewport transform).

    clip: (..., 4). Returns (x_fb, y_fb, z_ndc, w_clip), each (...,).
    NDC y-up flips to framebuffer y-down.
    """
    w = clip[..., 3]
    safe_w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    ndc_x = clip[..., 0] / safe_w
    ndc_y = clip[..., 1] / safe_w
    ndc_z = clip[..., 2] / safe_w
    x_fb = (ndc_x * 0.5 + 0.5) * width
    y_fb = (0.5 - ndc_y * 0.5) * height
    return x_fb, y_fb, ndc_z, w


def _crossing(xa, ya, wa, za, xb, yb, wb, zb):
    """Near-plane (z_clip = 0) crossing of edge a->b: (x, y, ok)."""
    denom = za - zb
    safe = torch.where(torch.abs(denom) < 1e-30, 1e-30, denom)
    t = za / safe
    crosses = (za < 0.0) != (zb < 0.0)
    wx = wa + t * (wb - wa)
    Xa, Ya = xa * wa, ya * wa
    Xb, Yb = xb * wb, yb * wb
    X = Xa + t * (Xb - Xa)
    Y = Ya + t * (Yb - Ya)
    ok = crosses & (wx > _W_EPS)
    rw = 1.0 / torch.where(torch.abs(wx) < 1e-30, 1e-30, wx)
    return X * rw, Y * rw, ok


def _srw(w):
    """1/w with the sign kept where |w| < 1e-12."""
    tiny = torch.where(w < 0.0, -1e-12, 1e-12)
    return 1.0 / torch.where(torch.abs(w) < 1e-12, tiny, w)


def setup_fields_core(c0, c1, c2, width: int, height: int,
                      fill_rule: str = "inclusive"):
    """Triangle setup from per-corner per-FIELD tensors (field order:
    x_fb, y_fb, w_clip, var0, var1, var2, z_ndc). Under the "hw" fill rule
    the coordinates must already be snapped (``snap_hw``).

    Returns (cols, px0, px1, py0, py1, valid): the NUM_COLS record column
    tensors (HW_COLS under "hw": the three edge thresholds follow), the
    int32 pixel-center bbox (pre-invalid-encoding) and the bool valid flag
    (already folded into cols[24]).
    """
    x0, y0, w0, zn0 = c0[0], c0[1], c0[2], c0[6]
    x1, y1, w1, zn1 = c1[0], c1[1], c1[2], c1[6]
    x2, y2, w2, zn2 = c2[0], c2[1], c2[2], c2[6]

    # Signed double area, math shoelace in framebuffer (y-down) coords.
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    neg0, neg1_, neg2 = w0 < 0.0, w1 < 0.0, w2 < 0.0
    odd_neg = neg0 ^ neg1_ ^ neg2
    front = torch.where(odd_neg, area2, -area2) > 0.0
    finite = (torch.isfinite(x0) & torch.isfinite(x1) & torch.isfinite(x2)
              & torch.isfinite(y0) & torch.isfinite(y1) & torch.isfinite(y2))

    # Clip-volume-nonempty tests (vertex extrema of linear z and w).
    zc0, zc1, zc2 = zn0 * w0, zn1 * w1, zn2 * w2      # clip z
    any_near = torch.maximum(torch.maximum(zc0, zc1), zc2) >= 0.0
    any_w = torch.maximum(torch.maximum(w0, w1), w2) > _W_EPS
    any_far = torch.minimum(torch.minimum(zc0 - w0, zc1 - w1), zc2 - w2) <= 0.0

    clean = (w0 > _W_EPS) & (w1 > _W_EPS) & (w2 > _W_EPS)

    # ---- pixel-center bbox (centers at integer+0.5) ----
    cx01, cy01, ok01 = _crossing(x0, y0, w0, zc0, x1, y1, w1, zc1)
    cx12, cy12, ok12 = _crossing(x1, y1, w1, zc1, x2, y2, w2, zc2)
    cx20, cy20, ok20 = _crossing(x2, y2, w2, zc2, x0, y0, w0, zc0)
    vok0 = zc0 >= 0.0
    vok1 = zc1 >= 0.0
    vok2 = zc2 >= 0.0

    big = torch.full_like(x0, 3.4e37)

    def mm(sel, vals, init, op):
        out = init
        for s, v in zip(sel, vals):
            out = op(out, torch.where(s, v, init))
        return out

    sels = [vok0, vok1, vok2, ok01, ok12, ok20]
    xs = [x0, x1, x2, cx01, cx12, cx20]
    ys = [y0, y1, y2, cy01, cy12, cy20]
    xmin = mm(sels, xs, big, torch.minimum)
    xmax = mm(sels, xs, -big, torch.maximum)
    ymin = mm(sels, ys, big, torch.minimum)
    ymax = mm(sels, ys, -big, torch.maximum)
    # w-crossing triangles: conservative full screen.
    xmin = torch.where(clean, xmin, 0.0)
    xmax = torch.where(clean, xmax, float(width))
    ymin = torch.where(clean, ymin, 0.0)
    ymax = torch.where(clean, ymax, float(height))

    def to_px(v, rnd):
        return rnd(torch.clamp(v, -1e9, 1e9) - 0.5).to(torch.int32)

    px0 = torch.clamp_min(to_px(xmin, torch.ceil), 0)
    px1 = torch.clamp_max(to_px(xmax, torch.floor), width - 1)
    py0 = torch.clamp_min(to_px(ymin, torch.ceil), 0)
    py1 = torch.clamp_max(to_px(ymax, torch.floor), height - 1)
    covers = (px0 <= px1) & (py0 <= py1)

    valid = front & finite & any_near & any_w & any_far & covers

    # SIGNED reciprocals keep the projective functionals exact on the
    # clipped region (setup.py "Near-plane clipping").
    rw0, rw1, rw2 = _srw(w0), _srw(w1), _srw(w2)

    one = torch.ones_like(x0)
    s0 = torch.where(neg1_ ^ neg2, -one, one)
    s1 = torch.where(neg2 ^ neg0, -one, one)
    s2 = torch.where(neg0 ^ neg1_, -one, one)
    tau = torch.where(area2 > 0.0, -one, one)
    t0, t1, t2 = s0 * tau, s1 * tau, s2 * tau

    cols = [
        x1, y1, (y2 - y1) * s0, (x2 - x1) * s0,    # edge opp v0
        x2, y2, (y0 - y2) * s1, (x0 - x2) * s1,    # edge opp v1
        x0, y0, (y1 - y0) * s2, (x1 - x0) * s2,    # edge opp v2
    ]
    for k in range(3):
        cols += [c0[3 + k] * rw0 * t0, c1[3 + k] * rw1 * t1,
                 c2[3 + k] * rw2 * t2]
    cols += [rw0 * t0, rw1 * t1, rw2 * t2, valid.to(torch.float32)]
    cols += [zn0 * t0, zn1 * t1, zn2 * t2]         # near-clip functional
    cols += [t0, t1, t2]                           # constant-1 (far clip)

    if check_fill_rule(fill_rule) == "hw":
        # Top-left rule per directed edge (hw_oracle._is_top_left on the
        # snapped coordinates, y down): a horizontal edge is "top" iff it
        # runs rightward, any other is "left" iff it runs upward. A
        # w-crossing triangle keeps the inclusive rule (bias 0): hardware
        # clips it into sub-polygons whose shared diagonals never tie.
        zero, bias = torch.zeros_like(x0), torch.full_like(x0, _HW_BIAS)

        def edge_bias(ax, ay, bx, by):
            horiz = ay == by
            topleft = (horiz & (bx > ax)) | (~horiz & (by < ay))
            return torch.where(topleft | ~clean, zero, bias)

        cols += [edge_bias(x1, y1, x2, y2),        # edge opp v0
                 edge_bias(x2, y2, x0, y0),        # edge opp v1
                 edge_bias(x0, y0, x1, y1)]        # edge opp v2
    return cols, px0, px1, py0, py1, valid


def vertex_terms(c):
    """The per-vertex terms of setup: ``vf::VertexTerms``
    (csrc/raster_common.cuh), which ``vf_vtx_cover`` computes once per
    vertex of its patch. ``c``: one corner's 7 field tensors (the field
    order of ``setup_fields_core``). Returns a dict: x, y, w, zc = z_ndc*w
    (clip z), zn = z_ndc, rw = the signed 1/w and vr = [v_k * rw], the ops
    ``setup_fields_core`` does per corner. With ``setup_from_terms``, the
    torch mirror of the cover kernels' factored setup, for tests."""
    w, zn = c[2], c[6]
    rw = _srw(w)
    return {"x": c[0], "y": c[1], "w": w, "zc": zn * w, "zn": zn, "rw": rw,
            "vr": [c[3 + k] * rw for k in range(3)]}


def _crossing_if_straddling(a, b):
    """``_crossing`` of edge a->b (vertex terms) computed only where its ends
    straddle z_clip = 0, as the kernels' setup_bbox computes it; elsewhere
    ok is False and the point is NaN, a value the bbox must never read."""
    shape = torch.broadcast_shapes(*(t.shape for t in (a["x"], a["w"], b["x"], b["w"])))
    sel = ((a["zc"] < 0.0) != (b["zc"] < 0.0)).expand(shape)
    cx = torch.full(shape, float("nan"), dtype=a["x"].dtype, device=a["x"].device)
    cy = cx.clone()
    ok = torch.zeros(shape, dtype=torch.bool, device=cx.device)
    args = [t.expand(shape)[sel] for t in (a["x"], a["y"], a["w"], a["zc"],
                                           b["x"], b["y"], b["w"], b["zc"])]
    cx[sel], cy[sel], ok[sel] = _crossing(*args)
    return cx, cy, ok


def _nan3(a, b, c):
    return torch.isnan(a) | torch.isnan(b) | torch.isnan(c)


def setup_bbox(a, b, c, width: int, height: int):
    """The bbox test of the cover kernels (``vf::setup_bbox``): the int32
    pixel-centre bbox and the valid flag, (px0, px1, py0, py1, valid), from
    three corners' ``vertex_terms`` (x, y, w and zc only), bit for bit
    ``setup_fields_core``'s, in the kernels' form: a chain of
    torch.maximum/minimum compared with zero as "no NaN, and one compare
    holds"; the bbox as fmin/fmax over the selected points with a NaN flag
    that makes the bound NaN, as the chain of torch.minimum would; a
    near-plane crossing only on the edges that straddle z_clip = 0."""
    x0, y0, w0, zc0 = a["x"], a["y"], a["w"], a["zc"]
    x1, y1, w1, zc1 = b["x"], b["y"], b["w"], b["zc"]
    x2, y2, w2, zc2 = c["x"], c["y"], c["w"], c["zc"]
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    odd_neg = (w0 < 0.0) ^ (w1 < 0.0) ^ (w2 < 0.0)
    front = torch.where(odd_neg, area2, -area2) > 0.0
    finite = (torch.isfinite(x0) & torch.isfinite(x1) & torch.isfinite(x2)
              & torch.isfinite(y0) & torch.isfinite(y1) & torch.isfinite(y2))
    any_near = ~_nan3(zc0, zc1, zc2) & ((zc0 >= 0.0) | (zc1 >= 0.0) | (zc2 >= 0.0))
    any_w = ~_nan3(w0, w1, w2) & ((w0 > _W_EPS) | (w1 > _W_EPS) | (w2 > _W_EPS))
    f0, f1, f2 = zc0 - w0, zc1 - w1, zc2 - w2
    any_far = ~_nan3(f0, f1, f2) & ((f0 <= 0.0) | (f1 <= 0.0) | (f2 <= 0.0))
    clean = (w0 > _W_EPS) & (w1 > _W_EPS) & (w2 > _W_EPS)

    big = torch.full_like(area2, 3.4e37)
    sels = [zc0 >= 0.0, zc1 >= 0.0, zc2 >= 0.0]

    def chain(vals, init, op):
        out = init
        for s, v in zip(sels, vals):
            out = op(out, torch.where(s, v, init))
        return out

    xs, ys = [x0, x1, x2], [y0, y1, y2]
    xmin, xmax = chain(xs, big, torch.fmin), chain(xs, -big, torch.fmax)
    ymin, ymax = chain(ys, big, torch.fmin), chain(ys, -big, torch.fmax)
    xnan = (sels[0] & torch.isnan(x0)) | (sels[1] & torch.isnan(x1)) | (sels[2] & torch.isnan(x2))
    ynan = (sels[0] & torch.isnan(y0)) | (sels[1] & torch.isnan(y1)) | (sels[2] & torch.isnan(y2))
    for p, q in ((a, b), (b, c), (c, a)):
        cx, cy, ok = _crossing_if_straddling(p, q)
        xmin = torch.where(ok, torch.fmin(xmin, cx), xmin)
        xmax = torch.where(ok, torch.fmax(xmax, cx), xmax)
        ymin = torch.where(ok, torch.fmin(ymin, cy), ymin)
        ymax = torch.where(ok, torch.fmax(ymax, cy), ymax)
        xnan = xnan | (ok & torch.isnan(cx))
        ynan = ynan | (ok & torch.isnan(cy))
    nan = float("nan")
    xmin = torch.where(clean, torch.where(xnan, nan, xmin), 0.0)
    xmax = torch.where(clean, torch.where(xnan, nan, xmax), float(width))
    ymin = torch.where(clean, torch.where(ynan, nan, ymin), 0.0)
    ymax = torch.where(clean, torch.where(ynan, nan, ymax), float(height))

    def to_px(v, rnd):
        return rnd(torch.clamp(v, -1e9, 1e9) - 0.5).to(torch.int32)

    px0 = torch.clamp_min(to_px(xmin, torch.ceil), 0)
    px1 = torch.clamp_max(to_px(xmax, torch.floor), width - 1)
    py0 = torch.clamp_min(to_px(ymin, torch.ceil), 0)
    py1 = torch.clamp_max(to_px(ymax, torch.floor), height - 1)
    covers = (px0 <= px1) & (py0 <= py1)
    return px0, px1, py0, py1, front & finite & any_near & any_w & any_far & covers


def setup_from_terms(a, b, c, width: int, height: int):
    """``setup_fields_core`` (inclusive rule) in the cover kernels' factored
    form: ``setup_bbox``, then the 31 columns (``vf::setup_columns``) from
    the three corners' ``vertex_terms``. Returns (cols, px0, px1, py0, py1,
    valid), bit for bit ``setup_fields_core``'s."""
    px0, px1, py0, py1, valid = setup_bbox(a, b, c, width, height)
    x0, y0, x1, y1, x2, y2 = a["x"], a["y"], b["x"], b["y"], c["x"], c["y"]
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    neg0, neg1, neg2 = a["w"] < 0.0, b["w"] < 0.0, c["w"] < 0.0
    one = torch.ones_like(area2)
    s0 = torch.where(neg1 ^ neg2, -one, one)
    s1 = torch.where(neg2 ^ neg0, -one, one)
    s2 = torch.where(neg0 ^ neg1, -one, one)
    tau = torch.where(area2 > 0.0, -one, one)
    t0, t1, t2 = s0 * tau, s1 * tau, s2 * tau
    cols = [x1, y1, (y2 - y1) * s0, (x2 - x1) * s0,
            x2, y2, (y0 - y2) * s1, (x0 - x2) * s1,
            x0, y0, (y1 - y0) * s2, (x1 - x0) * s2]
    for k in range(3):
        cols += [a["vr"][k] * t0, b["vr"][k] * t1, c["vr"][k] * t2]
    cols += [a["rw"] * t0, b["rw"] * t1, c["rw"] * t2, valid.to(torch.float32)]
    cols += [a["zn"] * t0, b["zn"] * t1, c["zn"] * t2, t0, t1, t2]
    return cols, px0, px1, py0, py1, valid


def straddling_edges(c0, c1, c2):
    """(3, ...) bool: whether the ends of edge 0->1, 1->2 and 2->0 straddle
    z_clip = 0, the edges whose near-plane crossing setup_bbox computes.
    Corners as ``setup_fields_core`` takes them."""
    zc = torch.broadcast_tensors(*(c[6] * c[2] for c in (c0, c1, c2)))
    return torch.stack([(zc[a] < 0.0) != (zc[b] < 0.0) for a, b in ((0, 1), (1, 2), (2, 0))])


def near_cut(c0, c1, c2, valid):
    """(...,) bool: the valid triangles in front of the camera (w above
    the epsilon at every corner) with an edge whose ends straddle
    z_clip = 0, whose bboxes the near-plane crossings set. Corners as
    ``setup_fields_core`` takes them; for the tests' and chip_smoke.py's
    near-plane-cut cameras."""
    cut = straddling_edges(c0, c1, c2).any(dim=0)
    return valid & cut & (c0[2] > _W_EPS) & (c1[2] > _W_EPS) & (c2[2] > _W_EPS)


def grid_corners(fields, n: int):
    """Corners of every triangle of the ``build_grid_xyuv(n)`` mesh.

    fields: sequence of per-vertex tensors (..., n*n), row-major grid. Per
    cell (r, c) the corners are A=(r,c), B=(r,c+1), C=(r+1,c),
    D=(r+1,c+1); tri0 = [A, C, B] and tri1 = [B, C, D] (draw order,
    ``vulkan_forge/_raster/setup.py:223-235`` without the split-row
    permutation). Returns three lists (one per corner) of (..., T) tensors,
    T = 2*(n-1)**2, triangle ``(r*(n-1) + c)*2 + k`` at position t: the
    order of ``_mesh.build_grid_xyuv``'s indices.
    """
    def tri(f, k0, k1):
        f2 = f.reshape(*f.shape[:-1], n, n)
        return torch.stack([f2[..., k0[0], k0[1]], f2[..., k1[0], k1[1]]],
                           dim=-1).reshape(*f.shape[:-1], -1)

    a = (slice(None, -1), slice(None, -1))
    b = (slice(None, -1), slice(1, None))
    c = (slice(1, None), slice(None, -1))
    d = (slice(1, None), slice(1, None))
    return [[tri(f, k0, k1) for f in fields]
            for k0, k1 in ((a, b), (c, c), (b, d))]


def indexed_corners(fields, indices):
    """Corners of the triangles of an index buffer, in index order.

    fields: sequence of per-vertex tensors (..., N) (the field order of
    ``setup_fields_core``); indices: (T, 3) int (int32 or int64). Returns
    three lists (one per corner, column j of ``indices``) of (..., T)
    tensors: the corners ``setup_cols`` sets up, so a caller that passes
    them to ``setup_fields_core`` gets its 31 columns bit for bit.
    """
    idx = indices.to(torch.long)
    return [[f[..., idx[:, j]] for f in fields] for j in range(3)]


def setup_cols(x_fb, y_fb, z_ndc, w_clip, varyings, indices,
               width: int, height: int, fill_rule: str = "inclusive"):
    """Core triangle setup: returns (cols, bbox).

    x_fb, y_fb, z_ndc, w_clip: (..., N); varyings: (N, 3) or (..., N, 3);
    indices: (T, 3) int. cols: NUM_COLS (..., T) f32 tensors (HW_COLS under
    fill_rule "hw", which snaps x_fb and y_fb once per vertex first, as
    ``vulkan_forge/_raster/setup.py:147-152`` does); bbox: (..., T, 4)
    int32 with the invalid encoding (x1 < x0).
    """
    if check_fill_rule(fill_rule) == "hw":
        x_fb, y_fb = snap_hw(x_fb), snap_hw(y_fb)
    fields = [x_fb, y_fb, w_clip, varyings[..., 0], varyings[..., 1],
              varyings[..., 2], z_ndc]
    return _cols_and_bbox(*indexed_corners(fields, indices), width, height, fill_rule)


def _cols_and_bbox(c0, c1, c2, width: int, height: int, fill_rule: str):
    """``setup_fields_core`` with every column at the full shape, and the
    bbox with the invalid encoding (x1 < x0)."""
    cols, px0, px1, py0, py1, valid = setup_fields_core(c0, c1, c2, width, height,
                                                        fill_rule)
    shape = cols[0].shape
    cols = [c.expand(shape) for c in cols]
    bbox = torch.stack([torch.where(valid, px0, width),
                        torch.where(valid, px1, -1),
                        torch.where(valid, py0, height),
                        torch.where(valid, py1, -1)], dim=-1)
    return cols, bbox.expand(*shape, 4)


def _stack_records(cols) -> torch.Tensor:
    """(..., T, REC_WIDTH) records from the live columns, zero-padded."""
    zero = torch.zeros_like(cols[0])
    return torch.stack(cols + [zero] * (REC_WIDTH - len(cols)), dim=-1)


def corner_records(c0, c1, c2, width: int, height: int):
    """Inclusive-rule records (..., T, REC_WIDTH), without the sentinel row,
    and the (..., T, 4) bbox of triangles given by their corners (three
    lists of per-field tensors, ``grid_corners`` or ``indexed_corners``):
    the rows ``triangle_setup`` builds for the same triangles."""
    cols, bbox = _cols_and_bbox(c0, c1, c2, width, height, "inclusive")
    return _stack_records(cols), bbox


def triangle_setup(x_fb, y_fb, z_ndc, w_clip, varyings, indices,
                   width: int, height: int, fill_rule: str = "inclusive"):
    """Build (..., T+1, REC_WIDTH) triangle records and the (..., T, 4)
    bbox; fill_rule "hw" fills the edge thresholds at columns 31..33 (zero
    under "inclusive")."""
    cols, bbox = setup_cols(x_fb, y_fb, z_ndc, w_clip, varyings, indices,
                            width, height, fill_rule)
    rec = _stack_records(cols)
    sentinel = torch.zeros_like(rec[..., :1, :])
    return torch.cat([rec, sentinel], dim=-2), bbox


class Binning(NamedTuple):
    """Per-tile triangle lists in CSR form.

    rows: (P,) int32 record rows into the (B*(T+1), REC_WIDTH) flattened
    records, tile by tile, ascending triangle id within a tile.
    offsets: (B*NT + 1,) int32 exclusive scan of the per-tile counts; tile
    ``b*NT + ty*NTX + tx`` owns rows[offsets[t]:offsets[t+1]].
    boxes: (P,) int32, beside rows: each pair's pixel bbox clipped to its
    tile, in tile-local pixels 0..TILE-1 packed as x0 | x1 << 4 | y0 << 8 |
    y1 << 12 (never empty). The raster kernels walk these pixels only
    (csrc/raster.cu; ``tiles.box_extents`` decodes them).
    """
    rows: torch.Tensor
    offsets: torch.Tensor
    boxes: torch.Tensor


def tile_grid(width: int, height: int):
    """(NTX, NTY) TILE x TILE tiles covering a width x height framebuffer."""
    return -(-width // TILE), -(-height // TILE)


def bin_tiles(bbox: torch.Tensor, width: int, height: int) -> Binning:
    """Bin triangles into per-tile ascending-id lists.

    bbox: (T, 4) or (B, T, 4) int32 pixel bboxes (invalid: x1 < x0). Each
    valid triangle emits one (tile, id) pair per tile its bbox spans, in
    triangle order; a stable sort on the tile key keeps each tile's ids
    ascending, and each pair's box goes with it. Deterministic, and no
    atomics anywhere. On a card it reads the device back three times,
    each a ``_trace`` site: the pair count, and ``bincount``'s min and max
    of the keys.
    """
    if bbox.dim() == 2:
        bbox = bbox[None]
    B, T = bbox.shape[:2]
    ntx, nty = tile_grid(width, height)
    nt = ntx * nty
    dev = bbox.device
    b = bbox.reshape(B * T, 4).to(torch.long)
    valid = b[:, 1] >= b[:, 0]
    tx0 = torch.div(b[:, 0], TILE, rounding_mode="floor")
    ty0 = torch.div(b[:, 2], TILE, rounding_mode="floor")
    sx = torch.where(valid, torch.div(b[:, 1], TILE, rounding_mode="floor") - tx0 + 1, 0)
    sy = torch.where(valid, torch.div(b[:, 3], TILE, rounding_mode="floor") - ty0 + 1, 0)
    n = sx * sy
    ends = torch.cumsum(n, 0)
    total = int(_trace.d2h(ends[-1]).item()) if n.numel() else 0

    tri = torch.repeat_interleave(torch.arange(B * T, device=dev), n,
                                  output_size=total)
    k = torch.arange(total, device=dev) - (ends - n)[tri]
    sxt = sx[tri]
    tx = tx0[tri] + k % sxt
    ty = ty0[tri] + torch.div(k, sxt, rounding_mode="floor")
    del k, sxt
    frame = torch.div(tri, T, rounding_mode="floor")
    key = frame * nt + ty * ntx + tx
    # The bbox clipped to the pair's tile, tile-local (see Binning.boxes).
    tx, ty = tx * TILE, ty * TILE
    box = ((b[:, 0][tri] - tx).clamp_min(0) | (b[:, 1][tri] - tx).clamp_max(TILE - 1) << 4
           | (b[:, 2][tri] - ty).clamp_min(0) << 8
           | (b[:, 3][tri] - ty).clamp_max(TILE - 1) << 12)
    del tx, ty
    key_sorted, order = torch.sort(key, stable=True)
    rows = (tri + frame)[order]          # frame*(T+1) + id
    boxes = box[order].to(torch.int32)
    counts = torch.bincount(_trace.sync(key_sorted, 2), minlength=B * nt)  # min and max
    offsets = torch.zeros(B * nt + 1, dtype=torch.long, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    return Binning(rows=rows.to(torch.int32), offsets=offsets.to(torch.int32), boxes=boxes)
