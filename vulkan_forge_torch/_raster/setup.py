"""Triangle setup and framebuffer-tile binning on torch tensors.

Port of ``vulkan_forge/_raster/setup.py`` (conventions, record layout and
the near/far clip functionals are documented there, lines 1-74). Records
are (..., T+1, REC_WIDTH) f32 rows, columns 0..30 in the layout of
``setup.py:21-39``, row T an all-zero sentinel. Every column is computed
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

REC_WIDTH = 40
NUM_COLS = 31

# The port's raster tile: 16 x 16 pixels, one CUDA thread per pixel. It
# must equal kTile in csrc/raster.cu, which kernels.load() checks.
TILE = 16

_W_EPS = 1e-8   # "in front of camera" threshold on clip w (hardware: w > 0)


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


def setup_fields_core(c0, c1, c2, width: int, height: int):
    """Triangle setup from per-corner per-FIELD tensors (field order:
    x_fb, y_fb, w_clip, var0, var1, var2, z_ndc), inclusive fill rule.

    Returns (cols, px0, px1, py0, py1, valid): the NUM_COLS record column
    tensors, the int32 pixel-center bbox (pre-invalid-encoding) and the
    bool valid flag (already folded into cols[24]).
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
    def crossing(xa, ya, wa, za, xb, yb, wb, zb):
        """Near-plane (z_clip = 0) crossing of edge a->b."""
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

    cx01, cy01, ok01 = crossing(x0, y0, w0, zc0, x1, y1, w1, zc1)
    cx12, cy12, ok12 = crossing(x1, y1, w1, zc1, x2, y2, w2, zc2)
    cx20, cy20, ok20 = crossing(x2, y2, w2, zc2, x0, y0, w0, zc0)
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
    def srw(w):
        tiny = torch.where(w < 0.0, -1e-12, 1e-12)
        return 1.0 / torch.where(torch.abs(w) < 1e-12, tiny, w)

    rw0, rw1, rw2 = srw(w0), srw(w1), srw(w2)

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
    return cols, px0, px1, py0, py1, valid


def setup_cols(x_fb, y_fb, z_ndc, w_clip, varyings, indices,
               width: int, height: int):
    """Core triangle setup: returns (cols, bbox).

    x_fb, y_fb, z_ndc, w_clip: (..., N); varyings: (N, 3) or (..., N, 3);
    indices: (T, 3) int. cols: NUM_COLS (..., T) f32 tensors; bbox:
    (..., T, 4) int32 with the invalid encoding (x1 < x0).
    """
    idx = indices.to(torch.long)
    fields = [x_fb, y_fb, w_clip, varyings[..., 0], varyings[..., 1],
              varyings[..., 2], z_ndc]
    corners = [[f[..., idx[:, j]] for f in fields] for j in range(3)]
    cols, px0, px1, py0, py1, valid = setup_fields_core(
        corners[0], corners[1], corners[2], width, height)
    shape = cols[0].shape
    cols = [c.expand(shape) for c in cols]
    bbox = torch.stack([torch.where(valid, px0, width),
                        torch.where(valid, px1, -1),
                        torch.where(valid, py0, height),
                        torch.where(valid, py1, -1)], dim=-1)
    return cols, bbox.expand(*shape, 4)


def triangle_setup(x_fb, y_fb, z_ndc, w_clip, varyings, indices,
                   width: int, height: int):
    """Build (..., T+1, REC_WIDTH) triangle records and the (..., T, 4) bbox."""
    cols, bbox = setup_cols(x_fb, y_fb, z_ndc, w_clip, varyings, indices,
                            width, height)
    zero = torch.zeros_like(cols[0])
    rec = torch.stack(cols + [zero] * (REC_WIDTH - NUM_COLS), dim=-1)
    sentinel = torch.zeros_like(rec[..., :1, :])
    return torch.cat([rec, sentinel], dim=-2), bbox


class Binning(NamedTuple):
    """Per-tile triangle lists in CSR form.

    rows: (P,) int32 record rows into the (B*(T+1), REC_WIDTH) flattened
    records, tile by tile, ascending triangle id within a tile.
    offsets: (B*NT + 1,) int32 exclusive scan of the per-tile counts; tile
    ``b*NT + ty*NTX + tx`` owns rows[offsets[t]:offsets[t+1]].
    """
    rows: torch.Tensor
    offsets: torch.Tensor


def tile_grid(width: int, height: int):
    """(NTX, NTY) TILE x TILE tiles covering a width x height framebuffer."""
    return -(-width // TILE), -(-height // TILE)


def bin_tiles(bbox: torch.Tensor, width: int, height: int) -> Binning:
    """Bin triangles into per-tile ascending-id lists.

    bbox: (T, 4) or (B, T, 4) int32 pixel bboxes (invalid: x1 < x0). Each
    valid triangle emits one (tile, id) pair per tile its bbox spans, in
    triangle order; a stable sort on the tile key keeps each tile's ids
    ascending. Deterministic, and no atomics anywhere.
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
    total = int(ends[-1].item()) if n.numel() else 0

    tri = torch.repeat_interleave(torch.arange(B * T, device=dev), n,
                                  output_size=total)
    k = torch.arange(total, device=dev) - (ends - n)[tri]
    sxt = sx[tri]
    tile_id = ((ty0[tri] + torch.div(k, sxt, rounding_mode="floor")) * ntx
               + tx0[tri] + k % sxt)
    frame = torch.div(tri, T, rounding_mode="floor")
    key = frame * nt + tile_id
    key_sorted, order = torch.sort(key, stable=True)
    rows = (tri + frame)[order]          # frame*(T+1) + id
    counts = torch.bincount(key_sorted, minlength=B * nt)
    offsets = torch.zeros(B * nt + 1, dtype=torch.long, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    return Binning(rows=rows.to(torch.int32), offsets=offsets.to(torch.int32))
