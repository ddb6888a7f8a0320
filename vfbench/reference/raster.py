"""The device-side half of the plain reference: vertex stage, triangle
setup, coverage with painter's order (the largest covering triangle id
wins), the perspective-correct resolve, the two fragment shaders and the
u8 packing, in plain PyTorch float32.

Frozen copies of the port's plain passes (``vulkan_forge_torch/_raster/
transform.py``, ``setup.py``'s ``clip_to_fb`` and ``setup_fields_core``
under the inclusive rule, ``tiles.py``'s ``mad`` and ``eval_records``,
``vtx.py``'s deposit and resolve, ``fragment.py``, ``_formats.py``), with
the same f32 ops in the same order, so that a sound program gives these
bytes within one unit of a channel. Coverage is worked out over every
triangle at once, in chunks, with no small/big split, no binning and no
tile walk: the winner of a pixel is the same whichever way it is found.

``tf32=True`` is the control: the vertex stage's two 4x4 transforms take
their operands rounded to TF32 (10 mantissa bits, round to nearest even),
as a TF32 matrix product does, and accumulate in f32. The program states
full float32 with TF32 off, so the control has to fail the comparison.
"""
from __future__ import annotations

import torch

FIELDS = 7          # x_fb, y_fb, w_clip, var0, var1, var2, z_ndc
CLEAR_TERRAIN = (0.02, 0.02, 0.03)
# Triangles set up at once, and (triangle, pixel) pairs evaluated at once.
_TRI_CHUNK = 1 << 22
_PAIR_CHUNK = 1 << 22
_W_EPS = 1e-8


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


# ---- vertex stage ----

def _sample_nearest(heights, u, v):
    ht, wt = heights.shape
    tx = torch.clamp(torch.floor(u * wt), 0, wt - 1).to(torch.long)
    ty = torch.clamp(torch.floor(v * ht), 0, ht - 1).to(torch.long)
    return heights[ty, tx]


def _rows_times_mt(v, m, tf32):
    """``v @ m.T`` for 4-vectors ``v`` (4 tensors (N,)) and (B, 4, 4)
    matrices ``m``: each output ``(p0 + p1) + (p2 + p3)``."""
    if tf32:
        v, m = [round_tf32(c) for c in v], round_tf32(m)
    out = []
    for i in range(4):
        p = [v[k] * m[..., i, k, None] for k in range(4)]
        out.append((p[0] + p[1]) + (p[2] + p[3]))
    return out


def vertex_fields(xyuv, heights, views, projs, width: int, height: int,
                  shader: str, tf32: bool = False):
    """Post-VS fields of B frames, (B, 7, N) f32: x_fb, y_fb, w_clip, three
    varyings, z_ndc. ``shader`` "shipped" is the spike's stage (texture
    height plus the analytic relief; varyings h, x, z); "extended" the
    DEM's (texture height alone; varyings h, u, v). Spacing and
    exaggeration are 1 in both entries the benchmark drives."""
    x, z, u, v = xyuv[:, 0], xyuv[:, 1], xyuv[:, 2], xyuv[:, 3]
    h = _sample_nearest(heights, u, v)
    if shader == "shipped":
        h = h + (torch.sin(x * 1.3) * 0.25 + torch.cos(z * 1.1) * 0.25)
        vary = (h, x, z)
    else:
        vary = (h, u, v)
    world = [x, h, z, torch.ones_like(x)]
    clip = _rows_times_mt(_rows_times_mt(world, views, tf32), projs, tf32)
    w = clip[3]
    safe_w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    x_fb = (clip[0] / safe_w * 0.5 + 0.5) * width
    y_fb = (0.5 - clip[1] / safe_w * 0.5) * height
    z_ndc = clip[2] / safe_w
    B = w.shape[0]
    vary = [a.expand(B, -1) for a in vary]
    return torch.stack([x_fb, y_fb, w, *vary, z_ndc], dim=1).contiguous()


# ---- triangle setup (inclusive rule) ----

def _crossing(xa, ya, wa, za, xb, yb, wb, zb):
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
    tiny = torch.where(w < 0.0, -1e-12, 1e-12)
    return 1.0 / torch.where(torch.abs(w) < 1e-12, tiny, w)


def setup(c0, c1, c2, width: int, height: int):
    """Triangle setup from three corners' 7 field tensors: (cols, px0, px1,
    py0, py1, valid), the 31 record columns, the pixel-centre bbox and
    the valid flag."""
    x0, y0, w0, zn0 = c0[0], c0[1], c0[2], c0[6]
    x1, y1, w1, zn1 = c1[0], c1[1], c1[2], c1[6]
    x2, y2, w2, zn2 = c2[0], c2[1], c2[2], c2[6]
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    neg0, neg1, neg2 = w0 < 0.0, w1 < 0.0, w2 < 0.0
    front = torch.where(neg0 ^ neg1 ^ neg2, area2, -area2) > 0.0
    finite = (torch.isfinite(x0) & torch.isfinite(x1) & torch.isfinite(x2)
              & torch.isfinite(y0) & torch.isfinite(y1) & torch.isfinite(y2))
    zc0, zc1, zc2 = zn0 * w0, zn1 * w1, zn2 * w2
    any_near = torch.maximum(torch.maximum(zc0, zc1), zc2) >= 0.0
    any_w = torch.maximum(torch.maximum(w0, w1), w2) > _W_EPS
    any_far = torch.minimum(torch.minimum(zc0 - w0, zc1 - w1), zc2 - w2) <= 0.0
    clean = (w0 > _W_EPS) & (w1 > _W_EPS) & (w2 > _W_EPS)

    cx01, cy01, ok01 = _crossing(x0, y0, w0, zc0, x1, y1, w1, zc1)
    cx12, cy12, ok12 = _crossing(x1, y1, w1, zc1, x2, y2, w2, zc2)
    cx20, cy20, ok20 = _crossing(x2, y2, w2, zc2, x0, y0, w0, zc0)
    big = torch.full_like(x0, 3.4e37)
    sels = [zc0 >= 0.0, zc1 >= 0.0, zc2 >= 0.0, ok01, ok12, ok20]

    def mm(vals, init, op):
        out = init
        for s, v in zip(sels, vals):
            out = op(out, torch.where(s, v, init))
        return out

    xs = [x0, x1, x2, cx01, cx12, cx20]
    ys = [y0, y1, y2, cy01, cy12, cy20]
    xmin = torch.where(clean, mm(xs, big, torch.minimum), 0.0)
    xmax = torch.where(clean, mm(xs, -big, torch.maximum), float(width))
    ymin = torch.where(clean, mm(ys, big, torch.minimum), 0.0)
    ymax = torch.where(clean, mm(ys, -big, torch.maximum), float(height))

    def to_px(v, rnd):
        return rnd(torch.clamp(v, -1e9, 1e9) - 0.5).to(torch.int32)

    px0 = torch.clamp_min(to_px(xmin, torch.ceil), 0)
    px1 = torch.clamp_max(to_px(xmax, torch.floor), width - 1)
    py0 = torch.clamp_min(to_px(ymin, torch.ceil), 0)
    py1 = torch.clamp_max(to_px(ymax, torch.floor), height - 1)
    valid = (front & finite & any_near & any_w & any_far
             & (px0 <= px1) & (py0 <= py1))

    rw0, rw1, rw2 = _srw(w0), _srw(w1), _srw(w2)
    one = torch.ones_like(x0)
    s0 = torch.where(neg1 ^ neg2, -one, one)
    s1 = torch.where(neg2 ^ neg0, -one, one)
    s2 = torch.where(neg0 ^ neg1, -one, one)
    tau = torch.where(area2 > 0.0, -one, one)
    t0, t1, t2 = s0 * tau, s1 * tau, s2 * tau
    cols = [x1, y1, (y2 - y1) * s0, (x2 - x1) * s0,
            x2, y2, (y0 - y2) * s1, (x0 - x2) * s1,
            x0, y0, (y1 - y0) * s2, (x1 - x0) * s2]
    for k in range(3):
        cols += [c0[3 + k] * rw0 * t0, c1[3 + k] * rw1 * t1, c2[3 + k] * rw2 * t2]
    cols += [rw0 * t0, rw1 * t1, rw2 * t2, valid.to(torch.float32)]
    cols += [zn0 * t0, zn1 * t1, zn2 * t2]
    cols += [t0, t1, t2]
    return cols, px0, px1, py0, py1, valid


# ---- evaluation at pixel centres ----

def mad(a, b, c):
    """``a * b + c`` in f32 rounded once, as a fused multiply-add rounds it
    (the f64 sum rounded to odd, then to f32)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    s = torch.where(inexact_even, torch.nextafter(s, s + torch.sign(err) * float("inf")), s)
    return s.float()


def evaluate(col, px, py):
    """Record columns ``col(k)`` at pixel centres: (a0, a1, a2, aw,
    covered), the varying numerators, the 1/w numerator and coverage
    (three edges >= 0, valid, near z >= 0, w > 0, far z <= w)."""
    f0 = mad(col(2), px - col(0), -(col(3) * (py - col(1))))
    f1 = mad(col(6), px - col(4), -(col(7) * (py - col(5))))
    f2 = mad(col(10), px - col(8), -(col(11) * (py - col(9))))

    def dot(k):
        return mad(f2, col(k + 2), mad(f0, col(k), f1 * col(k + 1)))

    aw = dot(21)
    az = dot(25)
    covered = ((f0 >= 0.0) & (f1 >= 0.0) & (f2 >= 0.0) & (col(24) > 0.0)
               & (az >= 0.0) & (aw > 0.0) & (dot(28) - az >= 0.0))
    return dot(12), dot(15), dot(18), aw, covered


def _corners(fields, tris, frame, tri):
    verts = tris[tri]
    return [[fields[frame, f, verts[:, j]] for f in range(FIELDS)] for j in range(3)]


def winners(fields, tris, width: int, height: int) -> torch.Tensor:
    """(B, H, W) int64: 1 + the largest id of a triangle covering each
    pixel centre, 0 where none does."""
    B = fields.shape[0]
    T = tris.shape[0]
    dev = fields.device
    flat = torch.zeros(B * height * width, dtype=torch.int64, device=dev)
    step = max(1, _TRI_CHUNK // B)
    for lo in range(0, T, step):
        ids = torch.arange(lo, min(lo + step, T), device=dev)
        frame = torch.arange(B, device=dev).repeat_interleave(ids.numel())
        tri = ids.repeat(B)
        cols, px0, px1, py0, py1, valid = setup(*_corners(fields, tris, frame, tri),
                                                width, height)
        sel = torch.nonzero(valid).squeeze(1)
        _deposit(flat, [c[sel] for c in cols], px0[sel], px1[sel], py0[sel], py1[sel],
                 frame[sel], tri[sel], width, height)
    return flat.view(B, height, width)


def _deposit(flat, cols, px0, px1, py0, py1, frame, ids, width, height):
    """Max-combine ``ids + 1`` into ``flat`` at every covered pixel of each
    triangle's bbox, (triangle, pixel) pairs in chunks."""
    bw = (px1 - px0 + 1).to(torch.long)
    npix = bw * (py1 - py0 + 1).to(torch.long)
    ends = torch.cumsum(npix, 0)
    total = int(ends[-1]) if ends.numel() else 0
    marks = torch.arange(1, total // _PAIR_CHUNK + 1, device=ends.device) * _PAIR_CHUNK
    bounds = [0] + torch.searchsorted(ends, marks, right=True).tolist() + [npix.numel()]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        cnt = npix[lo:hi]
        tri = lo + torch.repeat_interleave(torch.arange(hi - lo, device=cnt.device), cnt)
        k = torch.arange(tri.numel(), device=cnt.device) - (torch.cumsum(cnt, 0) - cnt)[tri - lo]
        x = px0[tri].to(torch.long) + k % bw[tri]
        y = py0[tri].to(torch.long) + torch.div(k, bw[tri], rounding_mode="floor")
        cov = evaluate(lambda j: cols[j][tri], x.to(torch.float32) + 0.5,
                       y.to(torch.float32) + 0.5)[4]
        pix = (frame[tri] * height + y) * width + x
        flat.scatter_reduce_(0, pix[cov], ids[tri][cov] + 1, "amax")


def resolve(fields, tris, winner):
    """The g-buffer of the winners: (v0, v1, v2, mask), each (B, H, W);
    uncovered pixels read 0."""
    B, height, width = winner.shape
    w = winner.reshape(-1)
    mask = w > 0
    pix = torch.nonzero(mask).squeeze(1)
    frame = torch.div(pix, height * width, rounding_mode="floor")
    lp = pix % (height * width)
    cols = setup(*_corners(fields, tris, frame, w[pix] - 1), width, height)[0]
    px = (lp % width).to(torch.float32) + 0.5
    py = torch.div(lp, width, rounding_mode="floor").to(torch.float32) + 0.5
    a0, a1, a2, aw, _ = evaluate(cols.__getitem__, px, py)
    rcp = 1.0 / torch.where(torch.abs(aw) < 1e-20, 1.0, aw)
    planes = []
    for a in (a0, a1, a2):
        p = torch.zeros(w.numel(), dtype=torch.float32, device=w.device)
        p[pix] = a * rcp
        planes.append(p.view(B, height, width))
    return (*planes, mask.view(B, height, width))


# ---- fragment shaders and packing ----

def _lut_bilinear(lut, t):
    xf = t * 256.0 - 0.5
    x0 = torch.floor(xf)
    frac = (xf - x0)[..., None]
    i0 = torch.clamp(x0, 0, 255).to(torch.long)
    i1 = torch.clamp(x0 + 1.0, 0, 255).to(torch.long)
    return lut[i0] * (1.0 - frac) + lut[i1] * frac


def _srgb_encode(c):
    c = torch.clamp(c.to(torch.float32), 0.0, 1.0)
    lo = c * 12.92
    hi = 1.055 * torch.pow(torch.clamp_min(c, 1e-12), 1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def _to_bytes(rgb, mask):
    """(..., H, W, 3) linear colour, the clear colour where ``mask`` is off,
    sRGB-encoded and quantised: (..., H, W, 4) uint8 RGBA, alpha 255."""
    clear = torch.tensor(CLEAR_TERRAIN, dtype=torch.float32, device=rgb.device)
    srgb = _srgb_encode(torch.where(mask[..., None], rgb, clear))
    q = torch.floor(torch.clamp(srgb, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    alpha = torch.full_like(q[..., :1], 255)
    return torch.cat([q, alpha], dim=-1)


def clear_bytes() -> tuple:
    """The RGBA8 bytes of an uncovered pixel."""
    return tuple(int(b) for b in _to_bytes(torch.zeros(1, 3), torch.zeros(1, dtype=torch.bool))[0])


def shade_shipped(h, x, z, mask, lut, h_range, exposure, sun):
    """The shipped terrain shader (src/shaders/terrain.wgsl:68-91): LUT by
    height, the spike's analytic normal, ambient-floor Lambert, exposure,
    no tonemap."""
    hr2 = 2.0 * torch.clamp_min(h_range, 1e-8)
    l = sun / torch.sqrt(torch.sum(sun * sun))
    t = torch.clamp(0.5 + h / hr2, 0.0, 1.0)
    lut_rgb = _lut_bilinear(lut[:, :3], t)
    dhdx = 1.3 * torch.cos(x * 1.3) * 0.25
    dhdz = -1.1 * torch.sin(z * 1.1) * 0.25
    inv_len = 1.0 / torch.sqrt(dhdx * dhdx + 1.0 + dhdz * dhdz)
    lambert = torch.clamp((-dhdx * l[0] + l[1] - dhdz * l[2]) * inv_len, 0.0, 1.0)
    shade = 0.15 + 0.85 * lambert
    return _to_bytes(lut_rgb * exposure * shade[..., None], mask)


def shade_extended(h, u, v, mask, lut, heights, h_min, h_max, exposure, sun,
                   spacing, exaggeration):
    """The extended terrain shader: LUT by normalised height, central-
    difference normals from the height texture at the pixel's uv, Lambert
    with an ambient floor, exposure, Reinhard tonemap."""
    ht, wt = heights.shape
    t = torch.clamp((h - h_min) / torch.clamp_min(h_max - h_min, 1e-8), 0.0, 1.0)
    lut_rgb = _lut_bilinear(lut, t)[..., :3]
    tx = torch.clamp(torch.floor(u * wt), 0, wt - 1).to(torch.long)
    ty = torch.clamp(torch.floor(v * ht), 0, ht - 1).to(torch.long)
    txm, txp = torch.clamp_min(tx - 1, 0), torch.clamp_max(tx + 1, wt - 1)
    tym, typ = torch.clamp_min(ty - 1, 0), torch.clamp_max(ty + 1, ht - 1)
    step_x = (txp - txm).to(torch.float32)
    step_z = (typ - tym).to(torch.float32)
    sp = torch.clamp_min(spacing, 1e-8)
    dhdx = ((heights[ty, txp] - heights[ty, txm]) * exaggeration
            / (torch.clamp_min(step_x, 1.0) * sp))
    dhdz = ((heights[typ, tx] - heights[tym, tx]) * exaggeration
            / (torch.clamp_min(step_z, 1.0) * sp))
    inv_len = 1.0 / torch.sqrt(dhdx * dhdx + 1.0 + dhdz * dhdz)
    l = sun / torch.sqrt(torch.sum(sun * sun))
    lambert = torch.clamp((-dhdx * l[0] + l[1] - dhdz * l[2]) * inv_len, 0.0, 1.0)
    shade = 0.15 + 0.85 * lambert
    rgb = lut_rgb * shade[..., None]
    rgb = rgb * exposure
    return _to_bytes(rgb / (1.0 + rgb), mask)
