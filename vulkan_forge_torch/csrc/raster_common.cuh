// Device code shared by the port's raster kernels (raster.cu, vtx.cu,
// packed.cu, segments.cu).
//
// Built with -fmad=false and without fast math (see raster.cu), so every
// +, -, *, / and sqrtf rounds once, as the plain PyTorch versions round
// their eager ops on the card (on the CPU torch's sqrt is not correctly
// rounded: raster.cu says what that does), and the multiply-adds of the
// record evaluation are fused as tiles.mad rounds them; the op order is
// theirs (tiles.eval_records, fragment.py:44-69).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vf {

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  // torch.clamp semantics, NaN propagates.
  return x < lo ? lo : (x > hi ? hi : x);
}

// Shipped terrain fragment shader for one pixel (fragment.terrain_fs /
// K2 fragment.terrain_fs_tile). lut: (256, 3) linear RGB, in shared memory
// (raster.cu, segments.cu) or read through L1 (the vtx resolve).
__device__ __forceinline__ int32_t shade_shipped(
    float hh, float xx, float zz, bool cov, const float* lut,
    float hr2, float exposure, float l0, float l1, float l2) {
  const float t = clampf(0.5f + hh / hr2, 0.0f, 1.0f);
  const float xf = t * 256.0f - 0.5f;
  const float x0 = floorf(xf);
  const float frac = xf - x0;
  const int i0 = (int)clampf(x0, 0.0f, 255.0f);
  const int i1 = (int)clampf(x0 + 1.0f, 0.0f, 255.0f);

  const float dhdx = 1.3f * cosf(xx * 1.3f) * 0.25f;
  const float dhdz = -1.1f * sinf(zz * 1.1f) * 0.25f;
  const float inv_len = 1.0f / sqrtf(dhdx * dhdx + 1.0f + dhdz * dhdz);
  const float lambert =
      clampf((-dhdx * l0 + l1 - dhdz * l2) * inv_len, 0.0f, 1.0f);
  const float shade = 0.15f + 0.85f * lambert;

  const float inv_gamma = (float)(1.0 / 2.4);
  const float clear[3] = {0.02f, 0.02f, 0.03f};
  int32_t word = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lin = lut[i0 * 3 + c] * (1.0f - frac) + lut[i1 * 3 + c] * frac;
    float v = lin * exposure * shade;
    v = cov ? v : clear[c];
    v = clampf(v, 0.0f, 1.0f);
    const float lo = v * 12.92f;
    const float hi = 1.055f * powf(fmaxf(v, 1e-12f), inv_gamma) - 0.055f;
    const float s = v <= 0.0031308f ? lo : hi;
    const int32_t u8 = (int32_t)floorf(clampf(s, 0.0f, 1.0f) * 255.0f + 0.5f);
    word |= u8 << (8 * c);
  }
  return word | (int32_t)0xFF000000;  // alpha = 255
}

// a*b + c rounded once: the fused multiply-add XLA:CPU contracts it into
// and tiles.mad computes. -fmad=false stops only the compiler's own
// contraction; this one is asked for.
__device__ __forceinline__ float mad(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// One record (columns 0..30 in the layout of setup.py) at one pixel
// centre: the three varying numerators, the 1/w numerator and coverage
// (edge functions, near z>=0, camera-front w>0, far z<=w), as
// tiles.eval_records computes them. kHw: the hardware fill rule, edge i
// covering where f_i >= r[31 + i] (the top-left thresholds of setup.py's
// "hw" records, which then hold 34 columns) instead of f_i >= 0.
struct PixelEval {
  float a0, a1, a2, aw;
  bool cov;
};

template <bool kHw = false>
__device__ __forceinline__ PixelEval eval_pixel(const float* r, float px,
                                                float py) {
  const float f0 = mad(r[2], px - r[0], -(r[3] * (py - r[1])));
  const float f1 = mad(r[6], px - r[4], -(r[7] * (py - r[5])));
  const float f2 = mad(r[10], px - r[8], -(r[11] * (py - r[9])));
  const auto dot = [&](int k) {
    return mad(f2, r[k + 2], mad(f0, r[k], f1 * r[k + 1]));
  };
  PixelEval e;
  e.a0 = dot(12);
  e.a1 = dot(15);
  e.a2 = dot(18);
  e.aw = dot(21);
  const float az = dot(25);
  const float asum = dot(28);
  bool edges;
  if constexpr (kHw) {
    edges = (f0 >= r[31]) & (f1 >= r[32]) & (f2 >= r[33]);
  } else {
    edges = (f0 >= 0.0f) & (f1 >= 0.0f) & (f2 >= 0.0f);
  }
  e.cov = edges & (r[24] > 0.0f) & (az >= 0.0f) & (e.aw > 0.0f) &
          (asum - az >= 0.0f);
  return e;
}

// eval_pixel's coverage alone (tiles.cover_records), with its operations
// in its order, so the bit is the same. It reads the edge columns
// e = r[0..11] and w = r[21..] -- the 1/w numerators 21..23 (the w > 0
// test), column 24, the near and far dots 25..30 and, under kHw, the
// thresholds 31..33 -- and never the varying numerators 12..20, so a
// caller may pass the two runs of columns from separate storage.
template <bool kHw = false>
__device__ __forceinline__ bool cover_pixel(const float* e, const float* w,
                                            float px, float py) {
  const float f0 = mad(e[2], px - e[0], -(e[3] * (py - e[1])));
  const float f1 = mad(e[6], px - e[4], -(e[7] * (py - e[5])));
  const float f2 = mad(e[10], px - e[8], -(e[11] * (py - e[9])));
  const auto dot = [&](int k) {  // k: column - 21
    return mad(f2, w[k + 2], mad(f0, w[k], f1 * w[k + 1]));
  };
  const float aw = dot(0);
  const float az = dot(4);
  const float asum = dot(7);
  bool edges;
  if constexpr (kHw) {
    edges = (f0 >= w[10]) & (f1 >= w[11]) & (f2 >= w[12]);
  } else {
    edges = (f0 >= 0.0f) & (f1 >= 0.0f) & (f2 >= 0.0f);
  }
  return edges & (w[3] > 0.0f) & (az >= 0.0f) & (aw > 0.0f) &
         (asum - az >= 0.0f);
}

// tiles.py's resolve: 1/w with the |w| < 1e-20 guard, then the divides.
__device__ __forceinline__ float resolve_rcp(float accw) {
  return 1.0f / (fabsf(accw) < 1e-20f ? 1.0f : accw);
}

// ---- Triangle setup in registers (vtx.cu, packed.cu) ----
//
// The post-vertex-shader fields of a frame are SoA, kFields planes:
// x_fb, y_fb, w_clip, var0..2, z_ndc. setup_fields_core builds one
// triangle's record from its three corners with the f32 ops of
// _raster/setup.py:51-160 in their order; min/max propagate NaN as
// torch.minimum/maximum do, and clamp(-1e9, 1e9) precedes every float->int
// bbox conversion, so the record is bit-equal to torch's.

constexpr int kFields = 7;           // == vtx.FIELDS
constexpr float kWEps = 1e-8f;       // setup._W_EPS

struct Corner {
  float x, y, w, v0, v1, v2, zn;
};

struct Record {
  float col[31];
  int px0, px1, py0, py1;
  bool valid;
};

// Vertex v of one frame's SoA fields f (kFields planes of `stride` floats).
__device__ __forceinline__ Corner load_corner(const float* f, size_t stride,
                                              int v) {
  Corner c;
  c.x = f[v];
  c.y = f[stride + v];
  c.w = f[2 * stride + v];
  c.v0 = f[3 * stride + v];
  c.v1 = f[4 * stride + v];
  c.v2 = f[5 * stride + v];
  c.zn = f[6 * stride + v];
  return c;
}

// Near-plane (z_clip = 0) crossing of edge a->b (setup.py crossing()).
__device__ __forceinline__ bool crossing(float xa, float ya, float wa,
                                         float za, float xb, float yb,
                                         float wb, float zb, float* cx,
                                         float* cy) {
  const float denom = za - zb;
  const float safe = fabsf(denom) < 1e-30f ? 1e-30f : denom;
  const float t = za / safe;
  const bool crosses = (za < 0.0f) != (zb < 0.0f);
  const float wx = wa + t * (wb - wa);
  const float Xa = xa * wa, Ya = ya * wa;
  const float Xb = xb * wb, Yb = yb * wb;
  const float X = Xa + t * (Xb - Xa);
  const float Y = Ya + t * (Yb - Ya);
  const bool ok = crosses & (wx > kWEps);
  const float rw = 1.0f / (fabsf(wx) < 1e-30f ? 1e-30f : wx);
  *cx = X * rw;
  *cy = Y * rw;
  return ok;
}

__device__ __forceinline__ float srw(float w) {
  const float tiny = w < 0.0f ? -1e-12f : 1e-12f;
  return 1.0f / (fabsf(w) < 1e-12f ? tiny : w);
}

// Per-vertex terms of setup (setup.vertex_terms mirrors them in torch):
// the per-corner ops setup_fields_core does, so that a kernel which
// stages a vertex once (vf_vtx_cover) pays them once for the six
// triangles around it. A kernel that only tests coverage passes zero
// varyings: eval_pixel's a0..a2 are then never read, and record columns
// 12..20, the only ones vr feeds, are dead code.
struct VertexTerms {
  float x, y, w, zc;  // what setup_bbox reads; zc = z_ndc * w (clip z)
  float zn, rw;       // setup_columns adds these; rw = srw(w)
  float vr[3];        // v_k * rw: record columns 12..20
};

__device__ __forceinline__ VertexTerms vertex_terms(float x, float y, float w,
                                                    float zn, float v0,
                                                    float v1, float v2) {
  VertexTerms t;
  t.x = x;
  t.y = y;
  t.w = w;
  t.zc = zn * w;
  t.zn = zn;
  t.rw = srw(w);
  t.vr[0] = v0 * t.rw;
  t.vr[1] = v1 * t.rw;
  t.vr[2] = v2 * t.rw;
  return t;
}

// Vertex v of one frame's fields f without its varyings (the cover passes').
__device__ __forceinline__ VertexTerms position_terms(const float* f,
                                                      size_t stride, int v) {
  return vertex_terms(f[v], f[stride + v], f[2 * stride + v],
                      f[6 * stride + v], 0.0f, 0.0f, 0.0f);
}

struct Box {
  int px0, px1, py0, py1;  // the pixel-centre bbox, clamped to the frame
  bool valid;
};

// The cheap half of setup: the pixel-centre bbox and the valid flag, from
// x, y, w and clip z alone, bit for bit those of _raster/setup.py:51-123
// (setup.setup_bbox mirrors this in torch) with about half the
// instructions:
//  - torch.maximum/minimum propagate NaN, so a chain of them compared with
//    zero (any_near, any_w, any_far) is "no NaN, and one compare holds";
//  - the bbox chains take fminf/fmaxf over the selected points and flag a
//    NaN among them, which then becomes the bound, as torch's chain
//    gives it; a zero's sign, the one other way fminf may differ, cannot
//    change a pixel (+-0 - 0.5 = -0.5);
//  - a near-plane crossing is computed, and adds a point, only for an edge
//    whose ends straddle z_clip = 0: elsewhere crossing() returns
//    ok = false and its point is never selected. Such edges are rare, so
//    the branch costs the common triangle one compare per edge.
__device__ __forceinline__ void include_point(bool ok, float cx, float cy,
                                              float& xmin, float& xmax,
                                              float& ymin, float& ymax,
                                              bool& xnan, bool& ynan) {
  if (!ok) return;
  xmin = fminf(xmin, cx);
  xmax = fmaxf(xmax, cx);
  ymin = fminf(ymin, cy);
  ymax = fmaxf(ymax, cy);
  xnan |= isnan(cx);
  ynan |= isnan(cy);
}

__device__ __forceinline__ Box setup_bbox(const VertexTerms& a,
                                          const VertexTerms& b,
                                          const VertexTerms& c, int width,
                                          int height) {
  const float x0 = a.x, y0 = a.y, w0 = a.w, zc0 = a.zc;
  const float x1 = b.x, y1 = b.y, w1 = b.w, zc1 = b.zc;
  const float x2 = c.x, y2 = c.y, w2 = c.w, zc2 = c.zc;

  const float area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
  const bool neg0 = w0 < 0.0f, neg1 = w1 < 0.0f, neg2 = w2 < 0.0f;
  const bool odd_neg = neg0 ^ neg1 ^ neg2;
  const bool front = (odd_neg ? area2 : -area2) > 0.0f;
  const bool finite = isfinite(x0) & isfinite(x1) & isfinite(x2) &
                      isfinite(y0) & isfinite(y1) & isfinite(y2);

  const bool any_near = !(isnan(zc0) | isnan(zc1) | isnan(zc2)) &
                        ((zc0 >= 0.0f) | (zc1 >= 0.0f) | (zc2 >= 0.0f));
  const bool any_w = !(isnan(w0) | isnan(w1) | isnan(w2)) &
                     ((w0 > kWEps) | (w1 > kWEps) | (w2 > kWEps));
  const float f0 = zc0 - w0, f1 = zc1 - w1, f2 = zc2 - w2;
  const bool any_far = !(isnan(f0) | isnan(f1) | isnan(f2)) &
                       ((f0 <= 0.0f) | (f1 <= 0.0f) | (f2 <= 0.0f));
  const bool clean = (w0 > kWEps) & (w1 > kWEps) & (w2 > kWEps);

  // The selected points: the corners in front of the near plane, then the
  // crossings of the edges that straddle it.
  const float big = 3.4e37f;
  const bool s0 = zc0 >= 0.0f, s1 = zc1 >= 0.0f, s2 = zc2 >= 0.0f;
  float xmin = fminf(fminf(s0 ? x0 : big, s1 ? x1 : big), s2 ? x2 : big);
  float xmax = fmaxf(fmaxf(s0 ? x0 : -big, s1 ? x1 : -big), s2 ? x2 : -big);
  float ymin = fminf(fminf(s0 ? y0 : big, s1 ? y1 : big), s2 ? y2 : big);
  float ymax = fmaxf(fmaxf(s0 ? y0 : -big, s1 ? y1 : -big), s2 ? y2 : -big);
  bool xnan = (s0 & isnan(x0)) | (s1 & isnan(x1)) | (s2 & isnan(x2));
  bool ynan = (s0 & isnan(y0)) | (s1 & isnan(y1)) | (s2 & isnan(y2));
  const bool cut01 = (zc0 < 0.0f) != (zc1 < 0.0f);
  const bool cut12 = (zc1 < 0.0f) != (zc2 < 0.0f);
  const bool cut20 = (zc2 < 0.0f) != (zc0 < 0.0f);
  if (cut01 | cut12 | cut20) {
    float cx, cy;
    if (cut01) {
      const bool ok = crossing(x0, y0, w0, zc0, x1, y1, w1, zc1, &cx, &cy);
      include_point(ok, cx, cy, xmin, xmax, ymin, ymax, xnan, ynan);
    }
    if (cut12) {
      const bool ok = crossing(x1, y1, w1, zc1, x2, y2, w2, zc2, &cx, &cy);
      include_point(ok, cx, cy, xmin, xmax, ymin, ymax, xnan, ynan);
    }
    if (cut20) {
      const bool ok = crossing(x2, y2, w2, zc2, x0, y0, w0, zc0, &cx, &cy);
      include_point(ok, cx, cy, xmin, xmax, ymin, ymax, xnan, ynan);
    }
  }
  const float nan = __int_as_float(0x7fc00000);
  // w-crossing triangles: conservative full screen.
  xmin = clean ? (xnan ? nan : xmin) : 0.0f;
  xmax = clean ? (xnan ? nan : xmax) : (float)width;
  ymin = clean ? (ynan ? nan : ymin) : 0.0f;
  ymax = clean ? (ynan ? nan : ymax) : (float)height;

  Box r;
  r.px0 = max((int)ceilf(clampf(xmin, -1e9f, 1e9f) - 0.5f), 0);
  r.px1 = min((int)floorf(clampf(xmax, -1e9f, 1e9f) - 0.5f), width - 1);
  r.py0 = max((int)ceilf(clampf(ymin, -1e9f, 1e9f) - 0.5f), 0);
  r.py1 = min((int)floorf(clampf(ymax, -1e9f, 1e9f) - 0.5f), height - 1);
  const bool covers = (r.px0 <= r.px1) & (r.py0 <= r.py1);
  r.valid = front & finite & any_near & any_w & any_far & covers;
  return r;
}

// The record's 31 columns (_raster/setup.py:125-160) from its corners'
// terms; col[24] = valid.
__device__ __forceinline__ void setup_columns(const VertexTerms& a,
                                              const VertexTerms& b,
                                              const VertexTerms& c, bool valid,
                                              float* col) {
  const float x0 = a.x, y0 = a.y, x1 = b.x, y1 = b.y, x2 = c.x, y2 = c.y;
  const float area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
  const bool neg0 = a.w < 0.0f, neg1 = b.w < 0.0f, neg2 = c.w < 0.0f;
  // SIGNED reciprocals keep the projective functionals exact on the
  // clipped region (setup.py "Near-plane clipping").
  const float s0 = (neg1 ^ neg2) ? -1.0f : 1.0f;
  const float s1 = (neg2 ^ neg0) ? -1.0f : 1.0f;
  const float s2 = (neg0 ^ neg1) ? -1.0f : 1.0f;
  const float tau = area2 > 0.0f ? -1.0f : 1.0f;
  const float t0 = s0 * tau, t1 = s1 * tau, t2 = s2 * tau;

  col[0] = x1;  col[1] = y1;  col[2] = (y2 - y1) * s0;  col[3] = (x2 - x1) * s0;
  col[4] = x2;  col[5] = y2;  col[6] = (y0 - y2) * s1;  col[7] = (x0 - x2) * s1;
  col[8] = x0;  col[9] = y0;  col[10] = (y1 - y0) * s2; col[11] = (x1 - x0) * s2;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    col[12 + 3 * k] = a.vr[k] * t0;
    col[13 + 3 * k] = b.vr[k] * t1;
    col[14 + 3 * k] = c.vr[k] * t2;
  }
  col[21] = a.rw * t0;  col[22] = b.rw * t1;  col[23] = c.rw * t2;
  col[24] = valid ? 1.0f : 0.0f;
  col[25] = a.zn * t0;  col[26] = b.zn * t1;  col[27] = c.zn * t2;
  col[28] = t0;  col[29] = t1;  col[30] = t2;
}

__device__ __forceinline__ VertexTerms corner_terms(const Corner& c) {
  return vertex_terms(c.x, c.y, c.w, c.zn, c.v0, c.v1, c.v2);
}

// setup.setup_fields_core for one triangle, inclusive fill rule: the bbox
// test, then the columns.
__device__ __forceinline__ void setup_fields_core(const Corner& c0,
                                                  const Corner& c1,
                                                  const Corner& c2, int width,
                                                  int height, Record& r) {
  const VertexTerms a = corner_terms(c0), b = corner_terms(c1),
                    c = corner_terms(c2);
  const Box box = setup_bbox(a, b, c, width, height);
  r.px0 = box.px0;
  r.px1 = box.px1;
  r.py0 = box.py0;
  r.py1 = box.py1;
  r.valid = box.valid;
  setup_columns(a, b, c, box.valid, r.col);
}

// A resolve's record: setup_fields_core's columns without its bbox test
// (eval_pixel's a0..a2 and aw read columns 0..23 alone; col[24], valid,
// feeds only its cov, which a resolve does not read, and is left 0). The
// ops are setup_columns', written out from the corners: built through
// VertexTerms, the resolves took more registers and ran 4-12% longer
// (H100, scripts/torch_cover_ab.py).
__device__ __forceinline__ void resolve_record(const Corner& c0,
                                               const Corner& c1,
                                               const Corner& c2, Record& r) {
  const float x0 = c0.x, y0 = c0.y, w0 = c0.w, zn0 = c0.zn;
  const float x1 = c1.x, y1 = c1.y, w1 = c1.w, zn1 = c1.zn;
  const float x2 = c2.x, y2 = c2.y, w2 = c2.w, zn2 = c2.zn;
  const float area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
  const bool neg0 = w0 < 0.0f, neg1 = w1 < 0.0f, neg2 = w2 < 0.0f;
  const float rw0 = srw(w0), rw1 = srw(w1), rw2 = srw(w2);
  const float s0 = (neg1 ^ neg2) ? -1.0f : 1.0f;
  const float s1 = (neg2 ^ neg0) ? -1.0f : 1.0f;
  const float s2 = (neg0 ^ neg1) ? -1.0f : 1.0f;
  const float tau = area2 > 0.0f ? -1.0f : 1.0f;
  const float t0 = s0 * tau, t1 = s1 * tau, t2 = s2 * tau;
  float* col = r.col;
  col[0] = x1;  col[1] = y1;  col[2] = (y2 - y1) * s0;  col[3] = (x2 - x1) * s0;
  col[4] = x2;  col[5] = y2;  col[6] = (y0 - y2) * s1;  col[7] = (x0 - x2) * s1;
  col[8] = x0;  col[9] = y0;  col[10] = (y1 - y0) * s2; col[11] = (x1 - x0) * s2;
  const float va[3] = {c0.v0, c0.v1, c0.v2};
  const float vb[3] = {c1.v0, c1.v1, c1.v2};
  const float vc[3] = {c2.v0, c2.v1, c2.v2};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    col[12 + 3 * k] = va[k] * rw0 * t0;
    col[13 + 3 * k] = vb[k] * rw1 * t1;
    col[14 + 3 * k] = vc[k] * rw2 * t2;
  }
  col[21] = rw0 * t0;  col[22] = rw1 * t1;  col[23] = rw2 * t2;
  col[24] = 0.0f;
  col[25] = zn0 * t0;  col[26] = zn1 * t1;  col[27] = zn2 * t2;
  col[28] = t0;  col[29] = t1;  col[30] = t2;
}

// ---- The resolves (vtx.cu, packed.cu) ----
//
// Each resolve kernel reads a frame's winner plane (id + 1 per pixel, 0 =
// uncovered), rebuilds each winner's record from its three corners
// (resolve_record) and evaluates it at the pixel centre (eval_pixel,
// resolve_rcp). A block of kResolveThreads threads takes one frame's tile
// of kResolveTileW x kResolveTileH pixels, one pixel per thread, and a warp
// a kResolveWarpW x kResolveWarpH patch of it: neighbouring winners' corners
// share 32-byte sectors, which a 2-D tile finds in L1 and a row of 256
// pixels did not. The mapping is vtx.resolve_pixel_map's (kernels.load()
// checks the constants).
constexpr int kResolveThreads = 256;
constexpr int kResolveTileW = 32;     // == vtx.RESOLVE_TILE_W
constexpr int kResolveWarpW = 8;      // == vtx.RESOLVE_WARP_W
constexpr int kResolveTileH = kResolveThreads / kResolveTileW;
constexpr int kResolveWarpH = 32 / kResolveWarpW;
static_assert(kResolveTileW % kResolveWarpW == 0 && kResolveTileH % kResolveWarpH == 0,
              "a tile is a whole number of warp patches");

// Blocks of a resolve launch over `frames` frames.
inline long long resolve_blocks(long long frames, int width, int height) {
  return frames * ((width + kResolveTileW - 1) / kResolveTileW) *
         ((height + kResolveTileH - 1) / kResolveTileH);
}

// A resolve's corner: the six planes eval_pixel's a0..a2 and aw read.
// z_ndc (plane 6) feeds only the coverage bit, which a resolve drops, so it
// is not loaded (zn = 0 makes resolve_record's columns 25..27 constants
// that nothing reads).
__device__ __forceinline__ Corner resolve_corner(const float* f, size_t stride,
                                                 int v) {
  Corner c;
  c.x = f[v];
  c.y = f[stride + v];
  c.w = f[2 * stride + v];
  c.v0 = f[3 * stride + v];
  c.v1 = f[4 * stride + v];
  c.v2 = f[5 * stride + v];
  c.zn = 0.0f;
  return c;
}

// The outputs of a resolve: the g-buffer (v0..v2, mask), or the shipped
// shader's words (image) with its LUT ((256, 3) f32) and parameters
// (par: hr2, exposure, l0, l1, l2).
struct ResolveOut {
  float *v0, *v1, *v2;
  uint8_t* mask;
  const float* lut_rgb;
  const float* par;
  int32_t* image;
};

// The body of the resolve kernels. Block blockIdx.x takes tile
// blockIdx.x % tiles of frame blockIdx.x / tiles (tiles in row-major
// order); fields: (frames, kFields, nv) f32; verts(tri, v) puts triangle
// tri's vertex indices, in record order, into v. A covered pixel's thread
// loads its winner, the winner's vertex indices (packed.cu: three
// neighbouring index loads), then all 18 corner loads before it uses the
// first; an uncovered pixel loads nothing more. The shaded kernel reads
// the LUT through L1 (no staging, no barrier for it) and takes the clear
// colour's word from thread 0, which computes it once per block with the
// same shade_shipped call (cov = false: the word depends on no input).
template <bool kShade, class Verts>
__device__ __forceinline__ void resolve_tile(const float* __restrict__ fields,
                                             size_t nv, int width, int height,
                                             const int* __restrict__ winner,
                                             const ResolveOut& out, Verts verts) {
  __shared__ int32_t sclear;
  const int t = threadIdx.x;
  const int tiles_x = (width + kResolveTileW - 1) / kResolveTileW;
  const int tiles = tiles_x * ((height + kResolveTileH - 1) / kResolveTileH);
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int ty = tile / tiles_x;
  const int warp = t >> 5, lane = t & 31;
  constexpr int kAcross = kResolveTileW / kResolveWarpW;
  const int x = (tile - ty * tiles_x) * kResolveTileW + (warp % kAcross) * kResolveWarpW +
                lane % kResolveWarpW;
  const int y = ty * kResolveTileH + (warp / kAcross) * kResolveWarpH + lane / kResolveWarpW;
  const bool in = (x < width) & (y < height);
  const size_t o = (size_t)b * width * height + (size_t)y * width + x;
  const int w = in ? winner[o] : 0;
  Corner c[3];
  if (w > 0) {
    int v[3];
    verts(w - 1, v);
    const float* f = fields + (size_t)b * kFields * nv;
#pragma unroll
    for (int j = 0; j < 3; ++j) c[j] = resolve_corner(f, nv, v[j]);
  }
  if constexpr (kShade) {
    if (t == 0) {
      sclear = shade_shipped(0.0f, 0.0f, 0.0f, false, out.lut_rgb, out.par[0], out.par[1],
                             out.par[2], out.par[3], out.par[4]);
    }
    __syncthreads();
  }
  if (!in) return;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, accw = 1.0f;
  if (w > 0) {
    Record r;
    resolve_record(c[0], c[1], c[2], r);
    const PixelEval e = eval_pixel(r.col, (float)x + 0.5f, (float)y + 0.5f);
    acc0 = e.a0;
    acc1 = e.a1;
    acc2 = e.a2;
    accw = e.aw;
  }
  const float rcp = resolve_rcp(accw);
  const float v0 = acc0 * rcp;
  const float v1 = acc1 * rcp;
  const float v2 = acc2 * rcp;
  if constexpr (kShade) {
    out.image[o] = w > 0 ? shade_shipped(v0, v1, v2, true, out.lut_rgb, out.par[0],
                                         out.par[1], out.par[2], out.par[3], out.par[4])
                         : sclear;
  } else {
    out.v0[o] = v0;
    out.v1[o] = v1;
    out.v2[o] = v2;
    out.mask[o] = w > 0 ? 1 : 0;
  }
}

// A cover pass's survivor's bbox in two words: px0 (py0) in the low 26
// bits, px1 - px0 (py1 - py0), at most kBigPixels - 1 < 64, in the top 6.
// The wrappers keep frames below 2^26 pixels a side.
__device__ __forceinline__ uint2 pack_box(const Box& b) {
  return make_uint2((unsigned)b.px0 | ((unsigned)(b.px1 - b.px0) << 26),
                    (unsigned)b.py0 | ((unsigned)(b.py1 - b.py0) << 26));
}

// Walks a survivor's packed bbox (col: its record) and max-combines value
// into every pixel of plane whose centre it covers.
__device__ __forceinline__ void walk_box(const float* col, uint2 box,
                                         int* plane, int width, int value) {
  const int x0 = box.x & 0x3ffffff, x1 = x0 + (int)(box.x >> 26);
  const int y0 = box.y & 0x3ffffff, y1 = y0 + (int)(box.y >> 26);
  for (int y = y0; y <= y1; ++y) {
    for (int x = x0; x <= x1; ++x) {
      if (eval_pixel(col, (float)x + 0.5f, (float)y + 0.5f).cov)
        atomicMax(plane + y * width + x, value);
    }
  }
}

// The cover passes' survivor list: phase A of a block tests its
// triangles' bboxes (setup_bbox); those valid with at most kBigPixels
// bbox pixels are compacted here in a fixed order (a warp's ballots, then
// the warps' counts in order; no atomic), and phase B builds their
// records and walks their bboxes, the block's threads taking one each in
// turn.
template <int kCap, int kWarps>
struct Survivors {
  int slot[kCap];    // which triangle (its meaning is the kernel's)
  uint2 box[kCap];   // pack_box
  int warp_count[kWarps];
};

// All threads of the block, each with kN triangles: mask[k] = their warp's
// __ballot_sync of "keep triangle k". rank[k]: a kept triangle's place in
// the list (the warp's triangles k = 0 first, each in lane order, then
// k = 1, ..., after the earlier warps' kept triangles); *total: the
// block's kept triangles. Syncs twice.
template <int kN, int kCap, int kWarps>
__device__ __forceinline__ void survivor_ranks(Survivors<kCap, kWarps>& s,
                                               const unsigned (&mask)[kN],
                                               int (&rank)[kN], int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int count = 0;
#pragma unroll
  for (int k = 0; k < kN; ++k) count += __popc(mask[k]);
  if (lane == 0) s.warp_count[warp] = count;
  __syncthreads();
  int base = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int n = s.warp_count[w];
    base += w < warp ? n : 0;
    sum += n;
  }
  __syncthreads();
  *total = sum;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    rank[k] = base + __popc(mask[k] & below);
    base += __popc(mask[k]);
  }
}

// ---- The big-triangle walk (vtx.cu, packed.cu) ----
//
// A listed triangle's bbox can be the whole screen (every w-crossing
// triangle's is), yet most such triangles cover no pixel or a few tiles.
// A block of kBigThreads threads walks listed triangles (big_pass):
//   1. the lanes of warp 0 each build one listed triangle's record into
//      shared memory (a batch of kBigBatch) and reject it whole if one
//      functional is negative, with its margin, at its bbox's four corner
//      pixel centres;
//   2. for each surviving triangle the block cuts the bbox into kBigTile x
//      kBigTile tiles (tile (i, j) starts at (px0 + 16 i, py0 + 16 j),
//      clipped to the bbox), tests kBigThreads tiles at a time the same
//      way, one per thread, and compacts the survivors into a shared list
//      (a shared counter: the deposit is a max, so their order does not
//      matter);
//   3. and walks each surviving tile's pixels, one per thread, with
//      eval_pixel and atomicMax as walk_box does, bit for bit.
// vtx.big_tile_walk mirrors steps 1 and 2 in torch with these f64 ops in
// this order, so its tiles per triangle are the kernels' walk counts.
//
// Why a reject is conservative. In exact arithmetic the six quantities the
// coverage test compares with zero are affine in the pixel centre (px, py):
// the edges F_i = r[4i+2] (px - r[4i]) - r[4i+3] (py - r[4i+1]), and the
// three-term sums D_k = F_0 r[k] + F_1 r[k+1] + F_2 r[k+2] for aw (k = 21)
// and az (k = 25), and D_28 - D_25 for asum - az. eval_pixel evaluates them
// in f32 (u = 2^-24): with M_i = |r[4i+2]||px - r[4i]| + |r[4i+3]||py - r[4i+1]|,
// f_i = F_i + e_i, |e_i| <= 3.0001 u M_i (two subtractions, a product and a
// fused multiply-add, each rounded once); a sum's error is at most
// sum_i |r[k+i]| |e_i| + 3.001 u sum_i |r[k+i]| (|F_i| + |e_i|), and |F_i| <= M_i,
// so under 6.002 u S_k with S_k = sum_i |r[k+i]| M_i; asum - az adds one
// rounding, under 7.01 u (S_25 + S_28). The margins are 2^-20 M_i = 16 u M_i
// for an edge, 2^-19 S_k = 32 u S_k for a sum and 2^-19 (S_25 + S_28) for
// asum - az: at least 4x each bound. Each margin is a sum of non-negative
// multiples of |affine| terms, so value + margin is convex, and its maximum
// over a tile lies at a corner. So value + margin < 0 at the four corner
// pixel centres means the f32 value is negative at every pixel of the tile,
// and the test there fails (an edge needs f >= 0, aw > 0, az >= 0,
// asum - az >= 0). The f64 evaluation of value and margin errs by a few
// 2^-53 of the same magnitudes, negligible against margins of 2^-20
// relative. kFloor (2^-100, absolute) covers f32 underflow, whose absolute
// error is under 2^-148 per rounding. A functional whose magnitudes reach
// kLimit (2^120) never rejects, so no f32 intermediate of a rejecting
// functional can overflow; a record with any non-finite column never
// rejects, and its whole bbox is walked.

constexpr int kBigTile = 16;
constexpr int kBigThreads = kBigTile * kBigTile;  // one tile pixel per thread
constexpr double kEdgeMargin = 0x1p-20;
constexpr double kDotMargin = 0x1p-19;
constexpr double kFloor = 0x1p-100;
constexpr double kLimit = 0x1p120;

// Bit j set: functional j (f0, f1, f2, aw, az, asum - az) plus its margin
// is below zero at the pixel centre (px, py).
__device__ __forceinline__ unsigned outside_mask(const float* r, double px,
                                                 double py) {
  double E[3], M[3];
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double a = (double)r[4 * i + 2] * (px - (double)r[4 * i]);
    const double b = (double)r[4 * i + 3] * (py - (double)r[4 * i + 1]);
    E[i] = a - b;
    M[i] = (fabs(a) + fabs(b)) + kFloor;
    if ((E[i] + M[i] * kEdgeMargin < 0.0) & (M[i] < kLimit)) bits |= 1u << i;
  }
  const bool ok = (M[0] < kLimit) & (M[1] < kLimit) & (M[2] < kLimit);
  double D[3], S[3];
  const int base[3] = {21, 25, 28};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const double c0 = r[base[j]], c1 = r[base[j] + 1], c2 = r[base[j] + 2];
    D[j] = (E[0] * c0 + E[1] * c1) + E[2] * c2;
    S[j] = (fabs(c0) * M[0] + fabs(c1) * M[1]) + fabs(c2) * M[2];
  }
  if (ok & (S[0] < kLimit) & (D[0] + (S[0] * kDotMargin + kFloor) < 0.0))
    bits |= 1u << 3;
  if (ok & (S[1] < kLimit) & (D[1] + (S[1] * kDotMargin + kFloor) < 0.0))
    bits |= 1u << 4;
  if (ok & (S[1] < kLimit) & (S[2] < kLimit) &
      ((D[2] - D[1]) + ((S[2] + S[1]) * kDotMargin + kFloor) < 0.0))
    bits |= 1u << 5;
  return bits;
}

// Nonzero: one functional is below zero, with its margin, at all four
// corner pixel centres of the pixel rectangle [x0, x1] x [y0, y1].
__device__ __forceinline__ unsigned rect_mask(const float* r, int x0, int x1,
                                              int y0, int y1) {
  const double ax = (double)x0 + 0.5, bx = (double)x1 + 0.5;
  const double ay = (double)y0 + 0.5, by = (double)y1 + 0.5;
  unsigned m = outside_mask(r, ax, ay);
  if (m) m &= outside_mask(r, bx, ay);
  if (m) m &= outside_mask(r, ax, by);
  if (m) m &= outside_mask(r, bx, by);
  return m;
}

// Shared state of one block's big-triangle pass: a batch of up to
// kBigBatch listed triangles staged by warp 0, and the tile list of the
// one being walked.
constexpr int kBigBatch = 32;  // one listed triangle per lane of warp 0

struct BigBatch {
  float col[kBigBatch][31];
  int box[kBigBatch][4];  // px0, px1, py0, py1
  int frame[kBigBatch];
  int value[kBigBatch];   // id + 1
  int finite[kBigBatch];
  int order[kBigBatch];   // the batch slots not rejected whole
  int alive;
  int kept;
  int list[kBigThreads];
};

// All kBigThreads threads: deposit s's slot j at every covered pixel of the
// surviving tiles of its bbox (plane: its frame's winner plane). Returns
// the tiles walked, the same in every thread. Syncs before it returns.
__device__ __forceinline__ int big_walk(BigBatch& s, int j, int* plane,
                                        int width) {
  const int t = threadIdx.x;
  float c[31];
#pragma unroll
  for (int k = 0; k < 31; ++k) c[k] = s.col[j][k];
  const int px0 = s.box[j][0], px1 = s.box[j][1];
  const int py0 = s.box[j][2], py1 = s.box[j][3];
  const bool finite = s.finite[j];
  const int value = s.value[j];
  const int ntx = (px1 - px0 + kBigTile) / kBigTile;
  const int ntiles = ntx * ((py1 - py0 + kBigTile) / kBigTile);
  const int lx = t % kBigTile, ly = t / kBigTile;
  int walked = 0;
  for (int base = 0; base < ntiles; base += kBigThreads) {
    if (t == 0) s.kept = 0;
    __syncthreads();
    const int tile = base + t;
    if (tile < ntiles) {
      const int ty = tile / ntx;
      const int x0 = px0 + kBigTile * (tile - ty * ntx);
      const int y0 = py0 + kBigTile * ty;
      if (!finite || rect_mask(c, x0, min(x0 + kBigTile - 1, px1), y0,
                               min(y0 + kBigTile - 1, py1)) == 0) {
        s.list[atomicAdd(&s.kept, 1)] = tile;
      }
    }
    __syncthreads();
    const int kept = s.kept;
    walked += kept;
    for (int i = 0; i < kept; ++i) {
      const int tj = s.list[i];
      const int ty = tj / ntx;
      const int x = px0 + kBigTile * (tj - ty * ntx) + lx;
      const int y = py0 + kBigTile * ty + ly;
      if (x <= px1 && y <= py1 &&
          eval_pixel(c, (float)x + 0.5f, (float)y + 0.5f).cov) {
        atomicMax(plane + y * width + x, value);
      }
    }
    __syncthreads();
  }
  return walked;
}

// The body of both big-triangle kernels, for a block of kBigThreads threads
// in a persistent grid striding over big[0 .. *count) (entries frame*T +
// id). Block b takes entries b, b + G, b + 2G, ... (G = gridDim.x), a batch
// of kBigBatch at a time: lane k of warp 0 builds the record of entry
// first + k*G with build(frame, id, Record&), stages it in shared memory
// and tests its bbox's corners (the whole-triangle reject); the block then
// walks the batch's surviving triangles one after another (big_walk).
// walked: null, or receives the tiles walked per entry (0 if rejected
// whole).
template <class Build>
__device__ __forceinline__ void big_pass(const int* __restrict__ big,
                                         const int* __restrict__ count, int T,
                                         int width, int height, int* winner,
                                         int* walked, Build build) {
  __shared__ BigBatch s;
  const int t = threadIdx.x;
  const int total = *count;
  const int G = gridDim.x;
  for (int first = blockIdx.x; first < total; first += G * kBigBatch) {
    if (t < kBigBatch) {
      const int i = first + t * G;
      bool alive = false;
      if (i < total) {
        const int e = big[i];
        const int b = e / T;
        Record r;
        build(b, e - b * T, r);
        bool finite = true;
#pragma unroll
        for (int k = 0; k < 31; ++k) {
          s.col[t][k] = r.col[k];
          finite &= isfinite(r.col[k]);
        }
        s.box[t][0] = r.px0;
        s.box[t][1] = r.px1;
        s.box[t][2] = r.py0;
        s.box[t][3] = r.py1;
        s.frame[t] = b;
        s.value[t] = e - b * T + 1;
        s.finite[t] = finite;
        alive = !finite || rect_mask(r.col, r.px0, r.px1, r.py0, r.py1) == 0;
        if (!alive && walked != nullptr) walked[i] = 0;
      }
      const unsigned m = __ballot_sync(0xffffffffu, alive);
      if (alive) s.order[__popc(m & ((1u << t) - 1u))] = t;
      if (t == 0) s.alive = __popc(m);
    }
    __syncthreads();
    const int alive = s.alive;
    for (int a = 0; a < alive; ++a) {
      const int j = s.order[a];
      const int tiles =
          big_walk(s, j, winner + (size_t)s.frame[j] * width * height, width);
      if (walked != nullptr && t == 0) walked[first + j * G] = tiles;
    }
    __syncthreads();
  }
}

}  // namespace vf
