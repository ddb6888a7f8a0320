// Device code shared by the port's raster kernels (raster.cu, vtx.cu,
// packed.cu).
//
// Built with -fmad=false and without fast math (see raster.cu), so every
// +, -, *, / and sqrtf rounds once, as the plain PyTorch versions round
// their eager ops, and the multiply-adds of the record evaluation are
// fused as tiles.mad rounds them; the op order is theirs (tiles.eval_records,
// fragment.py:44-69).
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
// K2 fragment.terrain_fs_tile). lut: (256, 3) linear RGB in shared memory.
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

__device__ __forceinline__ float tmin(float a, float b) {
  // torch.minimum: NaN propagates.
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}

__device__ __forceinline__ float tmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

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

// setup.setup_fields_core for one triangle, inclusive fill rule.
__device__ __forceinline__ void setup_fields_core(const Corner& c0,
                                                  const Corner& c1,
                                                  const Corner& c2, int width,
                                                  int height, Record& r) {
  const float x0 = c0.x, y0 = c0.y, w0 = c0.w, zn0 = c0.zn;
  const float x1 = c1.x, y1 = c1.y, w1 = c1.w, zn1 = c1.zn;
  const float x2 = c2.x, y2 = c2.y, w2 = c2.w, zn2 = c2.zn;

  const float area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
  const bool neg0 = w0 < 0.0f, neg1 = w1 < 0.0f, neg2 = w2 < 0.0f;
  const bool odd_neg = neg0 ^ neg1 ^ neg2;
  const bool front = (odd_neg ? area2 : -area2) > 0.0f;
  const bool finite = isfinite(x0) & isfinite(x1) & isfinite(x2) &
                      isfinite(y0) & isfinite(y1) & isfinite(y2);

  const float zc0 = zn0 * w0, zc1 = zn1 * w1, zc2 = zn2 * w2;
  const bool any_near = tmax(tmax(zc0, zc1), zc2) >= 0.0f;
  const bool any_w = tmax(tmax(w0, w1), w2) > kWEps;
  const bool any_far = tmin(tmin(zc0 - w0, zc1 - w1), zc2 - w2) <= 0.0f;
  const bool clean = (w0 > kWEps) & (w1 > kWEps) & (w2 > kWEps);

  float cx01, cy01, cx12, cy12, cx20, cy20;
  const bool ok01 = crossing(x0, y0, w0, zc0, x1, y1, w1, zc1, &cx01, &cy01);
  const bool ok12 = crossing(x1, y1, w1, zc1, x2, y2, w2, zc2, &cx12, &cy12);
  const bool ok20 = crossing(x2, y2, w2, zc2, x0, y0, w0, zc0, &cx20, &cy20);
  const bool sel[6] = {zc0 >= 0.0f, zc1 >= 0.0f, zc2 >= 0.0f, ok01, ok12, ok20};
  const float xs[6] = {x0, x1, x2, cx01, cx12, cx20};
  const float ys[6] = {y0, y1, y2, cy01, cy12, cy20};

  const float big = 3.4e37f;
  float xmin = big, xmax = -big, ymin = big, ymax = -big;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    xmin = tmin(xmin, sel[i] ? xs[i] : big);
    xmax = tmax(xmax, sel[i] ? xs[i] : -big);
    ymin = tmin(ymin, sel[i] ? ys[i] : big);
    ymax = tmax(ymax, sel[i] ? ys[i] : -big);
  }
  // w-crossing triangles: conservative full screen.
  xmin = clean ? xmin : 0.0f;
  xmax = clean ? xmax : (float)width;
  ymin = clean ? ymin : 0.0f;
  ymax = clean ? ymax : (float)height;

  r.px0 = max((int)ceilf(clampf(xmin, -1e9f, 1e9f) - 0.5f), 0);
  r.px1 = min((int)floorf(clampf(xmax, -1e9f, 1e9f) - 0.5f), width - 1);
  r.py0 = max((int)ceilf(clampf(ymin, -1e9f, 1e9f) - 0.5f), 0);
  r.py1 = min((int)floorf(clampf(ymax, -1e9f, 1e9f) - 0.5f), height - 1);
  const bool covers = (r.px0 <= r.px1) & (r.py0 <= r.py1);
  r.valid = front & finite & any_near & any_w & any_far & covers;

  // SIGNED reciprocals keep the projective functionals exact on the
  // clipped region (setup.py "Near-plane clipping").
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
  col[24] = r.valid ? 1.0f : 0.0f;
  col[25] = zn0 * t0;  col[26] = zn1 * t1;  col[27] = zn2 * t2;
  col[28] = t0;  col[29] = t1;  col[30] = t2;
}

// Max-combine `value` into *dst if r covers the pixel centre (px, py).
__device__ __forceinline__ void deposit(const Record& r, float px, float py,
                                        int* dst, int value) {
  if (eval_pixel(r.col, px, py).cov) atomicMax(dst, value);
}

}  // namespace vf
