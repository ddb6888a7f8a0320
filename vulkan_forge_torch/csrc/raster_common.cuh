// Device code shared by the port's raster kernels (raster.cu, vtx.cu).
//
// Built with -fmad=false and without fast math (see raster.cu), so every
// +, -, *, / and sqrtf rounds once, as the plain PyTorch versions round
// their eager ops; the op order is theirs (tiles.py:79-97,
// fragment.py:44-69).
#pragma once

#include <cuda_runtime.h>
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

// One record (columns 0..30 in the layout of setup.py) at one pixel
// centre: the three varying numerators, the 1/w numerator and coverage
// (edge functions, near z>=0, camera-front w>0, far z<=w).
struct PixelEval {
  float a0, a1, a2, aw;
  bool cov;
};

__device__ __forceinline__ PixelEval eval_pixel(const float* r, float px,
                                                float py) {
  const float f0 = r[2] * (px - r[0]) - r[3] * (py - r[1]);
  const float f1 = r[6] * (px - r[4]) - r[7] * (py - r[5]);
  const float f2 = r[10] * (px - r[8]) - r[11] * (py - r[9]);
  PixelEval e;
  e.a0 = f0 * r[12] + f1 * r[13] + f2 * r[14];
  e.a1 = f0 * r[15] + f1 * r[16] + f2 * r[17];
  e.a2 = f0 * r[18] + f1 * r[19] + f2 * r[20];
  e.aw = f0 * r[21] + f1 * r[22] + f2 * r[23];
  const float az = f0 * r[25] + f1 * r[26] + f2 * r[27];
  const float asum = f0 * r[28] + f1 * r[29] + f2 * r[30];
  e.cov = (f0 >= 0.0f) & (f1 >= 0.0f) & (f2 >= 0.0f) & (r[24] > 0.0f) &
          (az >= 0.0f) & (e.aw > 0.0f) & (asum - az >= 0.0f);
  return e;
}

// tiles.py's resolve: 1/w with the |w| < 1e-20 guard, then the divides.
__device__ __forceinline__ float resolve_rcp(float accw) {
  return 1.0f / (fabsf(accw) < 1e-20f ? 1.0f : accw);
}

}  // namespace vf
