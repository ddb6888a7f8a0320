// Hand-written Hopper raster kernels of vulkan_forge_torch (sm_90a).
//
// Two kernels, one raster body:
//
//   vf_raster_gbuffer        replaces pallas_backend._kernel (K1, the list
//                            kernel) and strips._strip_kernel's inclusive
//                            rule (K7). Output: the perspective-divided
//                            varyings of the winning triangle and coverage.
//   vf_raster_shade_shipped  replaces packed._packed_kernel_resident_fused
//                            (K4) with the shipped fragment shader
//                            fragment.terrain_fs_tile (K2) fused into its
//                            epilogue. Output: one u32 RGBA word per pixel.
//
// What the TPU kernels compute: for each pixel, the highest-id triangle
// whose three edge functions and near/w/far clip functionals cover it
// (painter's order, no depth buffer). Here one thread block owns one
// (frame, 16x16 tile) and one thread owns one pixel. The block walks its
// tile's binned records (ascending triangle id, from setup.bin_tiles)
// through shared memory in chunks; every thread evaluates every record in
// order and overwrites its accumulators where it is covered, so the last
// cover is the maximum id. No cross-thread resolve, no atomics.
//
// What bounds it on an H100: the per-record ALU chain (~40 f32 ops per
// pixel per binned triangle) and the __syncthreads around each staged
// chunk; record bytes are small (31 floats per (tile, triangle) pair) and
// are read once per tile into shared memory, where all 256 threads read
// the same word (a broadcast, no bank conflicts). The design keeps
// everything between records in registers and writes each pixel once.
//
// Numerics: built with -fmad=false (no contraction) and without fast math,
// so every +, -, *, / and sqrtf rounds once, exactly as the plain PyTorch
// version (_raster/tiles.py, _raster/fragment.py) rounds its eager ops;
// the op order below is that of tiles.py:38-63 and fragment.py:105-148.
// Only sinf, cosf and powf may differ from the host library by ulps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;                  // == setup.TILE (vf_tile)
constexpr int kThreads = kTile * kTile;
constexpr int kChunk = 64;                 // records staged per pass
constexpr int kCols = 31;                  // live record columns 0..30
constexpr int kColsPad = 32;

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

template <bool kShade>
__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ records, int rec_stride,
              const int* __restrict__ rows, const int* __restrict__ offsets,
              int ntx, int nty, int width, int height,
              float* __restrict__ out0, float* __restrict__ out1,
              float* __restrict__ out2, uint8_t* __restrict__ mask,
              const float* __restrict__ lut_rgb,
              const float* __restrict__ par, int32_t* __restrict__ image) {
  __shared__ float srec[kChunk][kColsPad];
  __shared__ float slut[kShade ? 256 * 3 : 1];

  const int tile = blockIdx.x;              // frame * (ntx*nty) + tile
  const int nt = ntx * nty;
  const int frame = tile / nt;
  const int t = tile - frame * nt;
  const int ty = t / ntx;
  const int tx = t - ty * ntx;
  const int ix = tx * kTile + (int)(threadIdx.x % kTile);
  const int iy = ty * kTile + (int)(threadIdx.x / kTile);
  const float px = (float)ix + 0.5f;
  const float py = (float)iy + 0.5f;

  if (kShade) {
    for (int e = threadIdx.x; e < 256 * 3; e += kThreads) slut[e] = lut_rgb[e];
  }

  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, accw = 1.0f;
  bool covered = false;
  const int begin = offsets[tile];
  const int end = offsets[tile + 1];
  for (int base = begin; base < end; base += kChunk) {
    const int n = min(kChunk, end - base);
    __syncthreads();                        // previous chunk consumed
    for (int e = threadIdx.x; e < n * kCols; e += kThreads) {
      const int i = e / kCols;
      const int c = e - i * kCols;
      srec[i][c] = records[(size_t)rows[base + i] * rec_stride + c];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float* r = srec[i];
      const float f0 = r[2] * (px - r[0]) - r[3] * (py - r[1]);
      const float f1 = r[6] * (px - r[4]) - r[7] * (py - r[5]);
      const float f2 = r[10] * (px - r[8]) - r[11] * (py - r[9]);
      const float a0 = f0 * r[12] + f1 * r[13] + f2 * r[14];
      const float a1 = f0 * r[15] + f1 * r[16] + f2 * r[17];
      const float a2 = f0 * r[18] + f1 * r[19] + f2 * r[20];
      const float aw = f0 * r[21] + f1 * r[22] + f2 * r[23];
      // Clip-volume tests (near z>=0, camera-front w>0, far z<=w).
      const float az = f0 * r[25] + f1 * r[26] + f2 * r[27];
      const float asum = f0 * r[28] + f1 * r[29] + f2 * r[30];
      const bool cov = (f0 >= 0.0f) & (f1 >= 0.0f) & (f2 >= 0.0f) &
                       (r[24] > 0.0f) & (az >= 0.0f) & (aw > 0.0f) &
                       (asum - az >= 0.0f);
      if (cov) {
        acc0 = a0;
        acc1 = a1;
        acc2 = a2;
        accw = aw;
        covered = true;
      }
    }
  }
  if (kShade) __syncthreads();              // slut ready even for empty tiles

  if (ix >= width || iy >= height) return;
  const float rcp = 1.0f / (fabsf(accw) < 1e-20f ? 1.0f : accw);
  const float v0 = acc0 * rcp;
  const float v1 = acc1 * rcp;
  const float v2 = acc2 * rcp;
  const size_t o = ((size_t)frame * height + iy) * width + ix;
  if (kShade) {
    image[o] = shade_shipped(v0, v1, v2, covered, slut, par[0], par[1],
                             par[2], par[3], par[4]);
  } else {
    out0[o] = v0;
    out1[o] = v1;
    out2[o] = v2;
    mask[o] = covered ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// The tile edge in pixels; kernels.load() requires it to equal setup.TILE,
// which sizes the binning that the kernels walk.
int vf_tile() { return kTile; }

// records: (R, rec_stride) f32; rows: binned record rows; offsets:
// (n_tiles + 1) exclusive scan, n_tiles = frames * ntx * nty. Outputs are
// (frames, height, width). Returns cudaGetLastError() after the launch.
int vf_raster_gbuffer(const float* records, int rec_stride, const int* rows,
                      const int* offsets, int n_tiles, int ntx, int nty,
                      int width, int height, float* v0, float* v1, float* v2,
                      uint8_t* mask, void* stream) {
  if (n_tiles > 0) {
    raster_kernel<false><<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        records, rec_stride, rows, offsets, ntx, nty, width, height, v0, v1,
        v2, mask, nullptr, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}

// lut_rgb: (256, 3) f32 linear; par: [hr2, exposure, l0, l1, l2] f32 on
// the device; image: (frames, height, width) int32 RGBA words.
int vf_raster_shade_shipped(const float* records, int rec_stride,
                            const int* rows, const int* offsets, int n_tiles,
                            int ntx, int nty, int width, int height,
                            const float* lut_rgb, const float* par,
                            int32_t* image, void* stream) {
  if (n_tiles > 0) {
    raster_kernel<true><<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        records, rec_stride, rows, offsets, ntx, nty, width, height, nullptr,
        nullptr, nullptr, nullptr, lut_rgb, par, image);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
