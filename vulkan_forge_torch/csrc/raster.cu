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
// the per-pixel evaluation and the shader are in raster_common.cuh, shared
// with vtx.cu, in the op order of tiles.py:79-97 and fragment.py:44-69.
// Only sinf, cosf and powf may differ from the host library by ulps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

constexpr int kTile = 16;                  // == setup.TILE (vf_tile)
constexpr int kThreads = kTile * kTile;
constexpr int kChunk = 64;                 // records staged per pass
constexpr int kCols = 31;                  // live record columns 0..30
constexpr int kColsPad = 32;

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
      const vf::PixelEval e = vf::eval_pixel(srec[i], px, py);
      if (e.cov) {
        acc0 = e.a0;
        acc1 = e.a1;
        acc2 = e.a2;
        accw = e.aw;
        covered = true;
      }
    }
  }
  if (kShade) __syncthreads();              // slut ready even for empty tiles

  if (ix >= width || iy >= height) return;
  const float rcp = vf::resolve_rcp(accw);
  const float v0 = acc0 * rcp;
  const float v1 = acc1 * rcp;
  const float v2 = acc2 * rcp;
  const size_t o = ((size_t)frame * height + iy) * width + ix;
  if (kShade) {
    image[o] = vf::shade_shipped(v0, v1, v2, covered, slut, par[0], par[1],
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
