// Hand-written Hopper kernels of the vertex-stream route (sm_90a).
//
// Replace the TPU's vertex-stream kernels for dense grid meshes:
//
//   vf_vtx_cover + vf_vtx_cover_big + vf_vtx_resolve_gbuffer
//       replace vtx._vtx_kernel (K3a, vulkan_forge/_raster/vtx.py:590):
//       the perspective-divided varyings of the winning triangle, and
//       coverage.
//   vf_vtx_cover + vf_vtx_cover_big + vf_vtx_resolve_shade_shipped
//       replace vtx._vtx_kernel_fused (K3b, vtx.py:616): the shipped
//       fragment shader (K2) in the resolve, one u32 RGBA word per pixel.
//
// What they compute, as K3a/K3b do: for each pixel, the highest-id grid
// triangle whose three edge functions and near/w/far clip functionals
// cover the pixel centre (painter's order, no depth buffer). The input is
// the post-vertex-shader fields of the (n, n) vertex grid, SoA
// (frames, 7, n*n) f32: x_fb, y_fb, w_clip, var0..2, z_ndc. Every
// triangle's record is built in registers from its grid corners by
// setup_fields_core (raster_common.cuh, shared with packed.cu), the f32
// ops of _raster/setup.py:51-160 in their order; triangle id = (r*(n-1) + c)*2 + k, tri0 = [A, C, B],
// tri1 = [B, C, D] (_mesh.build_grid_xyuv).
//
//   vf_vtx_cover: one thread per (frame, grid cell). Neighbouring threads
//     read neighbouring vertices, so the loads coalesce. For both
//     triangles: setup, then a walk of the pixel-centre bbox with
//     atomicMax(winner, id + 1) at each covered pixel. A triangle whose
//     bbox holds more than kBigPixels pixels (near the camera, and every
//     w-crossing triangle, whose bbox is the full screen) goes to a
//     device-side list instead.
//   vf_vtx_cover_big: persistent blocks stride over that list; the count
//     is read on the device (no host sync). Warp 0 builds 32 listed
//     triangles' records into shared memory at once, the block rejects a
//     triangle, or else each 16x16 tile of its bbox, where one coverage
//     functional is negative with a margin over its f32 error at all four
//     corners, and walks the surviving tiles' pixels with the same
//     atomicMax (vf::big_walk, raster_common.cuh, shared with packed.cu).
//   vf_vtx_resolve_*: one thread per pixel. The winner's record is built
//     again from its corners and evaluated at the pixel centre, then
//     divided as tiles.py:97 does; uncovered pixels get zero varyings (or
//     the shader's clear colour).
//
// Atomics and determinism. The JAX package's rule is "no atomics"
// (CLAUDE.md). The port allows one kind: an integer atomicMax on painter
// ids. A maximum of integers is the same in any order, so the winner --
// and every byte derived from it -- is the same on every run. The
// big-triangle list is filled with atomicAdd and its order changes from
// run to run; each listed triangle is deposited with the same atomicMax,
// so the order cannot change a pixel. No float is ever accumulated
// atomically.
//
// What bounds it on an H100 (grid=1024, 800x600, 4 frames): the cover
// pass reads the fields once, 4*7*1024^2*4 B = 117 MB, ~35 us at
// 3.35 TB/s; its in-register setup is ~230 f32 ops per triangle (counted
// from setup_fields_core: 3 near-plane crossings of ~22 ops, four
// 6-way min/max chains of 12, the 31 columns, the flags) over 8.37M
// triangles, ~1.9 GFLOP, ~29 us at 67 TFLOP/s, plus ~25 ops per bbox
// pixel of the walk. So it is memory-bound at ~0.035 ms per batch. The big
// pass's least work is its listed triangles' setup and the pixels they
// cover (not their bboxes: a w-crossing triangle's is the whole screen and
// it often covers nothing); the tile rejects bring the pixels it evaluates
// from the bboxes' ~10^8-10^9 down towards the covered ones. The
// resolve reads the winner (7.7 MB) and the winners' corner vertices and
// writes the image (7.7 MB) or g-buffer (25 MB). The design reads the
// fields once and never writes (T, 40) records or a (tile, id) pair sort
// to device memory. It does not yet reach that bound: warps diverge on bbox walks,
// and a later PR may stage vertex rows through shared memory or keep
// per-tile winners in shared memory.
//
// Numerics: -fmad=false, no fast math; 1.0f/x is IEEE division; min/max
// propagate NaN as torch.minimum/maximum do; clamp(-1e9, 1e9) precedes
// every float->int bbox conversion, as in setup.py. So the records are
// bit-equal to the plain version's and to the record route's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

using vf::Corner;
using vf::deposit;
using vf::kFields;
using vf::load_corner;
using vf::Record;
using vf::setup_fields_core;

constexpr int kBigPixels = 64;       // == vtx.BIG_PIXELS (vf_vtx_big_pixels)
constexpr int kThreads = 256;

// The corners of triangle `tri` of a frame (fields of that frame at f).
__device__ __forceinline__ void triangle_record(const float* f, int n, int tri,
                                                int width, int height,
                                                Record& r) {
  const int n2 = n * n;
  const int cell = tri >> 1;
  const int row = cell / (n - 1);
  const int a = row * n + (cell - row * (n - 1));
  const Corner A = load_corner(f, n2, a);
  const Corner B = load_corner(f, n2, a + 1);
  const Corner C = load_corner(f, n2, a + n);
  if ((tri & 1) == 0) {
    setup_fields_core(A, C, B, width, height, r);
  } else {
    const Corner D = load_corner(f, n2, a + n + 1);
    setup_fields_core(B, C, D, width, height, r);
  }
}

__global__ void __launch_bounds__(kThreads)
vtx_cover_kernel(const float* __restrict__ fields, int frames, int n,
                 int width, int height, int* __restrict__ winner,
                 int* __restrict__ big, int* __restrict__ count) {
  const int cells = n - 1;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)frames * cells * cells) return;
  const int b = (int)(g / ((long long)cells * cells));
  const int cell = (int)(g - (long long)b * cells * cells);
  const int row = cell / cells;
  const int a = row * n + (cell - row * cells);
  const int n2 = n * n;
  const float* f = fields + (size_t)b * kFields * n2;
  const int T = 2 * cells * cells;
  int* plane = winner + (size_t)b * width * height;

  const Corner A = load_corner(f, n2, a);
  const Corner B = load_corner(f, n2, a + 1);
  const Corner C = load_corner(f, n2, a + n);
  const Corner D = load_corner(f, n2, a + n + 1);
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {
    Record r;
    if (k == 0) {
      setup_fields_core(A, C, B, width, height, r);
    } else {
      setup_fields_core(B, C, D, width, height, r);
    }
    if (!r.valid) continue;
    const int id = 2 * cell + k;
    const int bw = r.px1 - r.px0 + 1;
    if (bw * (r.py1 - r.py0 + 1) > kBigPixels) {
      big[atomicAdd(count, 1)] = b * T + id;
      continue;
    }
    for (int y = r.py0; y <= r.py1; ++y) {
      for (int x = r.px0; x <= r.px1; ++x) {
        deposit(r, (float)x + 0.5f, (float)y + 0.5f, plane + y * width + x,
                id + 1);
      }
    }
  }
}

__global__ void __launch_bounds__(vf::kBigThreads)
vtx_cover_big_kernel(const float* __restrict__ fields, int n, int width,
                     int height, const int* __restrict__ big,
                     const int* __restrict__ count, int* __restrict__ winner,
                     int* __restrict__ walked) {
  vf::big_pass(big, count, 2 * (n - 1) * (n - 1), width, height, winner,
               walked, [&](int b, int id, Record& r) {
                 triangle_record(fields + (size_t)b * kFields * n * n, n, id,
                                 width, height, r);
               });
}

template <bool kShade>
__global__ void __launch_bounds__(kThreads)
vtx_resolve_kernel(const float* __restrict__ fields, int frames, int n,
                   int width, int height, const int* __restrict__ winner,
                   float* __restrict__ out0, float* __restrict__ out1,
                   float* __restrict__ out2, uint8_t* __restrict__ mask,
                   const float* __restrict__ lut_rgb,
                   const float* __restrict__ par, int32_t* __restrict__ image) {
  __shared__ float slut[kShade ? 256 * 3 : 1];
  if (kShade) {
    for (int e = threadIdx.x; e < 256 * 3; e += blockDim.x) slut[e] = lut_rgb[e];
    __syncthreads();
  }
  const size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = (size_t)width * height;
  if (o >= (size_t)frames * plane) return;
  const int b = (int)(o / plane);
  const int p = (int)(o - (size_t)b * plane);
  const int iy = p / width;
  const int ix = p - iy * width;
  const int w = winner[o];

  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, accw = 1.0f;
  if (w > 0) {
    Record r;
    triangle_record(fields + (size_t)b * kFields * n * n, n, w - 1, width,
                    height, r);
    const vf::PixelEval e =
        vf::eval_pixel(r.col, (float)ix + 0.5f, (float)iy + 0.5f);
    acc0 = e.a0;
    acc1 = e.a1;
    acc2 = e.a2;
    accw = e.aw;
  }
  const float rcp = vf::resolve_rcp(accw);
  const float v0 = acc0 * rcp;
  const float v1 = acc1 * rcp;
  const float v2 = acc2 * rcp;
  if (kShade) {
    image[o] = vf::shade_shipped(v0, v1, v2, w > 0, slut, par[0], par[1],
                                 par[2], par[3], par[4]);
  } else {
    out0[o] = v0;
    out1[o] = v1;
    out2[o] = v2;
    mask[o] = w > 0 ? 1 : 0;
  }
}

int blocks_for(long long items) {
  return (int)((items + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// The big-triangle threshold; kernels.load() requires it to equal
// vtx.BIG_PIXELS, which the plain version splits by.
int vf_vtx_big_pixels() { return kBigPixels; }

// fields: (frames, 7, n*n) f32; winner: (frames, height, width) int32,
// zeroed by the caller; big: (frames * 2*(n-1)^2) int32; count: one int32,
// zeroed. Returns cudaGetLastError() after the launch.
int vf_vtx_cover(const float* fields, int frames, int n, int width,
                 int height, int* winner, int* big, int* count, void* stream) {
  const long long items = (long long)frames * (n - 1) * (n - 1);
  if (items > 0) {
    vtx_cover_kernel<<<blocks_for(items), kThreads, 0, (cudaStream_t)stream>>>(
        fields, frames, n, width, height, winner, big, count);
  }
  return (int)cudaGetLastError();
}

// Walks the triangles vf_vtx_cover listed in big[0 .. *count). walked: null,
// or (frames * 2*(n-1)^2) int32 that receives the tiles walked for each
// list entry (walked[i] for big[i], i < *count).
int vf_vtx_cover_big(const float* fields, int n, int width, int height,
                     const int* big, const int* count, int* winner,
                     int* walked, void* stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  vtx_cover_big_kernel<<<4 * sms, vf::kBigThreads, 0, (cudaStream_t)stream>>>(
      fields, n, width, height, big, count, winner, walked);
  return (int)cudaGetLastError();
}

// The big-triangle pass's tile side; kernels.load() requires it to equal
// vtx.BIG_TILE, the torch mirror's.
int vf_big_tile() { return vf::kBigTile; }

// Outputs (frames, height, width): v0..v2 f32 and mask u8.
int vf_vtx_resolve_gbuffer(const float* fields, int frames, int n, int width,
                           int height, const int* winner, float* v0,
                           float* v1, float* v2, uint8_t* mask, void* stream) {
  const long long items = (long long)frames * width * height;
  if (items > 0) {
    vtx_resolve_kernel<false><<<blocks_for(items), kThreads, 0,
                                (cudaStream_t)stream>>>(
        fields, frames, n, width, height, winner, v0, v1, v2, mask, nullptr,
        nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}

// lut_rgb: (256, 3) f32 linear; par: [hr2, exposure, l0, l1, l2] f32 on the
// device; image: (frames, height, width) int32 RGBA words.
int vf_vtx_resolve_shade_shipped(const float* fields, int frames, int n,
                                 int width, int height, const int* winner,
                                 const float* lut_rgb, const float* par,
                                 int32_t* image, void* stream) {
  const long long items = (long long)frames * width * height;
  if (items > 0) {
    vtx_resolve_kernel<true><<<blocks_for(items), kThreads, 0,
                               (cudaStream_t)stream>>>(
        fields, frames, n, width, height, winner, nullptr, nullptr, nullptr,
        nullptr, lut_rgb, par, image);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
