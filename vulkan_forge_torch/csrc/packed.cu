// Hand-written Hopper kernels of the indexed-mesh route (sm_90a).
//
// Replace the TPU's packed-stream kernels for arbitrary triangle meshes
// (the Renderer's DEM grids, any index buffer):
//
//   vf_packed_cover + vf_packed_cover_big + vf_packed_resolve_gbuffer
//       replace packed._packed_kernel (K5, vulkan_forge/_raster/packed.py:222)
//       and packed._packed_id_kernel + _varyings_from_ids (K6,
//       packed.py:580 and :704), merged: the winner id first, then the
//       varyings rebuilt from the winner, as K6 does.
//
// What they compute, as K5/K6 do: for each pixel, the highest-id triangle
// (draw order = position in the index buffer) whose three edge functions
// and near/w/far clip functionals cover the pixel centre (painter's order,
// no depth buffer), its perspective-divided varyings and the coverage mask.
// The inputs are the post-vertex-shader fields of the N vertices, SoA
// (frames, 7, N) f32 (x_fb, y_fb, w_clip, var0..2, z_ndc; the layout of
// vtx.cu), and the (T, 3) int32 index buffer shared by all frames. Every
// triangle's record is built in registers from its three indexed corners,
// in index order, by setup_fields_core (raster_common.cuh): the records of
// the plain version and of the record route (setup.setup_cols), bit for bit.
//
//   vf_packed_cover: one thread per (frame, triangle). It reads the
//     triangle's three indices and 7 fields per corner, runs setup, and
//     walks the pixel-centre bbox with atomicMax(winner, id + 1) at each
//     covered pixel. A triangle whose bbox holds more than kBigPixels
//     pixels (near the camera; every w-crossing triangle, whose bbox is the
//     full screen) goes to a device-side list as frame*T + id instead.
//   vf_packed_cover_big: persistent blocks stride over that list, the
//     count read on the device (no host sync). Warp 0 builds 32 listed
//     triangles' records into shared memory at once, the block rejects a
//     triangle, or else each 16x16 tile of its bbox, where one coverage
//     functional is negative with a margin over its f32 error at all four
//     corners, and walks the surviving tiles' pixels with the same
//     atomicMax (vf::big_walk, raster_common.cuh, shared with vtx.cu).
//   vf_packed_resolve_gbuffer: one thread per pixel. The winner's record
//     is built again from its indexed corners and evaluated at the pixel
//     centre, then divided as tiles.py:97 does (K6's _varyings_from_ids in
//     its f32 op order); uncovered pixels get zero varyings.
//
// What the TPU layout had that this does not: no 128 B/triangle lane
// packing, no DMA slab ring, no per-column worklists -- those fed VMEM.
// Painter ids are int32 (frames * T < 2^31, checked by the wrapper), so
// K5's `exact_ids` split compare, which kept f32 ids exact at T >= 2^24,
// has no counterpart: the SRTM 1" tile (3601^2, T = 25,920,000) is one
// integer compare like any other mesh. No (T, 40) record reaches device
// memory.
//
// Atomics: an integer atomicMax on painter ids, the one kind the port
// allows (ROADMAP, vtx.cu): a maximum of integers is the same in any order,
// so every byte is the same on every run; the big list's order varies and
// cannot change a pixel. No float is accumulated atomically.
//
// What bounds it on an H100 (DEM-2048, 800x600, one frame, T = 8.38M): the
// cover pass reads 7 f32 per vertex (117 MB for 4.19M vertices) and 12 B
// of indices per triangle (101 MB), ~65 us at 3.35 TB/s; its setup is
// ~220 f32 ops per triangle, ~1.8 GFLOP, ~28 us at 67 TFLOP/s. So it is
// memory-bound. Corners are read through the index buffer, so each vertex
// is fetched by up to six triangles; the L2 cache (50 MB) catches most of
// the repeats when neighbouring threads hold neighbouring triangles, as a
// grid's index order gives. Later work: stage vertex rows through shared
// memory, keep per-tile winners in shared memory.
//
// The big pass's least work is its listed triangles' indices, corners and
// setup, and the pixels they cover, each written once. It used to walk
// every bbox pixel: 2-3 x 10^9 at a close-in + w-crossing camera pair over
// DEM-2048, whose w-crossing triangles have full-screen bboxes and mostly
// cover nothing. The triangle and tile rejects of vf::big_walk leave the
// pixels of the tiles a triangle may cover.
//
// Numerics: -fmad=false, no fast math (see raster_common.cuh).

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

constexpr int kBigPixels = 64;       // == vtx.BIG_PIXELS (vf_packed_big_pixels)
constexpr int kThreads = 256;

// Triangle `tri` of a frame: its corners through the index buffer, in
// index order (f: that frame's fields, nv vertices per plane).
__device__ __forceinline__ void indexed_record(const float* f, int nv,
                                               const int* __restrict__ idx,
                                               int tri, int width, int height,
                                               Record& r) {
  const int* t = idx + 3 * (size_t)tri;
  const Corner c0 = load_corner(f, nv, t[0]);
  const Corner c1 = load_corner(f, nv, t[1]);
  const Corner c2 = load_corner(f, nv, t[2]);
  setup_fields_core(c0, c1, c2, width, height, r);
}

__global__ void __launch_bounds__(kThreads)
packed_cover_kernel(const float* __restrict__ fields, int frames, int nv,
                    const int* __restrict__ indices, int T, int width,
                    int height, int* __restrict__ winner,
                    int* __restrict__ big, int* __restrict__ count) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)frames * T) return;
  const int b = (int)(g / T);
  const int id = (int)(g - (long long)b * T);
  Record r;
  indexed_record(fields + (size_t)b * kFields * nv, nv, indices, id, width,
                 height, r);
  if (!r.valid) return;
  const int bw = r.px1 - r.px0 + 1;
  if (bw * (r.py1 - r.py0 + 1) > kBigPixels) {
    big[atomicAdd(count, 1)] = (int)g;
    return;
  }
  int* plane = winner + (size_t)b * width * height;
  for (int y = r.py0; y <= r.py1; ++y) {
    for (int x = r.px0; x <= r.px1; ++x) {
      deposit(r, (float)x + 0.5f, (float)y + 0.5f, plane + y * width + x,
              id + 1);
    }
  }
}

__global__ void __launch_bounds__(vf::kBigThreads)
packed_cover_big_kernel(const float* __restrict__ fields, int nv,
                        const int* __restrict__ indices, int T, int width,
                        int height, const int* __restrict__ big,
                        const int* __restrict__ count,
                        int* __restrict__ winner, int* __restrict__ walked) {
  vf::big_pass(big, count, T, width, height, winner, walked,
               [&](int b, int id, Record& r) {
                 indexed_record(fields + (size_t)b * kFields * nv, nv, indices,
                                id, width, height, r);
               });
}

__global__ void __launch_bounds__(kThreads)
packed_resolve_kernel(const float* __restrict__ fields, int frames, int nv,
                      const int* __restrict__ indices, int width, int height,
                      const int* __restrict__ winner,
                      float* __restrict__ out0, float* __restrict__ out1,
                      float* __restrict__ out2, uint8_t* __restrict__ mask) {
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
    indexed_record(fields + (size_t)b * kFields * nv, nv, indices, w - 1,
                   width, height, r);
    const vf::PixelEval e =
        vf::eval_pixel(r.col, (float)ix + 0.5f, (float)iy + 0.5f);
    acc0 = e.a0;
    acc1 = e.a1;
    acc2 = e.a2;
    accw = e.aw;
  }
  const float rcp = vf::resolve_rcp(accw);
  out0[o] = acc0 * rcp;
  out1[o] = acc1 * rcp;
  out2[o] = acc2 * rcp;
  mask[o] = w > 0 ? 1 : 0;
}

int blocks_for(long long items) {
  return (int)((items + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// The big-triangle threshold; kernels.load() requires it to equal
// vtx.BIG_PIXELS, which the plain version splits by.
int vf_packed_big_pixels() { return kBigPixels; }

// fields: (frames, 7, nv) f32; indices: (T, 3) int32 in [0, nv); winner:
// (frames, height, width) int32, zeroed by the caller; big: (frames * T)
// int32; count: one int32, zeroed. Returns cudaGetLastError() after the
// launch.
int vf_packed_cover(const float* fields, int frames, int nv,
                    const int* indices, int T, int width, int height,
                    int* winner, int* big, int* count, void* stream) {
  const long long items = (long long)frames * T;
  if (items > 0) {
    packed_cover_kernel<<<blocks_for(items), kThreads, 0,
                          (cudaStream_t)stream>>>(
        fields, frames, nv, indices, T, width, height, winner, big, count);
  }
  return (int)cudaGetLastError();
}

// Walks the triangles vf_packed_cover listed in big[0 .. *count). walked:
// null, or (frames * T) int32 that receives the tiles walked for each list
// entry (walked[i] for big[i], i < *count).
int vf_packed_cover_big(const float* fields, int nv, const int* indices,
                        int T, int width, int height, const int* big,
                        const int* count, int* winner, int* walked,
                        void* stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (T > 0) {
    packed_cover_big_kernel<<<4 * sms, vf::kBigThreads, 0,
                              (cudaStream_t)stream>>>(
        fields, nv, indices, T, width, height, big, count, winner, walked);
  }
  return (int)cudaGetLastError();
}

// Outputs (frames, height, width): v0..v2 f32 and mask u8.
int vf_packed_resolve_gbuffer(const float* fields, int frames, int nv,
                              const int* indices, int width, int height,
                              const int* winner, float* v0, float* v1,
                              float* v2, uint8_t* mask, void* stream) {
  const long long items = (long long)frames * width * height;
  if (items > 0) {
    packed_resolve_kernel<<<blocks_for(items), kThreads, 0,
                            (cudaStream_t)stream>>>(
        fields, frames, nv, indices, width, height, winner, v0, v1, v2,
        mask);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
