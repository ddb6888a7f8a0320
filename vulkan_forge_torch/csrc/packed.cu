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
// in index order (raster_common.cuh: setup_bbox, then setup_columns): the
// records of the plain version and of the record route
// (setup.setup_cols), bit for bit.
//
//   vf_packed_cover: one block per (frame, 768 triangles), three per
//     thread (256 apart). Phase A: each thread reads its triangles' indices
//     and 4 fields per corner (x, y, w, z_ndc), every load issued before
//     the first arrives, and runs setup_bbox. A valid triangle whose bbox
//     holds more than kBigPixels pixels (near the camera; every w-crossing
//     triangle, whose bbox is the full screen) goes to a device-side list
//     as frame*T + id; the other valid ones are compacted into a shared
//     list in a fixed order (warp ballots, no atomic). Phase B: the block's
//     threads take the survivors from the list, read their corners again,
//     build the coverage columns of their records and walk their
//     pixel-centre bboxes with atomicMax(winner, id + 1) at each covered
//     pixel. No thread reads a varying: coverage does not depend on them.
//   vf_packed_cover_big: persistent blocks stride over that list, the
//     count read on the device (no host sync). Warp 0 builds 32 listed
//     triangles' records into shared memory at once, the block rejects a
//     triangle, or else each 16x16 tile of its bbox, where one coverage
//     functional is negative with a margin over its f32 error at all four
//     corners, and walks the surviving tiles' pixels with the same
//     atomicMax (vf::big_walk, raster_common.cuh, shared with vtx.cu).
//   vf_packed_resolve_gbuffer: one block per (frame, 32x8 pixel tile),
//     one thread per pixel, each warp an 8x4 patch (vf::resolve_tile,
//     raster_common.cuh, shared with vtx.cu). The winner's three indices
//     are loaded together, then its corners' 6 planes (z_ndc feeds only
//     coverage), the record built again (vf::resolve_record: its columns,
//     no bbox test) and evaluated at the pixel centre, then divided as
//     tiles.py:97 does (K6's _varyings_from_ids in its f32 op order);
//     uncovered pixels get zero varyings. Two dependent rounds of loads
//     follow the winner's: indices, then corners. What bounds it is the
//     sectors those gathers touch (packed.resolve_sectors: a corner load
//     uses 4 bytes of its 32-byte sector, and a DEM's neighbouring pixels
//     rarely share a winner's vertex); the 2-D tile shares what sectors
//     neighbouring winners do share in L1 (PERF.md).
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
// What bounds it on an H100 (DEM-2048, 800x600, one frame, T = 8.38M).
// Only 7% of the triangles are valid at the default camera, each with a
// one-pixel bbox. So the cover pass's least work is reading the 4
// position planes (67 MB for 4.19M vertices) and 12 B of indices per
// triangle (101 MB) once, ~50 us at 3.35 TB/s, and a bbox test of ~100 f32
// ops per triangle (~13 us at 67 TFLOP/s): it is memory-bound. It used to
// be bound by latency: every thread built the whole record (24 dependent
// loads, nine divisions) before asking whether its triangle was valid,
// one triangle at a time. Now a thread keeps three triangles' loads in
// flight (9 index loads, then 36 field loads), takes the cheap test
// (setup_bbox), divides only where an edge straddles the near plane, and
// phase B builds records for the survivors alone, packed onto the first
// threads of the block rather than one or two per warp. 64 registers, 4
// blocks per SM; ptxas spills 8 bytes (16 loaded), which cost less than
// the third triangle's loads in flight gain. Corners are read through
// the index buffer, so each vertex is fetched by up to six triangles: a
// grid's index order keeps those triangles in neighbouring threads and
// blocks, so the L1 and L2 caches (50 MB of L2 against 67 MB of position
// planes) serve most repeats; phase B's reads hit the lines phase A just
// brought in. A soup's arbitrary indices get no such reuse, and pay it in
// time, not in correctness. What is left is latency: each block's test
// waits for its index loads and then its gathers (PERF.md has the times).
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

using vf::Box;
using vf::Corner;
using vf::kFields;
using vf::load_corner;
using vf::Record;
using vf::setup_bbox;
using vf::setup_fields_core;
using vf::VertexTerms;

constexpr int kBigPixels = 64;       // == vtx.BIG_PIXELS (vf_packed_big_pixels)
constexpr int kThreads = 256;
// vf_packed_cover's triangles per thread and per block, and the register
// budget it is compiled for (__launch_bounds__).
constexpr int kPerThread = 3, kCoverTris = kPerThread * kThreads;
constexpr int kCoverBlocksPerSM = 4;

// Triangle `tri` of a frame: its corners through the index buffer, in
// index order (f: that frame's fields, nv vertices per plane), and its
// record.
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

// Survivor list of one block (slot: the triangle's place in the block's
// range) and the corners of each survivor, read again in phase B.
struct CoverList {
  vf::Survivors<kCoverTris, kThreads / 32> list;
  int4 corners[kCoverTris];  // the three vertex indices (w unused)
};

// One block per (frame, kCoverTris triangles), kPerThread triangles per
// thread (kThreads apart); blockIdx.x = frame * blocks + j for triangles
// [j*kCoverTris, (j+1)*kCoverTris). survivors: null, or one count per
// block.
__global__ void __launch_bounds__(kThreads, kCoverBlocksPerSM)
packed_cover_kernel(const float* __restrict__ fields, int nv,
                    const int* __restrict__ indices, int T, int blocks,
                    int width, int height, int* __restrict__ winner,
                    int* __restrict__ big, int* __restrict__ count,
                    int* __restrict__ survivors) {
  __shared__ CoverList s;
  const int t = threadIdx.x;
  const int b = blockIdx.x / blocks;
  const int first = (blockIdx.x - b * blocks) * kCoverTris;
  const float* f = fields + (size_t)b * kFields * nv;

  // Phase A: every thread issues its triangles' index loads, then their
  // corners' x, y, w and z_ndc loads, before the first arrives, then tests
  // their bboxes. Big ones go to the device-side list.
  int v[kPerThread][3];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int id = first + t + k * kThreads;
#pragma unroll
    for (int j = 0; j < 3; ++j) v[k][j] = id < T ? indices[3 * (size_t)id + j] : 0;
  }
  VertexTerms c[kPerThread][3];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (first + t + k * kThreads < T) {
#pragma unroll
      for (int j = 0; j < 3; ++j) c[k][j] = vf::position_terms(f, nv, v[k][j]);
    }
  }
  unsigned mask[kPerThread];
  uint2 box[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int id = first + t + k * kThreads;
    bool keep = false;
    if (id < T) {
      const Box bx = setup_bbox(c[k][0], c[k][1], c[k][2], width, height);
      if (bx.valid) {
        keep = (bx.px1 - bx.px0 + 1) * (bx.py1 - bx.py0 + 1) <= kBigPixels;
        if (!keep) big[atomicAdd(count, 1)] = b * T + id;
      }
      box[k] = vf::pack_box(bx);
    }
    mask[k] = __ballot_sync(0xffffffffu, keep);
  }
  int rank[kPerThread], total;
  vf::survivor_ranks(s.list, mask, rank, &total);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if ((mask[k] >> (t & 31)) & 1u) {
      s.list.slot[rank[k]] = t + k * kThreads;
      s.list.box[rank[k]] = box[k];
      s.corners[rank[k]] = make_int4(v[k][0], v[k][1], v[k][2], 0);
    }
  }
  if (survivors != nullptr && t == 0) survivors[blockIdx.x] = total;
  __syncthreads();

  // Phase B: each thread takes survivors from the list, reads their
  // corners again (this block just fetched them, so the caches hold them),
  // builds the coverage columns of their records and walks their bboxes.
  int* plane = winner + (size_t)b * width * height;
  for (int i = t; i < total; i += kThreads) {
    const int4 q = s.corners[i];
    float rec[31];
    vf::setup_columns(vf::position_terms(f, nv, q.x), vf::position_terms(f, nv, q.y),
                      vf::position_terms(f, nv, q.z), true, rec);
    vf::walk_box(rec, s.list.box[i], plane, width, first + s.list.slot[i] + 1);
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

// vf::resolve_tile over the index buffer: a winner's three vertex indices
// are three neighbouring loads, issued together.
__global__ void __launch_bounds__(vf::kResolveThreads)
packed_resolve_kernel(const float* __restrict__ fields, int nv,
                      const int* __restrict__ indices, int width, int height,
                      const int* __restrict__ winner, vf::ResolveOut out) {
  vf::resolve_tile<false>(fields, nv, width, height, winner, out,
                          [indices](int tri, int(&v)[3]) {
                            const int* t = indices + 3 * (size_t)tri;
                            v[0] = t[0];
                            v[1] = t[1];
                            v[2] = t[2];
                          });
}

}  // namespace

extern "C" {

// The big-triangle threshold; kernels.load() requires it to equal
// vtx.BIG_PIXELS, which the plain version splits by.
int vf_packed_big_pixels() { return kBigPixels; }

// The blocks vf_packed_cover launches per frame (its survivors output
// holds one count per block, frame by frame).
int vf_packed_cover_blocks(int T) { return (T + kCoverTris - 1) / kCoverTris; }

// fields: (frames, 7, nv) f32; indices: (T, 3) int32 in [0, nv); winner:
// (frames, height, width) int32, zeroed by the caller; big: (frames * T)
// int32; count: one int32, zeroed; survivors: null, or (frames *
// vf_packed_cover_blocks(T)) int32 that receives each block's small valid
// triangles (those it walks). Returns cudaGetLastError() after the launch.
int vf_packed_cover(const float* fields, int frames, int nv,
                    const int* indices, int T, int width, int height,
                    int* winner, int* big, int* count, int* survivors,
                    void* stream) {
  const int per_frame = vf_packed_cover_blocks(T);
  const long long blocks = (long long)frames * per_frame;
  if (blocks > 0) {
    packed_cover_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
        fields, nv, indices, T, per_frame, width, height, winner, big, count,
        survivors);
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
  const long long blocks = vf::resolve_blocks(frames, width, height);
  if (blocks > 0) {
    const vf::ResolveOut out{v0, v1, v2, mask, nullptr, nullptr, nullptr};
    packed_resolve_kernel<<<(unsigned)blocks, vf::kResolveThreads, 0,
                            (cudaStream_t)stream>>>(fields, nv, indices, width, height,
                                                    winner, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
