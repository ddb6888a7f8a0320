// Hand-written Hopper kernels of the vertex-stream route (sm_90a).
//
// vf_vs_fields is the vertex stage of the vtx, indexed and segment routes:
// the post-vertex-shader fields, (frames, 7, n) f32 SoA, of every vertex
// under every camera, computed as vtx.vs_fields_plain computes them
// (transform.terrain_vs or terrain_vs_extended, then setup.clip_to_fb).
// The other kernels of this file read those fields.
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
// triangle's record is built in registers from its grid corners with the
// f32 ops of _raster/setup.py:51-160 in their order (raster_common.cuh,
// shared with packed.cu: setup_bbox, then setup_columns); triangle id =
// (r*(n-1) + c)*2 + k, tri0 = [A, C, B], tri1 = [B, C, D]
// (_mesh.build_grid_xyuv).
//
//   vf_vtx_cover: one block per (frame, patch of 16 x 32 grid cells), two
//     cells per thread (8 rows apart). The block stages the patch's
//     17 x 33 vertices into shared memory once (neighbouring threads read
//     neighbouring vertices of a grid row, every load of a thread issued
//     before the first arrives) as vertex terms: clip z, 1/w. Phase A:
//     each thread runs setup_bbox for its cells' four triangles. A valid
//     triangle whose bbox holds more than kBigPixels pixels (near the
//     camera, and every w-crossing triangle, whose bbox is the full
//     screen) goes to a device-side list; the others are compacted into a
//     shared list in a fixed order (warp ballots, no atomic). Phase B: the
//     block's threads take the survivors from the list, build the
//     coverage columns of their records from the staged terms and walk
//     their pixel-centre bboxes with atomicMax(winner, id + 1) at each
//     covered pixel.
//   vf_vtx_cover_big: persistent blocks stride over that list; the count
//     is read on the device (no host sync). Warp 0 builds 32 listed
//     triangles' records into shared memory at once, the block rejects a
//     triangle, or else each 16x16 tile of its bbox, where one coverage
//     functional is negative with a margin over its f32 error at all four
//     corners, and walks the surviving tiles' pixels with the same
//     atomicMax (vf::big_walk, raster_common.cuh, shared with packed.cu).
//   vf_vtx_resolve_*: one block per (frame, 32x8 pixel tile), one thread
//     per pixel, each warp an 8x4 patch (vf::resolve_tile, raster_common.cuh,
//     shared with packed.cu). The winner's three corners are decoded from
//     its id and loaded, 6 planes each (z_ndc feeds only coverage), the
//     record built again (vf::resolve_record: its columns, no bbox test)
//     and evaluated at the pixel centre, then divided as tiles.py:97 does;
//     uncovered pixels get zero varyings, or the shader's clear colour,
//     whose word thread 0 computes once per block.
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
// What bounds it on an H100 (grid=1024, 800x600, 4 orbit frames). Most
// triangles reach no pixel: about 30% are valid, and a valid one's bbox
// holds about one pixel. So the cover pass's least work is reading the 4
// position planes once (x, y, w, z_ndc; coverage never reads the
// varyings), 4*4*1024^2*4 B = 67 MB, ~20 us at 3.35 TB/s, and a bbox test
// of ~100 f32 ops per triangle (~13 us at 67 TFLOP/s) plus the coverage
// columns (~40 ops) of the valid small triangles and ~38 ops per bbox
// pixel. It used to be bound by setup: the whole 31-column record and
// nine IEEE divisions for every triangle, 152 registers (one block per
// SM), each vertex loaded by four threads and its terms recomputed by up
// to six triangles. The design: a vertex is loaded and its terms
// (including its one division) computed once per patch; the test reads
// 4 staged floats per corner, takes its min/max chains without NaN-aware
// selects (setup_bbox) and divides only where an edge straddles the near
// plane; records are built only for the survivors, spread evenly over the
// block's threads by the compaction, and the varying columns are never
// built; 63 registers, 4 blocks per SM. What is left is the test's
// instructions and the staging's latency, each block's loads arriving
// before its test can start (PERF.md has the times).
//
// The big pass's least work is its listed triangles' setup and the pixels
// they cover (not their bboxes: a w-crossing triangle's is the whole
// screen and it often covers nothing); the tile rejects bring the pixels
// it evaluates from the bboxes' ~10^8-10^9 down towards the covered ones.
// The resolve reads the winner (7.7 MB) and the winners' corner vertices
// and writes the image (7.7 MB) or g-buffer (25 MB). Winners are one pixel
// each and share few vertices, so in this SoA layout every corner load
// pulls a 32-byte sector of which it uses 4 bytes: the sectors the
// winners touch over 6 planes (~90 MB at g1024 x4, vtx.resolve_sectors)
// bound it, not the 28 bytes per distinct vertex. It used to take 256
// pixels of one row per block, whose warps shared few sectors: a 2-D tile
// lets neighbouring winners, whose corners lie in neighbouring grid rows,
// share them in L1. More pixels per thread, their gathers in flight
// together, did not pay: the kernel is bound by sector throughput, not by
// the latency of its chain, and the registers cost occupancy. The shaded
// kernel reads its LUT through L1 instead of staging it per block, and
// computes the clear colour's word once per block instead of three powf
// per uncovered pixel (PERF.md has the A/Bs). Nothing writes (T, 40)
// records or a (tile, id) pair sort to device memory.
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

using vf::Box;
using vf::Corner;
using vf::kFields;
using vf::load_corner;
using vf::Record;
using vf::setup_bbox;
using vf::setup_fields_core;
using vf::VertexTerms;

constexpr int kBigPixels = 64;       // == vtx.BIG_PIXELS (vf_vtx_big_pixels)
constexpr int kThreads = 256;
// vf_vtx_cover's patch of cells, kCells per thread, and the vertices it
// stages.
constexpr int kPatchRows = 16, kPatchCols = 32, kCells = 2, kTris = 2 * kCells;
static_assert(kPatchRows * kPatchCols == kCells * kThreads, "kCells cells per thread");
constexpr int kVCols = kPatchCols + 1;
constexpr int kVerts = (kPatchRows + 1) * kVCols;
// The register budget vf_vtx_cover is compiled for (__launch_bounds__).
constexpr int kCoverBlocksPerSM = 4;

// The record of triangle `tri` of a frame (fields of that frame at f).
__device__ __forceinline__ void triangle_record(const float* f, int n, int tri, int width,
                                                int height, Record& r) {
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

// The vertices of one block's patch of grid cells, as vertex terms in
// shared memory (no varyings: the cover pass tests coverage only), and its
// survivor list (slot: kTris * thread + k, k = 2 * j + triangle for the
// thread's j-th cell).
struct CoverPatch {
  float x[kVerts], y[kVerts], w[kVerts], zc[kVerts], zn[kVerts], rw[kVerts];
  vf::Survivors<kTris * kThreads, kThreads / 32> list;
};

__device__ __forceinline__ VertexTerms staged(const CoverPatch& s, int e) {
  VertexTerms t;
  t.x = s.x[e];
  t.y = s.y[e];
  t.w = s.w[e];
  t.zc = s.zc[e];
  t.zn = s.zn[e];
  t.rw = s.rw[e];
  t.vr[0] = t.vr[1] = t.vr[2] = 0.0f;
  return t;
}

// The staged index of corner `corner` (0..2) of triangle k (0: [A, C, B],
// 1: [B, C, D]) of the cell whose corner A is staged at a.
__device__ __forceinline__ int corner_at(int a, int k, int corner) {
  const int A = a, B = a + 1, C = a + kVCols, D = a + kVCols + 1;
  return corner == 1 ? C : (k == 0 ? (corner == 0 ? A : B) : (corner == 0 ? B : D));
}

// One block per (frame, patch of kPatchRows x kPatchCols cells), kCells
// cells per thread (rows j * kPatchRows / kCells apart); blockIdx.x =
// frame * patches + patch, patches in row-major order. survivors: null,
// or one count per block.
__global__ void __launch_bounds__(kThreads, kCoverBlocksPerSM)
vtx_cover_kernel(const float* __restrict__ fields, int n, int patches,
                 int width, int height, int* __restrict__ winner,
                 int* __restrict__ big, int* __restrict__ count,
                 int* __restrict__ survivors) {
  __shared__ CoverPatch s;
  const int t = threadIdx.x;
  const int cells = n - 1;
  const int b = blockIdx.x / patches;
  const int patch = blockIdx.x - b * patches;
  const int pcols = (cells + kPatchCols - 1) / kPatchCols;
  const int prow = patch / pcols;
  const int r0 = prow * kPatchRows, c0 = (patch - prow * pcols) * kPatchCols;
  const size_t n2 = (size_t)n * n;
  const float* f = fields + (size_t)b * kFields * n2;

  // Stage the patch's (kPatchRows+1) x (kPatchCols+1) vertices once, every
  // load of a thread issued before the first arrives; neighbouring threads
  // read neighbouring vertices of a grid row.
  constexpr int kSlots = (kVerts + kThreads - 1) / kThreads;
  float vx[kSlots], vy[kSlots], vw[kSlots], vz[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int e = t + j * kThreads;
    const int vr = e / kVCols, vc = e - vr * kVCols;
    if (e < kVerts && r0 + vr < n && c0 + vc < n) {
      const size_t v = (size_t)(r0 + vr) * n + c0 + vc;
      vx[j] = f[v];
      vy[j] = f[n2 + v];
      vw[j] = f[2 * n2 + v];
      vz[j] = f[6 * n2 + v];
    }
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int e = t + j * kThreads;
    const int vr = e / kVCols, vc = e - vr * kVCols;
    if (e < kVerts && r0 + vr < n && c0 + vc < n) {
      const VertexTerms v = vf::vertex_terms(vx[j], vy[j], vw[j], vz[j], 0.0f, 0.0f, 0.0f);
      s.x[e] = v.x;
      s.y[e] = v.y;
      s.w[e] = v.w;
      s.zc[e] = v.zc;
      s.zn[e] = v.zn;
      s.rw[e] = v.rw;
    }
  }
  __syncthreads();

  // Phase A: the bbox test of the thread's cells' two triangles each,
  // tri0 = [A, C, B] and tri1 = [B, C, D]. Big ones go to the device-side
  // list.
  const int T = 2 * cells * cells;
  unsigned mask[kTris];
  uint2 box[kTris];
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    const int lr = t / kPatchCols + j * (kPatchRows / kCells);
    const int lc = t % kPatchCols;
    const int row = r0 + lr, col = c0 + lc;
    const int a = lr * kVCols + lc;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      bool keep = false;
      if (row < cells && col < cells) {
        const Box bx = setup_bbox(staged(s, corner_at(a, k, 0)), staged(s, corner_at(a, k, 1)),
                                  staged(s, corner_at(a, k, 2)), width, height);
        if (bx.valid) {
          keep = (bx.px1 - bx.px0 + 1) * (bx.py1 - bx.py0 + 1) <= kBigPixels;
          if (!keep) big[atomicAdd(count, 1)] = b * T + 2 * (row * cells + col) + k;
        }
        box[2 * j + k] = vf::pack_box(bx);
      }
      mask[2 * j + k] = __ballot_sync(0xffffffffu, keep);
    }
  }

  // Compact the small valid triangles.
  int rank[kTris], total;
  vf::survivor_ranks(s.list, mask, rank, &total);
#pragma unroll
  for (int k = 0; k < kTris; ++k) {
    if ((mask[k] >> (t & 31)) & 1u) {
      s.list.slot[rank[k]] = kTris * t + k;
      s.list.box[rank[k]] = box[k];
    }
  }
  if (survivors != nullptr && t == 0) survivors[blockIdx.x] = total;
  __syncthreads();

  // Phase B: each thread takes survivors from the list, builds the
  // coverage columns of their records from the staged terms and walks
  // their bboxes.
  int* plane = winner + (size_t)b * width * height;
  for (int i = t; i < total; i += kThreads) {
    const int slot = s.list.slot[i];
    const int owner = slot / kTris, k = slot % kTris;
    const int lr = owner / kPatchCols + (k >> 1) * (kPatchRows / kCells);
    const int lc = owner % kPatchCols;
    const int a = lr * kVCols + lc;
    float rec[31];
    vf::setup_columns(staged(s, corner_at(a, k & 1, 0)), staged(s, corner_at(a, k & 1, 1)),
                      staged(s, corner_at(a, k & 1, 2)), true, rec);
    const int id = 2 * ((r0 + lr) * cells + c0 + lc) + (k & 1);
    vf::walk_box(rec, s.list.box[i], plane, width, id + 1);
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

// vf::resolve_tile over the grid's triangles: the vertex indices of triangle
// tri decoded from its id (tri0 = [A, C, B], tri1 = [B, C, D]).
template <bool kShade>
__global__ void __launch_bounds__(vf::kResolveThreads)
vtx_resolve_kernel(const float* __restrict__ fields, int n, int width, int height,
                   const int* __restrict__ winner, vf::ResolveOut out) {
  vf::resolve_tile<kShade>(fields, (size_t)n * n, width, height, winner, out,
                           [n](int tri, int(&v)[3]) {
                             const int cell = tri >> 1;
                             const int row = cell / (n - 1);
                             const int a = row * n + (cell - row * (n - 1));
                             const bool k = tri & 1;
                             v[0] = k ? a + 1 : a;
                             v[1] = a + n;
                             v[2] = k ? a + n + 1 : a + 1;
                           });
}

// ---- The vertex stage (vf_vs_fields) ----
//
// One thread per vertex: one 16-byte load of [x, z, u, v], the nearest
// height texel, the world position, then per frame the two 4x4 products
// and the viewport transform, seven coalesced stores. What bounds it is
// its bytes: 20 read and 28 written per vertex and frame (13.0M vertices,
// one frame: 0.62 GB, ~0.19 ms at 3.35 TB/s).
//
// Numerics: every op is the plain version's f32 op in its order (no FMA:
// -fmad=false), constants as torch rounds its Python scalars, IEEE
// division, and torch's clamp, which keeps a NaN.
constexpr int kVsThreads = 256;

// transform.sample_height_nearest's texel index along one axis:
// clamp(floor(c * size), 0, size - 1) as an integer. A NaN coordinate,
// which the plain version cannot index with, reads texel 0.
__device__ __forceinline__ int nearest_texel(float c, int size) {
  float t = floorf(c * (float)size);
  const float hi = (float)(size - 1);
  t = t < 0.0f ? 0.0f : (t > hi ? hi : t);
  return isnan(t) ? 0 : (int)t;
}

// transform._rows_times_mt for one vertex: out[i] = (v0 m[i][0] +
// v1 m[i][1]) + (v2 m[i][2] + v3 m[i][3]), m row-major 4x4.
__device__ __forceinline__ void rows_times_mt(const float (&v)[4],
                                              const float* __restrict__ m,
                                              float (&out)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float p0 = v[0] * __ldg(m + 4 * i), p1 = v[1] * __ldg(m + 4 * i + 1);
    const float p2 = v[2] * __ldg(m + 4 * i + 2), p3 = v[3] * __ldg(m + 4 * i + 3);
    out[i] = (p0 + p1) + (p2 + p3);
  }
}

// kShipped: transform.terrain_vs (analytic relief, varyings h, x, z);
// else terrain_vs_extended (varyings h, u, v). out: (frames, kFields, nv).
template <bool kShipped>
__global__ void __launch_bounds__(kVsThreads)
vs_fields_kernel(const float4* __restrict__ xyuv, int nv, const float* __restrict__ heights,
                 int ht, int wt, const float* __restrict__ views,
                 const float* __restrict__ projs, int frames,
                 const float* __restrict__ spacing, const float* __restrict__ exaggeration,
                 int width, int height, float* __restrict__ out) {
  const int v = blockIdx.x * kVsThreads + threadIdx.x;
  if (v >= nv) return;
  const float4 q = __ldg(xyuv + v);
  const float x = q.x, z = q.y;
  float h = __ldg(heights + (size_t)nearest_texel(q.w, ht) * wt + nearest_texel(q.z, wt));
  if constexpr (kShipped) {
    // transform.analytic_height
    h = h + (sinf(x * 1.3f) * 0.25f + cosf(z * 1.1f) * 0.25f);
  }
  float sp = __ldg(spacing);
  sp = isnan(sp) ? sp : fmaxf(sp, 1e-8f);  // torch.clamp_min(spacing, 1e-8)
  const float world[4] = {x * sp, h * __ldg(exaggeration), z * sp, 1.0f};
  const float var1 = kShipped ? x : q.z, var2 = kShipped ? z : q.w;
  const size_t plane = (size_t)nv;
  for (int b = 0; b < frames; ++b) {
    float view_pos[4], clip[4];
    rows_times_mt(world, views + 16 * b, view_pos);
    rows_times_mt(view_pos, projs + 16 * b, clip);
    // setup.clip_to_fb
    const float w = clip[3];
    const float safe_w = fabsf(w) < 1e-12f ? 1e-12f : w;
    const float ndc_x = clip[0] / safe_w;
    const float ndc_y = clip[1] / safe_w;
    const float ndc_z = clip[2] / safe_w;
    float* o = out + (size_t)b * kFields * plane + v;
    o[0] = (ndc_x * 0.5f + 0.5f) * (float)width;
    o[plane] = (0.5f - ndc_y * 0.5f) * (float)height;
    o[2 * plane] = w;
    o[3 * plane] = h;
    o[4 * plane] = var1;
    o[5 * plane] = var2;
    o[6 * plane] = ndc_z;
  }
}

}  // namespace

extern "C" {

// The big-triangle threshold; kernels.load() requires it to equal
// vtx.BIG_PIXELS, which the plain version splits by.
int vf_vtx_big_pixels() { return kBigPixels; }

// The blocks vf_vtx_cover launches per frame (its survivors output holds
// one count per block, frame by frame).
int vf_vtx_cover_patches(int n) {
  const int cells = n - 1;
  return ((cells + kPatchRows - 1) / kPatchRows) *
         ((cells + kPatchCols - 1) / kPatchCols);
}

// fields: (frames, 7, n*n) f32; winner: (frames, height, width) int32,
// zeroed by the caller; big: (frames * 2*(n-1)^2) int32; count: one int32,
// zeroed; survivors: null, or (frames * vf_vtx_cover_patches(n)) int32 that
// receives each block's small valid triangles (those it walks). Returns
// cudaGetLastError() after the launch.
int vf_vtx_cover(const float* fields, int frames, int n, int width,
                 int height, int* winner, int* big, int* count, int* survivors,
                 void* stream) {
  const int patches = vf_vtx_cover_patches(n);
  const long long blocks = (long long)frames * patches;
  if (blocks > 0) {
    vtx_cover_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        fields, n, patches, width, height, winner, big, count, survivors);
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

// The resolves' pixel tile width and warp patch width; kernels.load()
// requires them to equal vtx.RESOLVE_TILE_W and RESOLVE_WARP_W, which
// vtx.resolve_pixel_map mirrors.
int vf_resolve_tile_w() { return vf::kResolveTileW; }
int vf_resolve_warp_w() { return vf::kResolveWarpW; }

// Outputs (frames, height, width): v0..v2 f32 and mask u8.
int vf_vtx_resolve_gbuffer(const float* fields, int frames, int n, int width,
                           int height, const int* winner, float* v0,
                           float* v1, float* v2, uint8_t* mask, void* stream) {
  const long long blocks = vf::resolve_blocks(frames, width, height);
  if (blocks > 0) {
    const vf::ResolveOut out{v0, v1, v2, mask, nullptr, nullptr, nullptr};
    vtx_resolve_kernel<false><<<(unsigned)blocks, vf::kResolveThreads, 0,
                                (cudaStream_t)stream>>>(fields, n, width, height, winner,
                                                        out);
  }
  return (int)cudaGetLastError();
}

// lut_rgb: (256, 3) f32 linear; par: [hr2, exposure, l0, l1, l2] f32 on the
// device; image: (frames, height, width) int32 RGBA words.
int vf_vtx_resolve_shade_shipped(const float* fields, int frames, int n,
                                 int width, int height, const int* winner,
                                 const float* lut_rgb, const float* par,
                                 int32_t* image, void* stream) {
  const long long blocks = vf::resolve_blocks(frames, width, height);
  if (blocks > 0) {
    const vf::ResolveOut out{nullptr, nullptr, nullptr, nullptr, lut_rgb, par, image};
    vtx_resolve_kernel<true><<<(unsigned)blocks, vf::kResolveThreads, 0,
                               (cudaStream_t)stream>>>(fields, n, width, height, winner,
                                                       out);
  }
  return (int)cudaGetLastError();
}

// xyuv: (nv, 4) f32 [x, z, u, v], 16-byte aligned; heights: (ht, wt) f32;
// views, projs: (frames, 4, 4) f32 row-major; spacing, exaggeration: one
// f32 each, on the device; shipped: 1 for terrain_vs, 0 for
// terrain_vs_extended; out: (frames, 7, nv) f32.
int vf_vs_fields(const float* xyuv, int nv, const float* heights, int ht, int wt,
                 const float* views, const float* projs, int frames, const float* spacing,
                 const float* exaggeration, int width, int height, int shipped, float* out,
                 void* stream) {
  if (nv > 0 && frames > 0) {
    const unsigned blocks = (unsigned)(((long long)nv + kVsThreads - 1) / kVsThreads);
    const float4* q = reinterpret_cast<const float4*>(xyuv);
    if (shipped) {
      vs_fields_kernel<true><<<blocks, kVsThreads, 0, (cudaStream_t)stream>>>(
          q, nv, heights, ht, wt, views, projs, frames, spacing, exaggeration, width, height,
          out);
    } else {
      vs_fields_kernel<false><<<blocks, kVsThreads, 0, (cudaStream_t)stream>>>(
          q, nv, heights, ht, wt, views, projs, frames, spacing, exaggeration, width, height,
          out);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
