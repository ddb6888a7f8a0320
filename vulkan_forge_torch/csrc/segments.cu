// Hand-written Hopper segment-walk kernels of vulkan_forge_torch (sm_90a):
// the tall-frame route (_raster/segments.py).
//
// Two kernels, one body templated on the shader (kShade):
//
//   vf_seg_gbuffer        replaces segments._seg_kernel (K8,
//                         vulkan_forge/_raster/segments.py:159). Output: the
//                         perspective-divided varyings of the winning
//                         triangle and coverage.
//   vf_seg_shade_shipped  the same walk with the shipped fragment shader
//                         (fragment.terrain_fs, K2's function) fused into
//                         its epilogue: what K8 followed by
//                         fragment.terrain_fs computes for a shipped frame
//                         (vulkan_forge/_raster/pipeline.py:520-543).
//
// What K8 computes: over a culled, compacted record stream (the original
// triangle id of each record beside it), for each pixel the covering
// record with the largest original id. Each 8x128 tile walks the mesh rows
// active in its tile row (r_bounds) and, for each, the row's interval of
// compacted positions that overlaps its tile column (row_base + [seg_lo,
// seg_hi]). That walk is conservative: an interval holds every triangle of
// its row in the tile column, whichever tile rows they touch, so K8's walk
// visits 6-73x the (tile, triangle) pairs whose bbox overlaps the tile.
//
// Here one thread block owns one (frame, tile) and its 1,024 pixels, 256
// threads with 4 pixels each (one column, rows ly, ly+2, ly+4, ly+6), and
// only the overlapping pairs reach the per-pixel evaluation:
//
//   1. Interval skip, block-uniform, no barrier: an empty interval, or one
//      whose y-extent (seg_y: min y0, max y1 over the triangles that join
//      it) misses the tile row, is not scanned.
//   2. Record skip: the block scans an interval 256 records at a time, one
//      compacted bbox per thread (int4, the bbox bin_tiles and segment_bin
//      use), tests it against the tile's pixel rectangle and compacts the
//      survivors' stream positions into a circular list in shared memory
//      (__ballot_sync, __popc and a prefix over the 8 warps).
//   3. Staging: every 64 survivors, their first 32 record columns (31 live,
//      then the zero hw threshold; rows are 160 B, so 16-byte aligned) go
//      into one slot of a double-buffered shared ring by 16-byte cp.async,
//      and their ids beside them; the previous slot is evaluated meanwhile.
//   4. Evaluation from the ring: every thread evaluates every staged record
//      at its pixels (vf::eval_pixel, the fused multiply-adds of every
//      route) and keeps (best id, a0, a1, a2, aw) per pixel in registers,
//      replacing them where the record covers the pixel and its id is
//      larger.
//
// A skipped pair cannot cover a pixel of the tile (coverage implies the
// pixel centre lies in the bbox), and the maximum id wins whatever the
// order, so the output is the plain walk's bit for bit. Blocks launch in
// tile_order (the tiles that scan the most records first, so the horizon's
// long walks do not start last); a block still owns its pixels: no
// atomics. With a non-null `evaluated`, thread 0 writes the count of
// evaluated pairs of its tile there (a check: it equals the overlapping
// pairs).
//
// Ids are int32 beside the records, not record columns 32..34 as in the
// reference (segments.py:53-55): the port's columns 31..33 hold the hw
// rule's edge thresholds, and an int32 id is exact for any T < 2^31, so
// K8's (id >> 12, id & 4095) split compare for T >= 2^24 has no
// counterpart. K8's 8-row DMA alignment and double buffering are TPU
// layout and are not carried over.
//
// What bounds it on an H100: the per-(pixel, record) ALU chain (~52 f32
// ops) over the overlapping pairs; then the scan (one 16-byte bbox load
// and a barrier per 256 walked records of the surviving intervals) and the
// sequential row loop (a few broadcast loads per active row).
//
// Numerics: built with -fmad=false and without fast math, like raster.cu;
// the evaluation and the shader are raster_common.cuh's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

constexpr int kTileH = 8;                  // == segments.TILE_H (vf_seg_tile_h)
constexpr int kTileW = 128;                // == segments.TILE_W (vf_seg_tile_w)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerPass = kThreads / kTileW;   // 2
constexpr int kPix = kTileH / kRowsPerPass;       // 4 pixels per thread
constexpr int kBatch = 64;                 // records per ring slot
constexpr int kVec = 8;                    // float4s staged per record: columns 0..31
constexpr int kList = 512;                 // circular survivor list; > kBatch - 1 + kThreads

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <bool kShade>
__global__ void __launch_bounds__(kThreads)
seg_kernel(const float* __restrict__ records, int rec_stride,
           const int* __restrict__ ids, const int4* __restrict__ bbox,
           const int* __restrict__ seg_lo, const int* __restrict__ seg_hi,
           const int2* __restrict__ seg_y, const int* __restrict__ row_base,
           const int* __restrict__ r_bounds, const int* __restrict__ tile_order,
           int rows, int ntx, int nty, int width, int height,
           float* __restrict__ out0, float* __restrict__ out1,
           float* __restrict__ out2, uint8_t* __restrict__ mask,
           const float* __restrict__ lut_rgb, const float* __restrict__ par,
           int32_t* __restrict__ image, int* __restrict__ evaluated) {
  __shared__ __align__(16) float4 ring[2][kBatch][kVec];
  __shared__ int ring_id[2][kBatch];
  __shared__ int pending[kList];
  __shared__ int warp_hits[2][kWarps];
  __shared__ float slut[kShade ? 256 * 3 : 1];

  const int frame = blockIdx.y;
  const int n_tiles = ntx * nty;
  const int tile = tile_order[(size_t)frame * n_tiles + blockIdx.x];
  const int ty = tile / ntx;
  const int tx = tile - ty * ntx;
  const int tile_x = tx * kTileW;          // the tile's pixel rectangle
  const int tile_y = ty * kTileH;
  const int lane = (int)(threadIdx.x % 32);
  const int warp = (int)(threadIdx.x / 32);
  const int ix = tile_x + (int)(threadIdx.x % kTileW);
  const int ly = (int)(threadIdx.x / kTileW);
  const float px = (float)ix + 0.5f;
  float py[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    py[k] = (float)(tile_y + ly + k * kRowsPerPass) + 0.5f;
  }

  if (kShade) {
    for (int e = threadIdx.x; e < 256 * 3; e += kThreads) slut[e] = lut_rgb[e];
    __syncthreads();
  }

  int best[kPix];
  float acc0[kPix], acc1[kPix], acc2[kPix], accw[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    best[k] = -1;
    acc0[k] = 0.0f;
    acc1[k] = 0.0f;
    acc2[k] = 0.0f;
    accw[k] = 1.0f;
  }

  // Block-uniform state: survivors pending in the list from `head`; the
  // slot `cur` holds `staged` records whose copies are in flight.
  int head = 0, n_pending = 0, cur = 0, staged = 0, n_eval = 0, pass = 0;

  const auto evaluate = [&](int slot, int n) {
    for (int i = 0; i < n; ++i) {
      const float* rec = reinterpret_cast<const float*>(ring[slot][i]);
      const int id = ring_id[slot][i];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const vf::PixelEval e = vf::eval_pixel(rec, px, py[k]);
        if (e.cov && id > best[k]) {
          best[k] = id;
          acc0[k] = e.a0;
          acc1[k] = e.a1;
          acc2[k] = e.a2;
          accw[k] = e.aw;
        }
      }
    }
  };

  // Stage the next n pending survivors into the free slot, then evaluate
  // the slot staged before (its copies land while this one's are issued).
  const auto next_batch = [&](int n) {
    __syncthreads();                        // the list entries are written
    const int slot = cur ^ 1;
    for (int e = threadIdx.x; e < n * kVec; e += kThreads) {
      const int i = e / kVec;
      const int q = e - i * kVec;
      const int pos = pending[(head + i) % kList];
      cp_async16(&ring[slot][i][q], records + (size_t)pos * rec_stride + q * 4);
    }
    if ((int)threadIdx.x < n) {
      ring_id[slot][threadIdx.x] = ids[pending[(head + (int)threadIdx.x) % kList]];
    }
    cp_async_commit();
    head = (head + n) % kList;
    n_pending -= n;
    if (staged > 0) {
      cp_async_wait<1>();
      __syncthreads();                      // slot cur has landed for all threads
      evaluate(cur, staged);
      __syncthreads();                      // slot cur may be staged again
    }
    cur = slot;
    staged = n;
    n_eval += n;
  };

  const size_t tables = ((size_t)frame * ntx + tx) * rows;
  const int* lo_row = seg_lo + tables;
  const int* hi_row = seg_hi + tables;
  const int2* y_row = seg_y + tables;
  const int* base_row = row_base + (size_t)frame * rows;
  const int r0 = r_bounds[(frame * 2) * nty + ty];
  const int r1 = r_bounds[(frame * 2 + 1) * nty + ty];
  for (int r = r0; r <= r1; ++r) {
    const int lo = lo_row[r];
    const int hi = hi_row[r];
    if (hi < lo) continue;                  // empty interval (block-uniform)
    const int2 ext = y_row[r];
    if (ext.y < tile_y || ext.x >= tile_y + kTileH) continue;   // misses the tile row
    const int start = base_row[r] + lo;
    const int len = hi - lo + 1;
    for (int c0 = 0; c0 < len; c0 += kThreads) {
      const int i = c0 + (int)threadIdx.x;
      bool hit = false;
      if (i < len) {
        const int4 b = bbox[start + i];     // (x0, x1, y0, y1), pixels
        hit = b.x < tile_x + kTileW && b.y >= tile_x && b.z < tile_y + kTileH &&
              b.w >= tile_y;
      }
      const unsigned votes = __ballot_sync(0xffffffffu, hit);
      int* hits = warp_hits[pass & 1];      // two buffers: one barrier a pass
      if (lane == 0) hits[warp] = __popc(votes);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = hits[w];
        before += w < warp ? c : 0;
        total += c;
      }
      if (hit) {
        const int rank = __popc(votes & ((1u << lane) - 1u));
        pending[(head + n_pending + before + rank) % kList] = start + i;
      }
      n_pending += total;
      ++pass;
      while (n_pending >= kBatch) next_batch(kBatch);
    }
  }
  if (n_pending > 0) next_batch(n_pending);
  if (staged > 0) {
    cp_async_wait<0>();
    __syncthreads();
    evaluate(cur, staged);
  }
  if (evaluated != nullptr && threadIdx.x == 0) {
    evaluated[(size_t)frame * n_tiles + tile] = n_eval;
  }

  if (ix >= width) return;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int iy = tile_y + ly + k * kRowsPerPass;
    if (iy >= height) continue;
    const float rcp = vf::resolve_rcp(accw[k]);
    const float v0 = acc0[k] * rcp;
    const float v1 = acc1[k] * rcp;
    const float v2 = acc2[k] * rcp;
    const bool covered = best[k] >= 0;
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
}

template <bool kShade>
int launch(const float* records, int rec_stride, const int* ids, const int* bbox,
           const int* seg_lo, const int* seg_hi, const int* seg_y,
           const int* row_base, const int* r_bounds, const int* tile_order,
           int n_frames, int rows, int ntx, int nty, int width, int height,
           float* v0, float* v1, float* v2, uint8_t* mask, const float* lut_rgb,
           const float* par, int32_t* image, int* evaluated, void* stream) {
  if (n_frames > 0 && ntx * nty > 0) {
    const dim3 grid(ntx * nty, n_frames);
    seg_kernel<kShade><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        records, rec_stride, ids, reinterpret_cast<const int4*>(bbox), seg_lo,
        seg_hi, reinterpret_cast<const int2*>(seg_y), row_base, r_bounds,
        tile_order, rows, ntx, nty, width, height, v0, v1, v2, mask, lut_rgb,
        par, image, evaluated);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile in pixels; kernels.load() requires segments.TILE_H/TILE_W,
// which size the tables the kernels walk.
int vf_seg_tile_h() { return kTileH; }
int vf_seg_tile_w() { return kTileW; }

// records: (N, rec_stride) f32 compacted records of all frames, 16-byte
// aligned with rec_stride % 4 == 0; ids: (N,) int32 original triangle ids;
// bbox: (N, 4) int32 pixel bboxes (x0, x1, y0, y1), 16-byte aligned;
// seg_lo, seg_hi: (n_frames, ntx, rows) int32; seg_y: (n_frames, ntx,
// rows, 2) int32 interval y-extents; row_base: (n_frames, rows) int32,
// positions in the stacked records; r_bounds: (n_frames, 2, nty) int32;
// tile_order: (n_frames, nty * ntx) int32, a permutation of each frame's
// tiles ty * ntx + tx. Outputs are (n_frames, height, width); evaluated:
// null or (n_frames, nty * ntx) int32, the pairs each tile evaluated.
// Returns cudaGetLastError() after the launch.
int vf_seg_gbuffer(const float* records, int rec_stride, const int* ids,
                   const int* bbox, const int* seg_lo, const int* seg_hi,
                   const int* seg_y, const int* row_base, const int* r_bounds,
                   const int* tile_order, int n_frames, int rows, int ntx,
                   int nty, int width, int height, float* v0, float* v1,
                   float* v2, uint8_t* mask, int* evaluated, void* stream) {
  return launch<false>(records, rec_stride, ids, bbox, seg_lo, seg_hi, seg_y,
                       row_base, r_bounds, tile_order, n_frames, rows, ntx, nty,
                       width, height, v0, v1, v2, mask, nullptr, nullptr,
                       nullptr, evaluated, stream);
}

// lut_rgb: (256, 3) f32 linear; par: [hr2, exposure, l0, l1, l2] f32 on
// the device; image: (n_frames, height, width) int32 RGBA words.
int vf_seg_shade_shipped(const float* records, int rec_stride, const int* ids,
                         const int* bbox, const int* seg_lo, const int* seg_hi,
                         const int* seg_y, const int* row_base,
                         const int* r_bounds, const int* tile_order,
                         int n_frames, int rows, int ntx, int nty, int width,
                         int height, const float* lut_rgb, const float* par,
                         int32_t* image, int* evaluated, void* stream) {
  return launch<true>(records, rec_stride, ids, bbox, seg_lo, seg_hi, seg_y,
                      row_base, r_bounds, tile_order, n_frames, rows, ntx, nty,
                      width, height, nullptr, nullptr, nullptr, nullptr, lut_rgb,
                      par, image, evaluated, stream);
}

}  // extern "C"
