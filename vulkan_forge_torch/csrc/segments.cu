// Hand-written Hopper segment-walk kernels of vulkan_forge_torch (sm_90a):
// the tall-frame route (_raster/segments.py). The walk's set-up, which
// builds what the walk reads from a frame's post-VS fields, is a chain of
// its own further down (vf_seg_setup_*).
//
// The walk: two kernels, one body templated on the shader (kShade):
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

#include <algorithm>

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

// ---- The walk's set-up (vf_seg_setup_*) ----
//
// What the walk above reads, built from a frame's post-VS fields: the
// chain replaces the route's torch set-up (segments.setup_frame_plain:
// corner records for every triangle, segment_bin once per walk axis,
// compact_valid, ~244 ms of gathers, column stacks and scatters at the
// 8K poster's 25.9M triangles), which the JAX package leaves to the host
// and XLA (vulkan_forge/_raster/pipeline.py:705-723, segments.py:59-156);
// no pallas_call is replaced. Its outputs equal the plain version's byte
// for byte:
//
//   1. seg_bbox_kernel: one thread per triangle, original id order; its
//      corners through the index buffer or from the grid (kGrid), the
//      setup's bbox test (vf::setup_bbox) and the (T, 4) int32 bbox with
//      the invalid encoding (width, -1, height, -1). No record column.
//   2. Per walk axis (the row-major stream, and the column-major one where
//      row_size splits the mesh into rows; position j -> original id is
//      computed, as segments.column_major_perm lays it out):
//      seg_init_kernel fills the tables the atomics reduce into;
//      seg_count_kernel counts each 1024-position block's valid
//      triangles; seg_scan_kernel (one block) scans the counts into each
//      block's first compacted position, and the valid count N;
//      seg_bin_kernel ranks each valid triangle in its block (ballots),
//      writes each row's row_base, and reduces each (mesh row, tile
//      column) pair's interval [min, max compacted position] and y-extent
//      and each row's tile-row range, over the warp's lanes first
//      (__reduce_*_sync), then by integer atomicMin/atomicMax in the
//      tables; seg_tables_kernel turns positions into in-row ranks,
//      fills each tile row's active-row range (r_bounds) and adds each
//      interval's length into two difference arrays over tile rows;
//      seg_prefix_kernel sums them into counts_est and the per-tile
//      counts that order the tiles, and the estimate.
//   3. seg_compact_kernel: for the chosen walk, each valid triangle's
//      record built in registers (vf::setup_fields_core, 31 columns, then
//      zeros to kRecWidth), staged in shared memory and written out
//      contiguously, its id and its bbox at its compacted position: the
//      uncompacted records are never made.
//
// Integer atomics give the same tables whatever their order. What bounds
// it: bytes. The chain reads the fields and indices twice, writes the
// bbox once and reads it about three times, and writes the compacted
// records once: ~6.8 GB at the poster, ~2 ms at 3.35 TB/s, of which the
// inputs read once and the outputs written once are ~4.4 GB (1.32 ms).

constexpr int kSetupThreads = 256;
constexpr int kSetupWarps = kSetupThreads / 32;
constexpr int kScanItems = 4;                           // stream positions a thread
constexpr int kScanBlock = kSetupThreads * kScanItems;  // == kernels.SEG_SCAN_BLOCK
constexpr int kScanThreads = 1024, kScanPer = 8;        // seg_scan_kernel's block
constexpr int kRecWidth = 40;                           // == setup.REC_WIDTH
constexpr int kNoLo = 1 << 28, kNoHi = -1;              // segments._NO_LO, _NO_HI
constexpr int kNoTy = 1 << 20;                          // segments._NO_TY
constexpr int kNoPos = 0x7fffffff;                      // no position yet (atomicMin)
constexpr unsigned kFull = 0xffffffffu;

// One walk's stream of triangles: `length` positions, mesh rows of
// `row_size` positions. The column-major walk (kColumns) visits the
// cells_rows x cells_cols grid of two-triangle cells column by column.
struct Stream {
  int length, row_size, cells_rows, cells_cols;
};

template <bool kColumns>
__device__ __forceinline__ int stream_id(const Stream& s, int j) {
  if (!kColumns) return j;
  const int q = j >> 1;
  const int c = q / s.cells_rows;
  const int r = q - c * s.cells_rows;
  return (r * s.cells_cols + c) * 2 + (j & 1);
}

// The vertices of triangle `tri`, in record order: through the index
// buffer, or on build_grid_xyuv(n)'s grid (tri0 = [A, C, B], tri1 = [B,
// C, D] of cell (r, c), as setup.grid_corners orders them).
template <bool kGrid>
__device__ __forceinline__ void triangle_vertices(const int* __restrict__ idx, int n,
                                                  int tri, int v[3]) {
  if (kGrid) {
    const int cell = tri >> 1;
    const int row = cell / (n - 1);
    const int a = row * n + (cell - row * (n - 1));
    v[0] = (tri & 1) ? a + 1 : a;
    v[1] = a + n;
    v[2] = (tri & 1) ? a + n + 1 : a + 1;
  } else {
    const int* t = idx + 3 * (size_t)tri;
    v[0] = t[0];
    v[1] = t[1];
    v[2] = t[2];
  }
}

template <bool kGrid>
__global__ void __launch_bounds__(kSetupThreads)
seg_bbox_kernel(const float* __restrict__ f, int nv, const int* __restrict__ idx, int n,
                int n_tris, int width, int height, int4* __restrict__ bbox) {
  const long long t = (long long)blockIdx.x * kSetupThreads + threadIdx.x;
  if (t >= n_tris) return;
  int v[3];
  triangle_vertices<kGrid>(idx, n, (int)t, v);
  const vf::Box b = vf::setup_bbox(vf::position_terms(f, nv, v[0]),
                                   vf::position_terms(f, nv, v[1]),
                                   vf::position_terms(f, nv, v[2]), width, height);
  bbox[t] = b.valid ? make_int4(b.px0, b.px1, b.py0, b.py1) : make_int4(width, -1, height, -1);
}

__global__ void __launch_bounds__(kSetupThreads)
seg_init_kernel(long long cells, int rows, int nty, long long diff_len,
                int* __restrict__ seg_lo, int* __restrict__ seg_hi, int2* __restrict__ seg_y,
                int2* __restrict__ row_ty, int* __restrict__ r_bounds,
                int* __restrict__ diffs) {
  const long long n = max(max(cells, 2 * diff_len), (long long)max(rows, nty));
  for (long long i = (long long)blockIdx.x * kSetupThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kSetupThreads) {
    if (i < cells) {
      seg_lo[i] = kNoPos;
      seg_hi[i] = kNoHi;
      seg_y[i] = make_int2(kNoLo, kNoHi);
    }
    if (i < rows) row_ty[i] = make_int2(kNoTy, -kNoTy);
    if (i < nty) {
      r_bounds[i] = rows;
      r_bounds[nty + i] = -1;
    }
    if (i < 2 * diff_len) diffs[i] = 0;
  }
}

// Whether stream position j (< length) holds a valid triangle, and its bbox.
template <bool kColumns>
__device__ __forceinline__ bool load_valid(const int4* __restrict__ bbox, const Stream& s,
                                           long long j, int4& b) {
  if (j >= s.length) return false;
  b = bbox[stream_id<kColumns>(s, (int)j)];
  return b.y >= b.x;
}

template <bool kColumns>
__global__ void __launch_bounds__(kSetupThreads)
seg_count_kernel(const int4* __restrict__ bbox, Stream s, int* __restrict__ block_count) {
  __shared__ int warp_count[kSetupWarps];
  const long long base = (long long)blockIdx.x * kScanBlock + threadIdx.x;
  int c = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    int4 b;
    c += load_valid<kColumns>(bbox, s, base + i * kSetupThreads, b);
  }
  c = __reduce_add_sync(kFull, c);
  if (threadIdx.x % 32 == 0) warp_count[threadIdx.x / 32] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kSetupWarps; ++w) total += warp_count[w];
    block_count[blockIdx.x] = total;
  }
}

// Exclusive scan of count[0, n) into offset[0, n], offset[n] and *total
// the sum, by one block.
__global__ void __launch_bounds__(kScanThreads)
seg_scan_kernel(const int* __restrict__ count, int n, int* __restrict__ offset,
                long long* __restrict__ total) {
  __shared__ int warp_sum[kScanThreads / 32];
  const int lane = (int)(threadIdx.x % 32), warp = (int)(threadIdx.x / 32);
  int carry = 0;
  for (int c0 = 0; c0 < n; c0 += kScanThreads * kScanPer) {
    const int first = c0 + (int)threadIdx.x * kScanPer;
    int v[kScanPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      v[k] = first + k < n ? count[first + k] : 0;
      sum += v[k];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int up = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w += up;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    int run = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      if (first + k < n) offset[first + k] = run;
      run += v[k];
    }
    carry += warp_sum[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    offset[n] = carry;
    *total = carry;
  }
}

// Each of a thread's kScanItems positions' count of valid positions before
// it in its block (positions base + i * kSetupThreads + threadIdx.x), and
// where each item's valid positions start (start[kScanItems]: the block's
// count).
__device__ __forceinline__ void block_ranks(const bool (&valid)[kScanItems],
                                            int (&rank)[kScanItems],
                                            int (&start)[kScanItems + 1], int* s_counts) {
  const int lane = (int)(threadIdx.x % 32), warp = (int)(threadIdx.x / 32);
  unsigned votes[kScanItems];
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    votes[i] = __ballot_sync(kFull, valid[i]);
    if (lane == 0) s_counts[i * kSetupWarps + warp] = __popc(votes[i]);
  }
  __syncthreads();
  int run = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kSetupWarps; ++w) {
      const int c = s_counts[i * kSetupWarps + w];
      before += w < warp ? c : 0;
      total += c;
    }
    start[i] = run;
    rank[i] = run + before + __popc(votes[i] & ((1u << lane) - 1u));
    run += total;
  }
  start[kScanItems] = run;
}

// One warp's 32 consecutive positions into the tables: each distinct mesh
// row's tile-row range, then each distinct (row, tile column) pair's
// interval and y-extent, reduced over the lanes that share it and put in
// by lane 0. Rows are keyed from the warp's first row, row0 (a warp spans
// at most 32 rows; ntx < 2^19, so the keys fit an int).
__device__ __forceinline__ void warp_tables(bool valid, int pos, int row, int row0, int4 b,
                                            int ntx, int rows, int* __restrict__ seg_lo,
                                            int* __restrict__ seg_hi, int2* __restrict__ seg_y,
                                            int2* __restrict__ row_ty) {
  const int lane = (int)(threadIdx.x % 32);
  const int rk = row - row0;
  bool pend = valid;
  while (__any_sync(kFull, pend)) {
    const int key = __reduce_min_sync(kFull, pend ? rk : kNoPos);
    const bool sel = pend && rk == key;
    const int ty0 = __reduce_min_sync(kFull, sel ? b.z / kTileH : kNoPos);
    const int ty1 = __reduce_max_sync(kFull, sel ? b.w / kTileH : -kNoPos);
    if (lane == 0) {
      atomicMin(&row_ty[row0 + key].x, ty0);
      atomicMax(&row_ty[row0 + key].y, ty1);
    }
    pend = pend && !sel;
  }
  int cur = b.x / kTileW;
  const int last = b.y / kTileW;
  pend = valid;
  while (__any_sync(kFull, pend)) {
    const int mine = rk * ntx + cur;
    const int key = __reduce_min_sync(kFull, pend ? mine : kNoPos);
    const bool sel = pend && mine == key;
    const int lo = __reduce_min_sync(kFull, sel ? pos : kNoPos);
    const int hi = __reduce_max_sync(kFull, sel ? pos : kNoHi);
    const int y0 = __reduce_min_sync(kFull, sel ? b.z : kNoPos);
    const int y1 = __reduce_max_sync(kFull, sel ? b.w : kNoHi);
    if (lane == 0) {
      const int r = key / ntx;
      const size_t cell = (size_t)(key - r * ntx) * rows + row0 + r;
      atomicMin(seg_lo + cell, lo);
      atomicMax(seg_hi + cell, hi);
      atomicMin(&seg_y[cell].x, y0);
      atomicMax(&seg_y[cell].y, y1);
    }
    if (sel) {
      ++cur;
      pend = cur <= last;
    }
  }
}

template <bool kColumns>
__global__ void __launch_bounds__(kSetupThreads)
seg_bin_kernel(const int4* __restrict__ bbox, Stream s, int ntx, int rows,
               const int* __restrict__ offset, int* __restrict__ seg_lo,
               int* __restrict__ seg_hi, int2* __restrict__ seg_y, int2* __restrict__ row_ty,
               int* __restrict__ row_base) {
  __shared__ int s_counts[kScanItems * kSetupWarps];
  const long long base = (long long)blockIdx.x * kScanBlock;
  bool valid[kScanItems];
  int4 b[kScanItems];
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    b[i] = make_int4(0, -1, 0, -1);
    valid[i] = load_valid<kColumns>(bbox, s, base + i * kSetupThreads + threadIdx.x, b[i]);
  }
  int rank[kScanItems], start[kScanItems + 1];
  block_ranks(valid, rank, start, s_counts);
  const int first = offset[blockIdx.x];
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const long long warp_j = base + i * kSetupThreads + (threadIdx.x / 32) * 32;
    const long long j = warp_j + threadIdx.x % 32;
    const int pos = first + rank[i];
    const int row = (int)(j / s.row_size);
    if (j < s.length && j == (long long)row * s.row_size) row_base[row] = pos;
    warp_tables(valid[i], pos, row, (int)(warp_j / s.row_size), b[i], ntx, rows, seg_lo,
                seg_hi, seg_y, row_ty);
  }
}

__global__ void __launch_bounds__(kSetupThreads)
seg_tables_kernel(int ntx, int rows, int nty, const int* __restrict__ row_base,
                  const int2* __restrict__ row_ty, int* __restrict__ seg_lo,
                  int* __restrict__ seg_hi, const int2* __restrict__ seg_y,
                  int* __restrict__ diffs, int* __restrict__ r_bounds) {
  const long long cell = (long long)blockIdx.x * kSetupThreads + threadIdx.x;
  if (cell >= (long long)ntx * rows) return;
  const int tx = (int)(cell / rows);
  const int r = (int)(cell - (long long)tx * rows);
  const int2 act = row_ty[r];
  const int hi = seg_hi[cell];
  if (hi < 0) {
    seg_lo[cell] = kNoLo;
  } else {
    const int lo = seg_lo[cell] - row_base[r];
    const int len = hi - seg_lo[cell] + 1;
    seg_lo[cell] = lo;
    seg_hi[cell] = hi - row_base[r];
    // counts_est: the interval in every tile row its row is active in;
    // the scan: in every tile row of its y-extent.
    int* est = diffs + (size_t)tx * (nty + 1);
    int* scan = diffs + ((size_t)ntx + tx) * (nty + 1);
    const int2 ext = seg_y[cell];
    atomicAdd(est + act.x, len);
    atomicAdd(est + act.y + 1, -len);
    atomicAdd(scan + ext.x / kTileH, len);
    atomicAdd(scan + ext.y / kTileH + 1, -len);
  }
  // The row is active in tile rows act.x..act.y: its ntx cells share them.
  for (int ty = act.x + tx; ty <= act.y; ty += ntx) {
    atomicMin(r_bounds + ty, r);
    atomicMax(r_bounds + nty + ty, r);
  }
}

// Inclusive scan of v over the block; *total the block's sum.
__device__ __forceinline__ int block_scan(int v, int* warp_sum, int* total) {
  const int lane = (int)(threadIdx.x % 32), warp = (int)(threadIdx.x / 32);
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += up;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kSetupWarps; ++w) {
    before += w < warp ? warp_sum[w] : 0;
    all += warp_sum[w];
  }
  __syncthreads();
  *total = all;
  return before + v;
}

// One block per tile column: the difference arrays' prefix sums over tile
// rows into counts_est and scan ((nty, ntx) row-major), and the column's
// share of the estimate (the sum of counts_est) into *est.
__global__ void __launch_bounds__(kSetupThreads)
seg_prefix_kernel(int ntx, int nty, const int* __restrict__ diffs, int* __restrict__ counts_est,
                  int* __restrict__ scan, unsigned long long* __restrict__ est) {
  __shared__ int warp_sum[kSetupWarps];
  const int tx = (int)blockIdx.x;
  const int* de = diffs + (size_t)tx * (nty + 1);
  const int* ds = diffs + ((size_t)ntx + tx) * (nty + 1);
  int carry_e = 0, carry_s = 0;
  unsigned long long sum = 0;
  for (int t0 = 0; t0 < nty; t0 += kSetupThreads) {
    const int ty = t0 + (int)threadIdx.x;
    int total_e, total_s;
    const int e = carry_e + block_scan(ty < nty ? de[ty] : 0, warp_sum, &total_e);
    const int c = carry_s + block_scan(ty < nty ? ds[ty] : 0, warp_sum, &total_s);
    if (ty < nty) {
      counts_est[(size_t)ty * ntx + tx] = e;
      scan[(size_t)ty * ntx + tx] = c;
      sum += (unsigned long long)e;
    }
    carry_e += total_e;
    carry_s += total_s;
  }
  if (sum) atomicAdd(est, sum);
}

// An item's valid positions are consecutive in the stream and in the
// output, so their records are staged in shared memory (one 160-byte row a
// thread) and copied out 16 contiguous bytes a thread.
template <bool kColumns, bool kGrid>
__global__ void __launch_bounds__(kSetupThreads)
seg_compact_kernel(const float* __restrict__ f, int nv, const int* __restrict__ idx, int n,
                   const int4* __restrict__ bbox, Stream s, int width, int height,
                   const int* __restrict__ offset, float* __restrict__ records,
                   int* __restrict__ ids, int4* __restrict__ cbbox) {
  constexpr int kVecs = kRecWidth / 4;
  __shared__ int s_counts[kScanItems * kSetupWarps];
  __shared__ float4 stage[kSetupThreads * kVecs];
  const long long base = (long long)blockIdx.x * kScanBlock + threadIdx.x;
  bool valid[kScanItems];
  int4 b[kScanItems];
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    valid[i] = load_valid<kColumns>(bbox, s, base + i * kSetupThreads, b[i]);
  }
  int rank[kScanItems], start[kScanItems + 1];
  block_ranks(valid, rank, start, s_counts);
  const size_t first = (size_t)offset[blockIdx.x];
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int count = start[i + 1] - start[i];
    if (count == 0) continue;                   // block-uniform
    if (valid[i]) {
      const int t = stream_id<kColumns>(s, (int)(base + i * kSetupThreads));
      int v[3];
      triangle_vertices<kGrid>(idx, n, t, v);
      vf::Record r;
      vf::setup_fields_core(vf::load_corner(f, nv, v[0]), vf::load_corner(f, nv, v[1]),
                            vf::load_corner(f, nv, v[2]), width, height, r);
      float4* row = stage + (rank[i] - start[i]) * kVecs;
      const float* c = r.col;
#pragma unroll
      for (int q = 0; q < 7; ++q) {
        row[q] = make_float4(c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]);
      }
      row[7] = make_float4(c[28], c[29], c[30], 0.0f);
#pragma unroll
      for (int q = 8; q < kVecs; ++q) row[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      ids[first + rank[i]] = t;
      cbbox[first + rank[i]] = b[i];
    }
    __syncthreads();
    float4* out = reinterpret_cast<float4*>(records + (first + start[i]) * kRecWidth);
    for (int e = (int)threadIdx.x; e < count * kVecs; e += kSetupThreads) out[e] = stage[e];
    __syncthreads();
  }
}

int blocks_of(long long n, int per) { return (int)((n + per - 1) / per); }

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

// The set-up chain (see the note above seg_bbox_kernel): one kernel each,
// on `stream`; each returns cudaGetLastError() after its launch. The
// wrapper (kernels.seg_setup) calls them only with work to do.
int vf_seg_scan_block() { return kScanBlock; }
int vf_seg_rec_width() { return kRecWidth; }

// fields: (kFields, nv) f32 of one frame; indices: (n_tris, 3) int32, read
// when grid_n is 0, else the mesh is build_grid_xyuv(grid_n)'s; bbox:
// (n_tris, 4) int32 out.
int vf_seg_setup_bbox(const float* fields, int nv, const int* indices, int grid_n,
                      int n_tris, int width, int height, int* bbox, void* stream) {
  const int blocks = blocks_of(n_tris, kSetupThreads);
  int4* out = reinterpret_cast<int4*>(bbox);
  if (grid_n > 0) {
    seg_bbox_kernel<true><<<blocks, kSetupThreads, 0, (cudaStream_t)stream>>>(
        fields, nv, nullptr, grid_n, n_tris, width, height, out);
  } else {
    seg_bbox_kernel<false><<<blocks, kSetupThreads, 0, (cudaStream_t)stream>>>(
        fields, nv, indices, 0, n_tris, width, height, out);
  }
  return (int)cudaGetLastError();
}

// One walk's tables before the atomics: seg_lo, seg_hi (ntx, rows), seg_y
// (ntx, rows, 2), row_ty (rows, 2), r_bounds (2, nty), diffs (2, ntx,
// nty + 1).
int vf_seg_setup_init(int ntx, int rows, int nty, int* seg_lo, int* seg_hi, int* seg_y,
                      int* row_ty, int* r_bounds, int* diffs, void* stream) {
  const long long cells = (long long)ntx * rows, diff_len = (long long)ntx * (nty + 1);
  const long long n = std::max(std::max(cells, 2 * diff_len), (long long)std::max(rows, nty));
  const int blocks = (int)std::min<long long>(blocks_of(n, kSetupThreads), 4096);
  seg_init_kernel<<<blocks, kSetupThreads, 0, (cudaStream_t)stream>>>(
      cells, rows, nty, diff_len, seg_lo, seg_hi, reinterpret_cast<int2*>(seg_y),
      reinterpret_cast<int2*>(row_ty), r_bounds, diffs);
  return (int)cudaGetLastError();
}

// A walk's stream: `length` positions of rows of `row_size`; columns != 0:
// the column-major walk of the cells_rows x cells_cols cells. block_count:
// one int32 per kScanBlock positions.
int vf_seg_setup_count(const int* bbox, int length, int row_size, int cells_rows,
                       int cells_cols, int columns, int* block_count, void* stream) {
  const Stream s{length, row_size, cells_rows, cells_cols};
  const int blocks = blocks_of(length, kScanBlock);
  const int4* b = reinterpret_cast<const int4*>(bbox);
  if (columns) {
    seg_count_kernel<true><<<blocks, kSetupThreads, 0, (cudaStream_t)stream>>>(b, s, block_count);
  } else {
    seg_count_kernel<false><<<blocks, kSetupThreads, 0, (cudaStream_t)stream>>>(b, s, block_count);
  }
  return (int)cudaGetLastError();
}

// offset: (n + 1,) int32; total: one int64, the valid count.
int vf_seg_setup_scan(const int* block_count, int n, int* offset, long long* total,
                      void* stream) {
  seg_scan_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(block_count, n, offset, total);
  return (int)cudaGetLastError();
}

// row_base: (rows,) int32 out; the tables as vf_seg_setup_init lays them.
int vf_seg_setup_bin(const int* bbox, int length, int row_size, int cells_rows, int cells_cols,
                     int columns, int ntx, int rows, const int* offset, int* seg_lo,
                     int* seg_hi, int* seg_y, int* row_ty, int* row_base, void* stream) {
  const Stream s{length, row_size, cells_rows, cells_cols};
  const int blocks = blocks_of(length, kScanBlock);
  const int4* b = reinterpret_cast<const int4*>(bbox);
  int2* y = reinterpret_cast<int2*>(seg_y);
  int2* act = reinterpret_cast<int2*>(row_ty);
  if (columns) {
    seg_bin_kernel<true><<<blocks, kSetupThreads, 0, (cudaStream_t)stream>>>(
        b, s, ntx, rows, offset, seg_lo, seg_hi, y, act, row_base);
  } else {
    seg_bin_kernel<false><<<blocks, kSetupThreads, 0, (cudaStream_t)stream>>>(
        b, s, ntx, rows, offset, seg_lo, seg_hi, y, act, row_base);
  }
  return (int)cudaGetLastError();
}

int vf_seg_setup_tables(int ntx, int rows, int nty, const int* row_base, const int* row_ty,
                        int* seg_lo, int* seg_hi, const int* seg_y, int* diffs, int* r_bounds,
                        void* stream) {
  const int blocks = blocks_of((long long)ntx * rows, kSetupThreads);
  seg_tables_kernel<<<blocks, kSetupThreads, 0, (cudaStream_t)stream>>>(
      ntx, rows, nty, row_base, reinterpret_cast<const int2*>(row_ty), seg_lo, seg_hi,
      reinterpret_cast<const int2*>(seg_y), diffs, r_bounds);
  return (int)cudaGetLastError();
}

// counts_est, scan: (nty * ntx,) int32 out; est: one int64, added to.
int vf_seg_setup_prefix(int ntx, int nty, const int* diffs, int* counts_est, int* scan,
                        long long* est, void* stream) {
  seg_prefix_kernel<<<ntx, kSetupThreads, 0, (cudaStream_t)stream>>>(
      ntx, nty, diffs, counts_est, scan, reinterpret_cast<unsigned long long*>(est));
  return (int)cudaGetLastError();
}

// The chosen walk's compacted records (N, kRecWidth) f32, ids (N,) int32
// and bbox (N, 4) int32, at the positions vf_seg_setup_scan's offsets
// give; fields, indices and grid_n as vf_seg_setup_bbox takes them.
int vf_seg_setup_compact(const float* fields, int nv, const int* indices, int grid_n,
                         const int* bbox, int length, int row_size, int cells_rows,
                         int cells_cols, int columns, int width, int height, const int* offset,
                         float* records, int* ids, int* cbbox, void* stream) {
  const Stream s{length, row_size, cells_rows, cells_cols};
  const int blocks = blocks_of(length, kScanBlock);
  const int4* b = reinterpret_cast<const int4*>(bbox);
  int4* out = reinterpret_cast<int4*>(cbbox);
  const cudaStream_t st = (cudaStream_t)stream;
  if (columns && grid_n > 0) {
    seg_compact_kernel<true, true><<<blocks, kSetupThreads, 0, st>>>(
        fields, nv, nullptr, grid_n, b, s, width, height, offset, records, ids, out);
  } else if (columns) {
    seg_compact_kernel<true, false><<<blocks, kSetupThreads, 0, st>>>(
        fields, nv, indices, 0, b, s, width, height, offset, records, ids, out);
  } else if (grid_n > 0) {
    seg_compact_kernel<false, true><<<blocks, kSetupThreads, 0, st>>>(
        fields, nv, nullptr, grid_n, b, s, width, height, offset, records, ids, out);
  } else {
    seg_compact_kernel<false, false><<<blocks, kSetupThreads, 0, st>>>(
        fields, nv, indices, 0, b, s, width, height, offset, records, ids, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
