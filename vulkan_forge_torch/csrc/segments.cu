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
// seg_hi]). Here one thread block owns one (frame, tile) and its 1,024
// pixels, 256 threads with 4 pixels each (one column, rows ly, ly+2, ly+4,
// ly+6). The block stages each interval's records (31 live columns) and
// ids through shared memory in chunks; every thread evaluates every staged
// record at its pixels (vf::eval_pixel, the fused multiply-adds of every
// route) and keeps (best id, a0, a1, a2, aw) per pixel in registers,
// replacing them where the record covers the pixel and its id is larger.
// The maximum id wins whatever the walk order, so a column-major
// (permuted) stream paints the same pixels. A block owns its pixels: no
// atomics. Empty rows are skipped without a barrier.
//
// Ids are int32 beside the records, not record columns 32..34 as in the
// reference (segments.py:53-55): the port's columns 31..33 hold the hw
// rule's edge thresholds, and an int32 id is exact for any T < 2^31, so
// K8's (id >> 12, id & 4095) split compare for T >= 2^24 has no
// counterpart. K8's 8-row DMA alignment and double buffering are TPU
// layout and are not carried over.
//
// What bounds it on an H100: the per-(pixel, record) ALU chain (~52 f32
// ops) over every record of every walked interval -- the intervals are
// conservative (a row's whole interval for a tile column, whichever tile
// rows its triangles touch) -- and the two barriers around each staged
// chunk. Record bytes are read once per walking tile into shared memory,
// where all threads read the same word (a broadcast).
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
constexpr int kRowsPerPass = kThreads / kTileW;   // 2
constexpr int kPix = kTileH / kRowsPerPass;       // 4 pixels per thread
constexpr int kChunk = 64;                 // records staged per pass
constexpr int kCols = 31;                  // live record columns (inclusive rule)

template <bool kShade>
__global__ void __launch_bounds__(kThreads)
seg_kernel(const float* __restrict__ records, int rec_stride,
           const int* __restrict__ ids, const int* __restrict__ seg_lo,
           const int* __restrict__ seg_hi, const int* __restrict__ row_base,
           const int* __restrict__ r_bounds, int rows, int ntx, int nty,
           int width, int height, float* __restrict__ out0,
           float* __restrict__ out1, float* __restrict__ out2,
           uint8_t* __restrict__ mask, const float* __restrict__ lut_rgb,
           const float* __restrict__ par, int32_t* __restrict__ image) {
  __shared__ float srec[kChunk][kCols + 1];
  __shared__ int sid[kChunk];
  __shared__ float slut[kShade ? 256 * 3 : 1];

  const int frame = blockIdx.y;
  const int ty = blockIdx.x / ntx;
  const int tx = blockIdx.x - ty * ntx;
  const int ix = tx * kTileW + (int)(threadIdx.x % kTileW);
  const int ly = (int)(threadIdx.x / kTileW);
  const float px = (float)ix + 0.5f;
  float py[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    py[k] = (float)(ty * kTileH + ly + k * kRowsPerPass) + 0.5f;
  }

  if (kShade) {
    for (int e = threadIdx.x; e < 256 * 3; e += kThreads) slut[e] = lut_rgb[e];
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

  const size_t tables = ((size_t)frame * ntx + tx) * rows;
  const int* lo_row = seg_lo + tables;
  const int* hi_row = seg_hi + tables;
  const int* base_row = row_base + (size_t)frame * rows;
  const int r0 = r_bounds[(frame * 2) * nty + ty];
  const int r1 = r_bounds[(frame * 2 + 1) * nty + ty];
  for (int r = r0; r <= r1; ++r) {
    const int lo = lo_row[r];
    const int hi = hi_row[r];
    if (hi < lo) continue;                  // empty interval (block-uniform)
    const int start = base_row[r] + lo;
    const int len = hi - lo + 1;
    for (int c0 = 0; c0 < len; c0 += kChunk) {
      const int n = min(kChunk, len - c0);
      const size_t first = (size_t)start + c0;
      __syncthreads();                      // previous chunk consumed
      for (int e = threadIdx.x; e < n * kCols; e += kThreads) {
        const int i = e / kCols;
        const int c = e - i * kCols;
        srec[i][c] = records[(first + i) * rec_stride + c];
      }
      if ((int)threadIdx.x < n) sid[threadIdx.x] = ids[first + threadIdx.x];
      __syncthreads();
      for (int i = 0; i < n; ++i) {
        const int id = sid[i];
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const vf::PixelEval e = vf::eval_pixel(srec[i], px, py[k]);
          if (e.cov && id > best[k]) {
            best[k] = id;
            acc0[k] = e.a0;
            acc1[k] = e.a1;
            acc2[k] = e.a2;
            accw[k] = e.aw;
          }
        }
      }
    }
  }
  if (kShade) __syncthreads();              // slut ready even without a chunk

  if (ix >= width) return;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int iy = ty * kTileH + ly + k * kRowsPerPass;
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
int launch(const float* records, int rec_stride, const int* ids,
           const int* seg_lo, const int* seg_hi, const int* row_base,
           const int* r_bounds, int n_frames, int rows, int ntx, int nty,
           int width, int height, float* v0, float* v1, float* v2,
           uint8_t* mask, const float* lut_rgb, const float* par,
           int32_t* image, void* stream) {
  if (n_frames > 0 && ntx * nty > 0) {
    const dim3 grid(ntx * nty, n_frames);
    seg_kernel<kShade><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        records, rec_stride, ids, seg_lo, seg_hi, row_base, r_bounds, rows,
        ntx, nty, width, height, v0, v1, v2, mask, lut_rgb, par, image);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile in pixels; kernels.load() requires segments.TILE_H/TILE_W,
// which size the tables the kernels walk.
int vf_seg_tile_h() { return kTileH; }
int vf_seg_tile_w() { return kTileW; }

// records: (N, rec_stride) f32 compacted records of all frames; ids: (N,)
// int32 original triangle ids; seg_lo, seg_hi: (n_frames, ntx, rows) int32;
// row_base: (n_frames, rows) int32, positions in the stacked records;
// r_bounds: (n_frames, 2, nty) int32. Outputs are (n_frames, height,
// width). Returns cudaGetLastError() after the launch.
int vf_seg_gbuffer(const float* records, int rec_stride, const int* ids,
                   const int* seg_lo, const int* seg_hi, const int* row_base,
                   const int* r_bounds, int n_frames, int rows, int ntx,
                   int nty, int width, int height, float* v0, float* v1,
                   float* v2, uint8_t* mask, void* stream) {
  return launch<false>(records, rec_stride, ids, seg_lo, seg_hi, row_base,
                       r_bounds, n_frames, rows, ntx, nty, width, height, v0,
                       v1, v2, mask, nullptr, nullptr, nullptr, stream);
}

// lut_rgb: (256, 3) f32 linear; par: [hr2, exposure, l0, l1, l2] f32 on
// the device; image: (n_frames, height, width) int32 RGBA words.
int vf_seg_shade_shipped(const float* records, int rec_stride, const int* ids,
                         const int* seg_lo, const int* seg_hi,
                         const int* row_base, const int* r_bounds,
                         int n_frames, int rows, int ntx, int nty, int width,
                         int height, const float* lut_rgb, const float* par,
                         int32_t* image, void* stream) {
  return launch<true>(records, rec_stride, ids, seg_lo, seg_hi, row_base,
                      r_bounds, n_frames, rows, ntx, nty, width, height,
                      nullptr, nullptr, nullptr, nullptr, lut_rgb, par, image,
                      stream);
}

}  // extern "C"
