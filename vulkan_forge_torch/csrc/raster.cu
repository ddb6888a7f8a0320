// Hand-written Hopper raster kernels of vulkan_forge_torch (sm_90a).
//
// Four kernels, one raster body, templated on the shader (kShade) and the
// fill rule (kHw):
//
//   vf_raster_gbuffer        replaces pallas_backend._kernel (K1, the list
//                            kernel) and strips._strip_kernel's inclusive
//                            rule (K7). Output: the perspective-divided
//                            varyings of the winning triangle and coverage.
//   vf_raster_shade_shipped  replaces packed._packed_kernel_resident_fused
//                            (K4) with the shipped fragment shader
//                            fragment.terrain_fs_tile (K2) fused into its
//                            epilogue. Output: one u32 RGBA word per pixel.
//   vf_raster_gbuffer_hw     the hardware fill rule (VF_FILL_RULE=hw) of K1
//                            (pallas_backend.py:78-80) and of K7
//                            (strips.py:228, :261-265): the g-buffer over
//                            8.8-snapped records whose edges compare
//                            against the per-edge top-left thresholds at
//                            columns 31..33 instead of 0.
//   vf_raster_shade_shipped_hw  the same with the shipped shader fused: what
//                            K7's hw mode followed by fragment.terrain_fs
//                            computes for a shipped frame (pipeline.py:185-199).
//
// What the TPU kernels compute: for each pixel, the highest-id triangle
// whose three edge functions and near/w/far clip functionals cover it
// (painter's order, no depth buffer), then the perspective divide of
// tiles.py:97 and, for the shaded kernels, the shipped shader.
//
// The design. One thread block owns one (frame, 16x16 tile). Each binned
// pair (ascending triangle id, from setup.bin_tiles) comes with its box
// (Binning.boxes: its bbox clipped to the tile, read contiguously beside
// rows), which holds the only pixels the pair can reach. Two walks:
//
//   light   a tile of at most kLightPairs pairs (the edges of a terrain, the
//           triangle): each thread takes, in order, the pairs whose box
//           holds its pixel and evaluates them from device memory (16-byte
//           loads); the last cover is the winner. No staging, no scan.
//   chunked a heavier tile walks its list in chunks of 256 pairs, the next
//           chunk's rows and boxes loaded while the current one is walked.
//           A chunk stages its pairs' cover columns in shared memory (the
//           varying numerators 12..20 are never read) and covers them in
//           two ways, split by one block scan that puts the small pairs'
//           slots first and the big ones' after, each in list order:
//     small a pair of fewer than kBigPixels box pixels: its (pair, box
//           pixel) items are spread evenly over the threads -- per-pair
//           counts, the scan, items strided over the block, each finding
//           its pair by a step or a short search in the scan -- so a chunk
//           of 1-pixel pairs takes about one item per thread. A covered
//           item does atomicMax(&win[pixel], row + 1) in shared memory;
//     big   a larger pair is walked by the whole block, each thread testing
//           its own pixel where the box holds it and keeping the last
//           cover in a register, as the former body did for every pair.
//           Coverage is vf::cover_pixel, eval_pixel's test alone. Rows
//           ascend with the id within a tile, so the largest covering row
//           is the painter's winner: an integer maximum, the same in any
//           order (the one atomic the port allows, see ROADMAP.md), so
//           the bytes stay deterministic. Then each thread
//           evaluates its pixel's winner alone (vf::eval_pixel, the
//           operations of the plain version's last cover).
//
// Each thread then divides and writes the g-buffer or shades. Pixels past
// the frame's edge are never walked (the bboxes are clamped to the frame)
// nor written.
//
// The former body evaluated every binned record at all 256 pixels of its
// tile; the binned triangles of a terrain frame cover about one pixel per
// pair, so it made ~256x the evaluations this walk makes (PERF.md).
//
// What bounds it on an H100: the binned pairs' rows, boxes and cover
// columns (22 floats, 25 under hw) and, for a frame of small triangles, the
// latency of each chunk's dependent steps (the scan, the staged columns,
// the items: four barriers per chunk); for big pairs the cover test's ~38
// f32 ops per pixel; for a light tile the latency of its dependent loads
// (offsets, the pair, its record). `evaluated` (optional) receives each
// tile's tested (pair, pixel) items, which tiles.tile_work mirrors.
//
// Numerics: built with -fmad=false (no contraction) and without fast math,
// so every +, -, *, / and sqrtf rounds once (correctly rounded), as the
// plain PyTorch version (_raster/tiles.py, _raster/fragment.py) rounds its
// eager ops on the card, where torch's sqrt, 1/sqrt, sin, cos and pow
// also gave these kernels' bits on every input of python -m
// vulkan_forge_torch.lab.fs_ops. On the CPU they do not: torch's
// vectorised sqrt is not correctly rounded (1 ulp off on 210 of that
// probe's 32,768 inputs), and its sin, cos and pow differ from CUDA's by
// an ulp on some inputs, so a CPU image may part from the card's by 1 u8
// where such an ulp crosses a rounding step. The per-pixel evaluation and
// the shader are in raster_common.cuh, shared with vtx.cu, in the op
// order of tiles.py:79-97 and fragment.py:44-69.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

constexpr int kTile = 16;                  // == setup.TILE (vf_tile)
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;           // pairs staged per pass
constexpr int kEdgeCols = 12;              // columns 0..11
constexpr int kWCol = 21;                  // then 21..30 (21..33 under hw)
// A pair whose box holds at least this many pixels is walked by the whole
// block, one pixel per thread; a smaller one as items spread over it.
constexpr int kBigPixels = 128;
// A tile of at most this many pairs takes the light walk.
constexpr int kLightPairs = 32;

// Whether a packed box (x0 | x1 << 4 | y0 << 8 | y1 << 12) holds (x, y).
__device__ __forceinline__ bool box_holds(uint32_t b, int x, int y) {
  return x >= (int)(b & 15) && x <= (int)((b >> 4) & 15) &&
         y >= (int)((b >> 8) & 15) && y <= (int)((b >> 12) & 15);
}

// Inclusive scan of one int per lane over a warp.
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// Exclusive scan of one int per thread over the block (two barriers);
// `warp_sums` holds kWarps ints; *total receives the block's sum.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x = warp_scan(v);
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int t = warp_scan(lane < kWarps ? warp_sums[lane] : 0);
    if (lane < kWarps) warp_sums[lane] = t;
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  return x - v + (warp ? warp_sums[warp - 1] : 0);
}

// The staged cover columns of one pair (compact: 0..11, then 21..), read
// as float4s into registers.
template <int kVec>
__device__ __forceinline__ void load_cols(const float* s, float* r) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int q = 0; q < kVec; ++q) {
    const float4 v = s4[q];
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
}

// One record's live columns (0..30, 0..33 under hw) read from device
// memory as float4s (rows of 40 floats, 16-byte aligned) and evaluated at
// (px, py): a warp's 34 scalar loads of one record become 9.
template <bool kHw>
__device__ __forceinline__ vf::PixelEval eval_record(const float* g, float px,
                                                     float py) {
  constexpr int kVec = kHw ? 9 : 8;
  float r[kVec * 4];
  const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll
  for (int q = 0; q < kVec; ++q) {
    const float4 v = __ldg(g4 + q);
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
  return vf::eval_pixel<kHw>(r, px, py);
}

template <bool kShade, bool kHw>
__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ records, int rec_stride,
              const int* __restrict__ rows, const int* __restrict__ boxes,
              const int* __restrict__ offsets, int ntx, int nty, int width,
              int height, float* __restrict__ out0, float* __restrict__ out1,
              float* __restrict__ out2, uint8_t* __restrict__ mask,
              const float* __restrict__ lut_rgb,
              const float* __restrict__ par, int32_t* __restrict__ image,
              int32_t* __restrict__ evaluated) {
  // Cover columns of each staged pair: 0..11, then 21..30 (21..33 under
  // hw), in rows of 28 floats: 16-byte loads, and the rows of 8
  // neighbouring slots in distinct banks.
  constexpr int kCols = kEdgeCols + (kHw ? 13 : 10);
  constexpr int kVec = (kCols + 3) / 4;
  constexpr int kStride = 28;
  static_assert(kVec * 4 <= kStride, "cover columns exceed the staged row");
  __shared__ __align__(16) float srec[kChunk * kStride];
  __shared__ int spre[kChunk + 1];    // small pairs: exclusive scan of items
  __shared__ uint32_t sbox[kChunk];   // small: x0 | y0<<4 | w<<8 | m<<16; big: the box
  __shared__ int srow[kChunk];
  __shared__ int swarp[kWarps];
  __shared__ int stests;
  __shared__ int swin[kThreads];      // small pairs' winning row + 1, 0: none
  __shared__ float slut[kShade ? 256 * 3 : 1];

  const int tile = blockIdx.x;        // frame * (ntx*nty) + tile
  const int nt = ntx * nty;
  const int frame = tile / nt;
  const int t = tile - frame * nt;
  const int ty = t / ntx;
  const int tx = t - ty * ntx;
  const int ox = tx * kTile;
  const int oy = ty * kTile;
  // This thread's pixel, which it owns in the light walk, the big-pair walk
  // and the resolve.
  const int plx = (int)(threadIdx.x % kTile);
  const int ply = (int)(threadIdx.x / kTile);
  const float ppx = (float)(ox + plx) + 0.5f;
  const float ppy = (float)(oy + ply) + 0.5f;

  if (kShade) {
    for (int e = threadIdx.x; e < 256 * 3; e += kThreads) slut[e] = lut_rgb[e];
  }
  if (threadIdx.x == 0) stests = 0;

  const int begin = offsets[tile];
  const int end = offsets[tile + 1];
  const bool light = end - begin <= kLightPairs;
  if (!light) swin[threadIdx.x] = 0;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, accw = 1.0f;
  bool covered = false;
  int best = 0;                       // big pairs' winning row + 1 here
  int tests = 0;                      // (pair, pixel) items this thread tested
  if (light) {
    // The last cover is the winner; its evaluation is the resolve's.
    for (int p = begin; p < end; ++p) {
      const uint32_t bx = boxes[p];
      const int row = rows[p];
      if (box_holds(bx, plx, ply)) {
        ++tests;
        const vf::PixelEval e =
            eval_record<kHw>(records + (size_t)row * rec_stride, ppx, ppy);
        if (e.cov) {
          acc0 = e.a0;
          acc1 = e.a1;
          acc2 = e.a2;
          accw = e.aw;
          covered = true;
        }
      }
    }
  }
  int nrow = 0, nbox = 0;             // the next chunk's pair of this thread
  if (!light && begin + (int)threadIdx.x < end) {
    nrow = rows[begin + threadIdx.x];
    nbox = boxes[begin + threadIdx.x];
  }
  for (int base = begin; !light && base < end; base += kChunk) {
    const int n = min(kChunk, end - base);
    const int row = nrow, b = nbox;
    if (base + kChunk + (int)threadIdx.x < end) {   // in flight during this chunk
      nrow = rows[base + kChunk + threadIdx.x];
      nbox = boxes[base + kChunk + threadIdx.x];
    }
    if (base != begin) __syncthreads();   // previous chunk consumed
    // Items of a small pair in the low 16 bits (< 256 * kBigPixels), one
    // per big pair above them: one scan orders both. The chunk's slots then
    // hold the small pairs first, then the big ones, each in list order.
    const int x0 = b & 15, y0 = (b >> 8) & 15;
    const int w = ((b >> 4) & 15) - x0 + 1;
    const int area = w * (((b >> 12) & 15) - y0 + 1);
    const bool live = (int)threadIdx.x < n;
    const bool big = live && area >= kBigPixels;
    const int count = big ? 1 << 16 : (live ? area : 0);
    int all;
    const int pre = block_scan(count, swarp, &all);
    const int nsmall = n - (all >> 16);
    const int total = all & 0xffff;
    if (live) {
      const int slot = big ? nsmall + (pre >> 16) : (int)threadIdx.x - (pre >> 16);
      srow[slot] = row;
      // m = ceil(2^15 / w): (k * m) >> 15 == k / w for every k < 256.
      sbox[slot] = big ? (uint32_t)b
                       : (uint32_t)(x0 | y0 << 4 | w << 8) |
                             (uint32_t)((32768 + w - 1) / w) << 16;
      if (!big) spre[slot] = pre & 0xffff;
    }
    if (threadIdx.x == 0) spre[nsmall] = total;
    __syncthreads();
    for (int e = threadIdx.x; e < n * kCols; e += kThreads) {
      const int i = e / kCols;
      const int c = e - i * kCols;
      srec[i * kStride + c] =
          records[(size_t)srow[i] * rec_stride + c + (c < kEdgeCols ? 0 : kWCol - kEdgeCols)];
    }
    __syncthreads();
    // Small pairs: their (pair, box pixel) items strided over the block.
    int i = 0;
    for (int j = threadIdx.x; j < total; j += kThreads) {
      if (spre[i + 1] <= j) {         // past small pair i: step, else search
        ++i;
        if (spre[i + 1] <= j) {
          int lo = i + 1, hi = nsmall - 1;    // spre[nsmall] = total > j
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (spre[mid] <= j) lo = mid; else hi = mid - 1;
          }
          i = lo;
        }
      }
      const uint32_t bx = sbox[i];
      const int k = j - spre[i];
      const int bw = (bx >> 8) & 31;
      const int ly = (k * (int)(bx >> 16)) >> 15;
      const int lx = (int)(bx & 15) + k - ly * bw;
      const int y = (int)((bx >> 4) & 15) + ly;
      float r[kVec * 4];
      load_cols<kVec>(srec + i * kStride, r);
      ++tests;
      if (vf::cover_pixel<kHw>(r, r + kEdgeCols, (float)(ox + lx) + 0.5f,
                               (float)(oy + y) + 0.5f)) {
        atomicMax(&swin[y * kTile + lx], srow[i] + 1);
      }
    }
    // Big pairs, in order: each thread tests its own pixel where the box
    // holds it, so the last cover is the largest row.
    for (int k = nsmall; k < n; ++k) {
      if (box_holds(sbox[k], plx, ply)) {
        float r[kVec * 4];
        load_cols<kVec>(srec + k * kStride, r);
        ++tests;
        if (vf::cover_pixel<kHw>(r, r + kEdgeCols, ppx, ppy)) best = srow[k] + 1;
      }
    }
  }
  if (kShade || !light) __syncthreads();   // winners (and slut) ready
  if (evaluated != nullptr) {
    __syncthreads();
    atomicAdd(&stests, tests);
    __syncthreads();
    if (threadIdx.x == 0) evaluated[tile] = stests;
  }

  const int ix = ox + plx;
  const int iy = oy + ply;
  if (ix >= width || iy >= height) return;
  const int win = light ? 0 : max(swin[threadIdx.x], best);
  if (win > 0) {                      // the chunked walk's winner
    const vf::PixelEval e =
        eval_record<kHw>(records + (size_t)(win - 1) * rec_stride, ppx, ppy);
    acc0 = e.a0;
    acc1 = e.a1;
    acc2 = e.a2;
    accw = e.aw;
    covered = true;
  }
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

template <bool kShade, bool kHw>
int launch(const float* records, int rec_stride, const int* rows,
           const int* boxes, const int* offsets, int n_tiles, int ntx, int nty,
           int width, int height, float* v0, float* v1, float* v2,
           uint8_t* mask, const float* lut_rgb, const float* par,
           int32_t* image, int32_t* evaluated, void* stream) {
  if (n_tiles > 0) {
    raster_kernel<kShade, kHw><<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        records, rec_stride, rows, boxes, offsets, ntx, nty, width, height,
        v0, v1, v2, mask, lut_rgb, par, image, evaluated);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile edge in pixels; kernels.load() requires it to equal setup.TILE,
// which sizes the binning that the kernels walk.
int vf_tile() { return kTile; }

// records: (R, rec_stride) f32; rows, boxes: the binned pairs' record rows
// and tile-local boxes (setup.Binning); offsets: (n_tiles + 1) exclusive
// scan, n_tiles = frames * ntx * nty. Outputs are (frames, height, width);
// evaluated (n_tiles) int32 or null receives each tile's (pair, pixel)
// items. Returns cudaGetLastError() after the launch.
int vf_raster_gbuffer(const float* records, int rec_stride, const int* rows,
                      const int* boxes, const int* offsets, int n_tiles,
                      int ntx, int nty, int width, int height, float* v0,
                      float* v1, float* v2, uint8_t* mask, int32_t* evaluated,
                      void* stream) {
  return launch<false, false>(records, rec_stride, rows, boxes, offsets,
                              n_tiles, ntx, nty, width, height, v0, v1, v2,
                              mask, nullptr, nullptr, nullptr, evaluated,
                              stream);
}

// The same over records set up under the hw fill rule (34 live columns).
int vf_raster_gbuffer_hw(const float* records, int rec_stride,
                         const int* rows, const int* boxes,
                         const int* offsets, int n_tiles, int ntx, int nty,
                         int width, int height, float* v0, float* v1,
                         float* v2, uint8_t* mask, int32_t* evaluated,
                         void* stream) {
  return launch<false, true>(records, rec_stride, rows, boxes, offsets,
                             n_tiles, ntx, nty, width, height, v0, v1, v2,
                             mask, nullptr, nullptr, nullptr, evaluated,
                             stream);
}

// lut_rgb: (256, 3) f32 linear; par: [hr2, exposure, l0, l1, l2] f32 on
// the device; image: (frames, height, width) int32 RGBA words.
int vf_raster_shade_shipped(const float* records, int rec_stride,
                            const int* rows, const int* boxes,
                            const int* offsets, int n_tiles, int ntx,
                            int nty, int width, int height,
                            const float* lut_rgb, const float* par,
                            int32_t* image, int32_t* evaluated,
                            void* stream) {
  return launch<true, false>(records, rec_stride, rows, boxes, offsets,
                             n_tiles, ntx, nty, width, height, nullptr,
                             nullptr, nullptr, nullptr, lut_rgb, par, image,
                             evaluated, stream);
}

// The same over records set up under the hw fill rule (34 live columns).
int vf_raster_shade_shipped_hw(const float* records, int rec_stride,
                               const int* rows, const int* boxes,
                               const int* offsets, int n_tiles, int ntx,
                               int nty, int width, int height,
                               const float* lut_rgb, const float* par,
                               int32_t* image, int32_t* evaluated,
                               void* stream) {
  return launch<true, true>(records, rec_stride, rows, boxes, offsets,
                            n_tiles, ntx, nty, width, height, nullptr,
                            nullptr, nullptr, nullptr, lut_rgb, par, image,
                            evaluated, stream);
}

}  // extern "C"
