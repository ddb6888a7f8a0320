// Hand-written Hopper kernels of vulkan_forge_torch (sm_90a): the record
// route's set-up and binning (vf_rec_*), which build what the record
// kernels of raster.cu read from a frame batch's post-VS fields.
//
// The chain replaces the route's torch set-up (setup.triangle_setup and
// setup.bin_tiles: every triangle's 40 record columns stacked into a
// (T+1, 40) tensor a frame, then the (tile, triangle) pairs listed, sorted
// by tile and counted; ~123 ms of torch ops at the SRTM tile's 25.9M
// triangles), which the JAX package leaves to XLA
// (vulkan_forge/_raster/setup.py); no pallas_call is replaced. Its outputs
// equal the plain version's (setup.rec_setup_plain) byte for byte: the
// records of the binned triangles alone, in ascending (frame, id) order,
// and the tiles' lists of rows into them (setup.Binning):
//
//   1. rec_count_kernel: one thread per (frame, triangle), blocks of
//      kBlock triangles of one frame. The corners through the index buffer
//      (int32 or int64, read where it lies; an index outside [0, nv)
//      marks the block and is never read through), under kHw snapped to
//      the 8.8 grid (setup.snap_hw), the setup's bbox test (vf::setup_bbox)
//      and a bit a triangle that it is binned; the block's binned
//      triangles and (tile, triangle) pairs.
//   2. rec_totals_kernel (one block): exclusive scans of the blocks'
//      counts into each block's first record and first pair, the totals
//      and whether a block met a bad index, which the wrapper reads back
//      in one copy to size the outputs.
//   3. rec_emit_kernel: per kGroup count blocks, their binned triangles
//      listed from the bits, then a thread each: the record built in
//      registers (vf::setup_fields_core; under kHw the edge thresholds of
//      setup.setup_fields_core at columns 31..33) and written at its rank,
//      and its pairs' keys
//      (frame * tiles + tile), rows and boxes (Binning.boxes), in
//      triangle order.
//   4. A stable least-significant-digit radix sort of the pairs by key,
//      kDigitBits a pass: rec_sort_count_kernel counts each block's
//      digits, rec_sort_scan_kernel (a block a digit) scans each digit's
//      counts across the blocks, and rec_sort_scatter_kernel puts each
//      pair after the smaller digits' pairs and its digit's pairs in
//      earlier blocks, at its rank among the earlier pairs of its block
//      with that digit (__match_any_sync within a warp, the earlier warps'
//      counts), so each tile keeps its pairs in ascending row order, as
//      bin_tiles' stable sort does.
//   5. rec_offsets_kernel: each tile's first pair, from the sorted keys.
//
// Shared-memory atomics only count, and nothing depends on their order.
// What bounds it: bytes -- the index buffer and the four position planes
// gathered once, the binned triangles' corners once more, the records and
// the pairs written once, and the pairs moved once a sort pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                        // triangles a thread
constexpr int kBlock = kThreads * kItems;        // == kernels.REC_BLOCK
constexpr int kWords = kBlock / 32;              // binned bits a block
constexpr int kGroup = kThreads / kWords;        // count blocks an emit block takes
constexpr int kScanThreads = 1024, kScanPer = 8; // the one-block scans
constexpr int kRecWidth = 40;                    // == setup.REC_WIDTH
constexpr int kTile = 16;                        // == setup.TILE
constexpr int kDigitBits = 8;                    // == kernels.REC_DIGIT_BITS
constexpr int kBins = 1 << kDigitBits;
constexpr int kSortItems = 8;
constexpr int kSortBlock = kThreads * kSortItems;  // == kernels.REC_SORT_BLOCK
constexpr float kHwSnap = 256.0f;                // setup._HW_SNAP
constexpr float kHwBias = 1.0f / 65536.0f;       // setup._HW_BIAS, 2^-16
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBins == kThreads, "the sort keeps one digit a thread");

template <bool kHw>
__device__ __forceinline__ float snap(float v) {
  return kHw ? rintf(v * kHwSnap) * (1.0f / kHwSnap) : v;
}

// Triangle t's vertices; false where an index lies outside [0, nv) (v is
// then 0 there).
template <class Idx>
__device__ __forceinline__ bool load_vertices(const Idx* __restrict__ idx, int nv,
                                              long long t, int v[3]) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const long long i = (long long)idx[3 * t + k];
    const bool in = (i >= 0) & (i < nv);
    v[k] = in ? (int)i : 0;
    ok &= in;
  }
  return ok;
}

// Vertex v of one frame's fields, x and y snapped under kHw.
template <bool kHw>
__device__ __forceinline__ vf::Corner corner(const float* f, size_t nv, int v) {
  vf::Corner c = vf::load_corner(f, nv, v);
  c.x = snap<kHw>(c.x);
  c.y = snap<kHw>(c.y);
  return c;
}

// What the bbox test reads of vertex v.
template <bool kHw>
__device__ __forceinline__ vf::VertexTerms position(const float* f, size_t nv, int v) {
  return vf::vertex_terms(snap<kHw>(f[v]), snap<kHw>(f[nv + v]), f[2 * nv + v],
                          f[6 * nv + v], 0.0f, 0.0f, 0.0f);
}

// The tiles a binned triangle's pixel bbox spans (bin_tiles' sx * sy).
__device__ __forceinline__ int tiles_across(int p0, int p1) { return p1 / kTile - p0 / kTile + 1; }

// setup.setup_fields_core's edge threshold under the hw rule for the
// directed edge a->b: 0 for a top-left edge or a w-crossing triangle,
// else one lattice step.
__device__ __forceinline__ float edge_bias(float ax, float ay, float bx, float by, bool clean) {
  const bool horiz = ay == by;
  const bool topleft = (horiz & (bx > ax)) | (!horiz & (by < ay));
  return (topleft | !clean) ? 0.0f : kHwBias;
}

template <class T>
__device__ __forceinline__ T warp_inclusive(T v) {
  const int lane = (int)(threadIdx.x % 32);
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const T up = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// Exclusive scan of v over a kThreads block in thread order; *total the
// block's sum.
__device__ __forceinline__ long long block_exclusive(long long v, long long* warp_sum,
                                                     long long* total) {
  const int lane = (int)(threadIdx.x % 32), warp = (int)(threadIdx.x / 32);
  const long long incl = warp_inclusive(v);
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  long long before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_sum[w] : 0;
    all += warp_sum[w];
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

// Exclusive scan of in[0, n) into out[0, n) by one block of kScanThreads;
// returns the sum.
template <class T>
__device__ __forceinline__ T scan_exclusive(const T* in, int n, T* out) {
  __shared__ T warp_sum[kScanThreads / 32];
  const int lane = (int)(threadIdx.x % 32), warp = (int)(threadIdx.x / 32);
  T carry = 0;
  for (int c0 = 0; c0 < n; c0 += kScanThreads * kScanPer) {
    const int first = c0 + (int)threadIdx.x * kScanPer;
    T v[kScanPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      v[k] = first + k < n ? in[first + k] : 0;
      sum += v[k];
    }
    const T incl = warp_inclusive(sum);
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) warp_sum[lane] = warp_inclusive(warp_sum[lane]);
    __syncthreads();
    T run = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      if (first + k < n) out[first + k] = run;
      run += v[k];
    }
    carry += warp_sum[kScanThreads / 32 - 1];
    __syncthreads();
  }
  return carry;
}

template <class Idx, bool kHw>
__global__ void __launch_bounds__(kThreads)
rec_count_kernel(const float* __restrict__ f, int nv, const Idx* __restrict__ idx, int n_tris,
                 int blocks_per_frame, int width, int height, unsigned* __restrict__ bits,
                 int* __restrict__ block_binned, long long* __restrict__ block_pairs,
                 int* __restrict__ block_bad) {
  __shared__ long long warp_sum[kWarps];
  const int lane = (int)(threadIdx.x % 32), warp = (int)(threadIdx.x / 32);
  const int frame = (int)blockIdx.x / blocks_per_frame;
  const long long first = (long long)((int)blockIdx.x - frame * blocks_per_frame) * kBlock;
  const float* ff = f + (size_t)frame * vf::kFields * nv;
  int binned = 0;
  long long pairs = 0;
  bool bad = false;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long t = first + i * kThreads + threadIdx.x;
    bool valid = false;
    int v[3];
    if (t < n_tris) {
      if (load_vertices(idx, nv, t, v)) {
        const vf::Box b = vf::setup_bbox(position<kHw>(ff, nv, v[0]), position<kHw>(ff, nv, v[1]),
                                         position<kHw>(ff, nv, v[2]), width, height);
        valid = b.valid;
        if (valid) {
          ++binned;
          pairs += (long long)tiles_across(b.px0, b.px1) * tiles_across(b.py0, b.py1);
        }
      } else {
        bad = true;
      }
    }
    const unsigned vote = __ballot_sync(kFull, valid);
    if (lane == 0) bits[(size_t)blockIdx.x * kWords + i * kWarps + warp] = vote;
  }
  const int any_bad = __syncthreads_or(bad);
  long long all_pairs, all_binned;
  block_exclusive(pairs, warp_sum, &all_pairs);
  block_exclusive(binned, warp_sum, &all_binned);
  if (threadIdx.x == 0) {
    block_binned[blockIdx.x] = (int)all_binned;
    block_pairs[blockIdx.x] = all_pairs;
    block_bad[blockIdx.x] = any_bad != 0;
  }
}

// info: [binned records, pairs, whether an index was out of range].
__global__ void __launch_bounds__(kScanThreads)
rec_totals_kernel(const int* __restrict__ block_binned, const long long* __restrict__ block_pairs,
                  const int* __restrict__ block_bad, int n, int* __restrict__ rec_first,
                  long long* __restrict__ pair_first, long long* __restrict__ info) {
  int bad = 0;
  for (int i = (int)threadIdx.x; i < n; i += kScanThreads) bad |= block_bad[i];
  bad = __syncthreads_or(bad);
  const int records = scan_exclusive(block_binned, n, rec_first);
  const long long pairs = scan_exclusive(block_pairs, n, pair_first);
  if (threadIdx.x == 0) {
    info[0] = records;
    info[1] = pairs;
    info[2] = bad != 0;
  }
}

// A block takes the binned triangles of kGroup count blocks of one frame:
// their positions listed in order from the bits (bit j of word w is
// position 32 w + j), a thread a word, then kThreads of them a round (one
// round unless more are binned). A record's rank is its place in the list,
// so it is written where it belongs straight from registers; its first
// pair comes from one scan of the round's pair counts.
template <class Idx, bool kHw>
__global__ void __launch_bounds__(kThreads, 3)
rec_emit_kernel(const float* __restrict__ f, int nv, const Idx* __restrict__ idx,
                int blocks_per_frame, int groups_per_frame, int width, int height,
                const unsigned* __restrict__ bits, const int* __restrict__ rec_first,
                const long long* __restrict__ pair_first, float* __restrict__ records,
                int* __restrict__ keys, int* __restrict__ rows, int* __restrict__ boxes) {
  __shared__ long long warp_sum[kWarps];
  __shared__ unsigned short list[kGroup * kBlock];
  const int frame = (int)blockIdx.x / groups_per_frame;
  const int first_block = ((int)blockIdx.x - frame * groups_per_frame) * kGroup;
  const int words = min(kGroup, blocks_per_frame - first_block) * kWords;
  const size_t block = (size_t)frame * blocks_per_frame + first_block;
  const long long first = (long long)first_block * kBlock;
  const float* ff = f + (size_t)frame * vf::kFields * nv;
  const int ntx = (width + kTile - 1) / kTile;
  const int frame_key = frame * ntx * ((height + kTile - 1) / kTile);
  unsigned word = (int)threadIdx.x < words ? bits[block * kWords + threadIdx.x] : 0u;
  long long listed;
  int at = (int)block_exclusive(__popc(word), warp_sum, &listed);
  for (; word; word &= word - 1u) {
    list[at++] = (unsigned short)(threadIdx.x * 32 + __ffs(word) - 1);
  }
  __syncthreads();
  const int n = (int)listed;
  const int row0 = rec_first[block];
  long long pair0 = pair_first[block];
#pragma unroll 1
  for (int base = 0; base < n; base += kThreads) {
    const int j = base + (int)threadIdx.x;
    const bool valid = j < n;
    vf::Record r;
    float bias[3] = {0.0f, 0.0f, 0.0f};
    int sx = 0, sy = 0;
    if (valid) {
      int v[3];
      load_vertices(idx, nv, first + list[j], v);
      const vf::Corner c0 = corner<kHw>(ff, nv, v[0]), c1 = corner<kHw>(ff, nv, v[1]),
                       c2 = corner<kHw>(ff, nv, v[2]);
      vf::setup_fields_core(c0, c1, c2, width, height, r);
      if (kHw) {
        const bool clean = (c0.w > vf::kWEps) & (c1.w > vf::kWEps) & (c2.w > vf::kWEps);
        bias[0] = edge_bias(c1.x, c1.y, c2.x, c2.y, clean);
        bias[1] = edge_bias(c2.x, c2.y, c0.x, c0.y, clean);
        bias[2] = edge_bias(c0.x, c0.y, c1.x, c1.y, clean);
      }
      sx = tiles_across(r.px0, r.px1);
      sy = tiles_across(r.py0, r.py1);
      float4* out = reinterpret_cast<float4*>(records + (size_t)(row0 + j) * kRecWidth);
      const float* c = r.col;
#pragma unroll
      for (int q = 0; q < 7; ++q) {
        out[q] = make_float4(c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]);
      }
      out[7] = make_float4(c[28], c[29], c[30], bias[0]);
      out[8] = make_float4(bias[1], bias[2], 0.0f, 0.0f);
      out[9] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    long long total;
    long long p = pair0 + block_exclusive((long long)sx * sy, warp_sum, &total);
    if (valid) {
      const int row = row0 + j;
      const int tx0 = r.px0 / kTile, ty0 = r.py0 / kTile;
      for (int ty = ty0; ty < ty0 + sy; ++ty) {
        const int y = ty * kTile;
        const int by = (max(r.py0 - y, 0) << 8) | (min(r.py1 - y, kTile - 1) << 12);
        for (int tx = tx0; tx < tx0 + sx; ++tx, ++p) {
          const int x = tx * kTile;
          keys[p] = frame_key + ty * ntx + tx;
          rows[p] = row;
          boxes[p] = max(r.px0 - x, 0) | (min(r.px1 - x, kTile - 1) << 4) | by;
        }
      }
    }
    pair0 += total;
  }
}

// Each block's count of each digit, digit-major: hist[d * blocks + block].
__global__ void __launch_bounds__(kThreads)
rec_sort_count_kernel(const int* __restrict__ keys, int n, int shift, int* __restrict__ hist) {
  __shared__ int h[kBins];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kSortBlock + threadIdx.x;
#pragma unroll
  for (int it = 0; it < kSortItems; ++it) {
    const long long p = base + it * kThreads;
    if (p < n) atomicAdd(&h[(keys[p] >> shift) & (kBins - 1)], 1);
  }
  __syncthreads();
  hist[(size_t)threadIdx.x * gridDim.x + blockIdx.x] = h[threadIdx.x];
}

// One block a digit: its row of the counts scanned across the blocks, and
// the row's sum.
__global__ void __launch_bounds__(kScanThreads)
rec_sort_scan_kernel(const int* __restrict__ hist, int blocks, int* __restrict__ offs,
                     int* __restrict__ digit_total) {
  const size_t row = (size_t)blockIdx.x * blocks;
  const int total = scan_exclusive(hist + row, blocks, offs + row);
  if (threadIdx.x == 0) digit_total[blockIdx.x] = total;
}

// Pair p (the block's kSortItems rounds of kThreads, in order) goes to its
// digit's first place for this block -- the pairs of smaller digits, then
// the digit's pairs in earlier blocks -- plus the pairs of that digit before
// it in the block: earlier rounds (run), earlier warps of its round
// (wcount), earlier lanes of its warp (rank).
__global__ void __launch_bounds__(kThreads)
rec_sort_scatter_kernel(const int* __restrict__ keys, const int* __restrict__ rows,
                        const int* __restrict__ boxes, int n, int shift,
                        const int* __restrict__ offs, const int* __restrict__ digit_total,
                        int* __restrict__ keys_out, int* __restrict__ rows_out,
                        int* __restrict__ boxes_out) {
  __shared__ long long warp_sum[kWarps];
  __shared__ int run[kBins];
  __shared__ int wcount[kWarps][kBins];
  const int lane = (int)(threadIdx.x % 32), warp = (int)(threadIdx.x / 32);
  long long pairs;
  const int smaller = (int)block_exclusive(digit_total[threadIdx.x], warp_sum, &pairs);
  run[threadIdx.x] = smaller + offs[(size_t)threadIdx.x * gridDim.x + blockIdx.x];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) wcount[w][threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kSortBlock;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll 1
  for (int it = 0; it < kSortItems && base + it * kThreads < n; ++it) {
    const long long p = base + it * kThreads + threadIdx.x;
    const bool active = p < n;
    const int key = active ? keys[p] : 0;
    const int d = active ? (key >> shift) & (kBins - 1) : kBins;
    const unsigned peers = __match_any_sync(kFull, d);
    const int rank = __popc(peers & lower);
    if (active && rank == 0) wcount[warp][d] = __popc(peers);
    __syncthreads();
    if (active) {
      int dst = run[d] + rank;
      for (int w = 0; w < warp; ++w) dst += wcount[w][d];
      keys_out[dst] = key;
      rows_out[dst] = rows[p];
      boxes_out[dst] = boxes[p];
    }
    __syncthreads();
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sum += wcount[w][threadIdx.x];
      wcount[w][threadIdx.x] = 0;
    }
    run[threadIdx.x] += sum;
    __syncthreads();
  }
}

// offsets[k] = the first pair whose key is k or more, for k in [0, n_keys].
__global__ void __launch_bounds__(kThreads)
rec_offsets_kernel(const int* __restrict__ keys, int n, int n_keys, int* __restrict__ offsets) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p > n) return;
  const int lo = p == 0 ? 0 : keys[p - 1] + 1;
  const int hi = p == n ? n_keys : keys[p];
  for (int k = lo; k <= hi; ++k) offsets[k] = (int)p;
}

int blocks_of(long long n, int per) { return (int)((n + per - 1) / per); }

template <class Idx, bool kHw>
void count(const float* f, int nv, const void* idx, int n_tris, int frames, int width, int height,
           unsigned* bits, int* block_binned, long long* block_pairs, int* block_bad,
           cudaStream_t st) {
  const int per = blocks_of(n_tris, kBlock);
  rec_count_kernel<Idx, kHw><<<frames * per, kThreads, 0, st>>>(
      f, nv, static_cast<const Idx*>(idx), n_tris, per, width, height, bits, block_binned,
      block_pairs, block_bad);
}

template <class Idx, bool kHw>
void emit(const float* f, int nv, const void* idx, int n_tris, int frames, int width, int height,
          const unsigned* bits, const int* rec_first, const long long* pair_first,
          float* records, int* keys, int* rows, int* boxes, cudaStream_t st) {
  const int per = blocks_of(n_tris, kBlock), groups = blocks_of(per, kGroup);
  rec_emit_kernel<Idx, kHw><<<frames * groups, kThreads, 0, st>>>(
      f, nv, static_cast<const Idx*>(idx), per, groups, width, height, bits, rec_first,
      pair_first, records, keys, rows, boxes);
}

}  // namespace

extern "C" {

// The sizes kernels.load() holds to the Python constants.
int vf_rec_block() { return kBlock; }
int vf_rec_sort_block() { return kSortBlock; }
int vf_rec_digit_bits() { return kDigitBits; }
int vf_rec_tile() { return kTile; }
int vf_rec_width() { return kRecWidth; }

// The chain (see the note at the top), one kernel each on `stream`; each
// returns cudaGetLastError() after its launch. fields: (frames, kFields,
// nv) f32; indices: (n_tris, 3), int64 where wide != 0, else int32; hw:
// the hardware fill rule. The wrapper (kernels.rec_setup) calls them only
// with work to do. bits: frames * ceil(n_tris / kBlock) * kWords words;
// block_binned, block_pairs, block_bad: one a block.
int vf_rec_setup_count(const float* fields, int nv, const void* indices, int wide, int n_tris,
                       int frames, int width, int height, int hw, unsigned* bits,
                       int* block_binned, long long* block_pairs, int* block_bad,
                       void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const auto run = wide ? (hw ? count<long long, true> : count<long long, false>)
                        : (hw ? count<int, true> : count<int, false>);
  run(fields, nv, indices, n_tris, frames, width, height, bits, block_binned, block_pairs,
      block_bad, st);
  return (int)cudaGetLastError();
}

// rec_first: (blocks,) int32, pair_first: (blocks,) int64 out; info: three
// int64 out.
int vf_rec_setup_totals(const int* block_binned, const long long* block_pairs,
                        const int* block_bad, int blocks, int* rec_first, long long* pair_first,
                        long long* info, void* stream) {
  rec_totals_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(
      block_binned, block_pairs, block_bad, blocks, rec_first, pair_first, info);
  return (int)cudaGetLastError();
}

// records: (binned, kRecWidth) f32, 16-byte aligned; keys, rows, boxes:
// (pairs,) int32 out, in triangle order.
int vf_rec_setup_emit(const float* fields, int nv, const void* indices, int wide, int n_tris,
                      int frames, int width, int height, int hw, const unsigned* bits,
                      const int* rec_first, const long long* pair_first, float* records,
                      int* keys, int* rows, int* boxes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const auto run = wide ? (hw ? emit<long long, true> : emit<long long, false>)
                        : (hw ? emit<int, true> : emit<int, false>);
  run(fields, nv, indices, n_tris, frames, width, height, bits, rec_first, pair_first, records,
      keys, rows, boxes, st);
  return (int)cudaGetLastError();
}

// One sort pass over n pairs, on the kDigitBits bits of the keys from
// `shift`: hist and offs hold kBins * ceil(n / kSortBlock) int32, digit
// by digit; digit_total kBins int32.
int vf_rec_sort_count(const int* keys, int n, int shift, int* hist, void* stream) {
  rec_sort_count_kernel<<<blocks_of(n, kSortBlock), kThreads, 0, (cudaStream_t)stream>>>(
      keys, n, shift, hist);
  return (int)cudaGetLastError();
}

int vf_rec_sort_scan(const int* hist, int n, int* offs, int* digit_total, void* stream) {
  rec_sort_scan_kernel<<<kBins, kScanThreads, 0, (cudaStream_t)stream>>>(
      hist, blocks_of(n, kSortBlock), offs, digit_total);
  return (int)cudaGetLastError();
}

int vf_rec_sort_scatter(const int* keys, const int* rows, const int* boxes, int n, int shift,
                        const int* offs, const int* digit_total, int* keys_out, int* rows_out,
                        int* boxes_out, void* stream) {
  rec_sort_scatter_kernel<<<blocks_of(n, kSortBlock), kThreads, 0, (cudaStream_t)stream>>>(
      keys, rows, boxes, n, shift, offs, digit_total, keys_out, rows_out, boxes_out);
  return (int)cudaGetLastError();
}

// offsets: (n_keys + 1,) int32 out, from the n sorted keys.
int vf_rec_setup_offsets(const int* keys, int n, int n_keys, int* offsets, void* stream) {
  rec_offsets_kernel<<<blocks_of((long long)n + 1, kThreads), kThreads, 0,
                       (cudaStream_t)stream>>>(keys, n, n_keys, offsets);
  return (int)cudaGetLastError();
}

}  // extern "C"
