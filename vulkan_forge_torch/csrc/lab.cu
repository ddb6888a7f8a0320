// The lab kernels of vulkan_forge_torch (sm_90a): seven probes, each the
// counterpart of TPU kernels that a script in scripts/ launches to answer
// one question about the hardware. None is on the render path; they are
// built into a library of their own (lab/_kernels.py), so the raster
// library and its build time stay as they are.
//
//   vf_lab_fs_ops        replaces the per-op kernel of scripts/exp_fs_ops.py
//                        (main, :66-70): one of the nine transcendental ops
//                        the shipped shader uses, elementwise, with
//                        sinf, cosf, sqrtf, 1.0f/sqrtf, rsqrtf, powf, expf
//                        and logf. Do the card's ops give the plain
//                        versions' bits, and how far are both from f64?
//   vf_lab_fs_chain      replaces the kernel of scripts/exp_fs_mosaic_ops.py
//                        (:73-100): every intermediate of the shipped
//                        shader's chain for one channel of one pixel, in
//                        the op order of vf::shade_shipped, and in a last
//                        row the word vf::shade_shipped itself returns,
//                        so the probe is held to what the raster kernels
//                        run. The script takes lax.rsqrt for inv_len; this
//                        chain takes 1.0f / sqrtf, as the kernels do.
//   vf_lab_slab_copy     replaces the kernel of scripts/exp_lane_dma.py
//                        (:24-30): block i copies the 128-column slab
//                        src[:, 128i:128i+128] of a wide row-major array
//                        into shared memory with cp.async 16-byte copies,
//                        one commit group and a wait (make_async_copy +
//                        start/wait), then writes slab * 2 to output rows
//                        [i*rows, (i+1)*rows).
//   vf_lab_slab_transpose  replaces k_correct (scripts/exp_transpose.py:25-26,
//                        iters = 0: a transpose through shared memory, 32x32
//                        tiles padded to 33 columns against bank conflicts)
//                        and k_loop (:48-61, iters > 0: iteration i sums the
//                        (rows/4, cols) slab at row (rows/4)*(i % 4) over
//                        its rows, through the padded transpose or
//                        without one, into one accumulator per column).
//   vf_lab_step_loop     replaces the loop kernels of the deposit probes:
//                        scripts/exp_deposit_breakdown.py (run_kernel, :56),
//                        exp_deposit3.py (:46), exp_deposit2.py (:54),
//                        exp_loop_floor.py (:42) and exp_mosaic_facts.py's E5
//                        (:228). One block runs NSTEP steps of one of the
//                        scripts' 32 bodies (the template parameter, enum
//                        Body, in lab/_bodies.py's order), one thread per
//                        element of the (8, 128) tile; the scratch and the
//                        input stay in global memory (256-512 KB, more than
//                        a block's shared memory; resident in L2), a
//                        product's (128, 128) right operand is staged in
//                        shared memory, and products are float32 FMUL+FADD
//                        on the CUDA cores, summed in k order (HIGHEST's
//                        meaning is full float32).
//   vf_lab_onehot_dot    replaces E_exact (exp_deposit_breakdown.py:221) and
//                        E1 (exp_mosaic_facts.py:61): (m, 128) @ (128, n)
//                        float32 in one of three modes: ffma (CUDA cores,
//                        full float32, HIGHEST), tf32 (one mma.sync
//                        m16n8k8 TF32 pass, the counterpart of the default
//                        precision), tf32x3 (the left operand split into
//                        three cvt.rna.tf32 parts, three passes summed in
//                        float32). Which tensor-core path keeps f32 bits?
//   vf_lab_lane_ops      replaces E3 (exp_mosaic_facts.py:130, a lane roll)
//                        and E4 (:155, the exponent of a float's bits).
//                        E2 (:102, in-kernel transposes) is
//                        vf_lab_slab_transpose with iters = 0.
//
// What bounds them on an H100: nothing at these sizes but latency. The
// scripts' shapes are 32K elements (fs_ops), a few pixels (fs_chain),
// 128 KB (slab copy) and one 64 KB source walked by one block (the loop),
// so each launch costs a few microseconds of fixed overhead on the card
// and more on the host: a call's time is its launch path, which
// lab/_kernels.py keeps to the checks, the output's allocation and one
// ctypes call (and the shared-memory opt-ins to vf_lab_prepare, once per
// device).
// The loop is a chain of dependent shared-memory steps on one SM; what it
// measures is the per-iteration cost of the transpose, as the script's
// does on the TPU. The step loop is the same on one SM: a chain of steps,
// each a few hundred float32 operations per thread (the products: 128 k
// per output row a thread keeps), with barriers between its phases; what
// it measures is a step's cost on one SM, as the scripts do on one core.
//
// Numerics: built with the raster kernels' flags (-fmad=false, no fast
// math), so +, -, *, / and sqrtf round once (IEEE round to nearest) and
// the transcendentals are CUDA's libdevice functions within the maximum
// ulp errors of the CUDA C++ Programming Guide's single-precision table.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "raster_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kOps = 9;             // == len(lab._kernels.OPS)
constexpr int kChainRows = 15;      // 14 intermediates + shade_shipped's word
constexpr int kSlabCols = 128;      // the TPU's lane width
constexpr int kTile = 32;           // the transpose's tile side
constexpr float kInvGamma = (float)(1.0 / 2.4);

// exp_fs_ops.py:45-56, in its order.
__global__ void lab_fs_ops_kernel(const float* __restrict__ t,
                                  const float* __restrict__ u,
                                  const float* __restrict__ p, long long n,
                                  int op, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float r;
  switch (op) {
    case 0: r = sinf(t[i] * 1.3f); break;
    case 1: r = cosf(t[i] * 1.3f); break;
    case 2: r = sqrtf(p[i]); break;
    case 3: r = 1.0f / sqrtf(p[i]); break;
    case 4: r = rsqrtf(p[i]); break;
    case 5: r = powf(u[i], kInvGamma); break;
    case 6: r = expf(u[i] * -3.0f); break;
    case 7: r = logf(p[i]); break;
    default: r = expf(logf(fmaxf(u[i], 1e-30f)) * kInvGamma); break;
  }
  out[i] = r;
}

// One thread per pixel. out: (kChainRows, n), row-major; the last row holds
// shade_shipped's word as its bits.
__global__ void lab_fs_chain_kernel(const float* __restrict__ hh,
                                    const float* __restrict__ xx,
                                    const float* __restrict__ zz,
                                    const int* __restrict__ channel, int n,
                                    const float* __restrict__ lut,
                                    const float* __restrict__ par,
                                    float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const float hr2 = par[0], exposure = par[1], l0 = par[2], l1 = par[3],
              l2 = par[4];
  const float h = hh[k], x = xx[k], z = zz[k];
  const int c = channel[k];
  // vf::shade_shipped's operations for a covered pixel, in its order.
  const float t = vf::clampf(0.5f + h / hr2, 0.0f, 1.0f);
  const float xf = t * 256.0f - 0.5f;
  const float x0 = floorf(xf);
  const float frac = xf - x0;
  const int i0 = (int)vf::clampf(x0, 0.0f, 255.0f);
  const int i1 = (int)vf::clampf(x0 + 1.0f, 0.0f, 255.0f);
  const float dhdx = 1.3f * cosf(x * 1.3f) * 0.25f;
  const float dhdz = -1.1f * sinf(z * 1.1f) * 0.25f;
  const float inv_len = 1.0f / sqrtf(dhdx * dhdx + 1.0f + dhdz * dhdz);
  const float lambert =
      vf::clampf((-dhdx * l0 + l1 - dhdz * l2) * inv_len, 0.0f, 1.0f);
  const float shade = 0.15f + 0.85f * lambert;
  const float c0 = lut[i0 * 3 + c];
  const float c1 = lut[i1 * 3 + c];
  const float lin = c0 * (1.0f - frac) + c1 * frac;
  const float v = vf::clampf(lin * exposure * shade, 0.0f, 1.0f);
  const float lo = v * 12.92f;
  const float hi = 1.055f * powf(fmaxf(v, 1e-12f), kInvGamma) - 0.055f;
  const float s = v <= 0.0031308f ? lo : hi;
  const float u8f = floorf(vf::clampf(s, 0.0f, 1.0f) * 255.0f + 0.5f);
  const int32_t word =
      vf::shade_shipped(h, x, z, true, lut, hr2, exposure, l0, l1, l2);
  const float rows[kChainRows] = {t,       xf,      frac,   c0,    c1,
                                  lin,     dhdx,    dhdz,   inv_len, lambert,
                                  shade,   v,       s,      u8f,
                                  __int_as_float(word)};
#pragma unroll
  for (int r = 0; r < kChainRows; ++r) out[(size_t)r * n + k] = rows[r];
}

// Block i: the slab src[:, 128i : 128i+128] -> shared memory -> out rows
// [i*rows, (i+1)*rows), times 2. Each 16-byte piece is one cp.async.
__global__ void lab_slab_copy_kernel(const float* __restrict__ src, int rows,
                                     int cols, float* __restrict__ out) {
  extern __shared__ __align__(16) float slab[];  // rows x kSlabCols
  const int i = blockIdx.x;
  const int pieces = rows * (kSlabCols / 4);
  for (int k = threadIdx.x; k < pieces; k += blockDim.x) {
    const int r = k / (kSlabCols / 4), q = k % (kSlabCols / 4);
    const float* g = src + (size_t)r * cols + (size_t)i * kSlabCols + q * 4;
    const unsigned s = (unsigned)__cvta_generic_to_shared(slab + 4 * k);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(g));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out + (size_t)i * rows * kSlabCols);
  const float4* sl = reinterpret_cast<const float4*>(slab);
  for (int k = threadIdx.x; k < pieces; k += blockDim.x) {
    float4 v = sl[k];
    v.x *= 2.0f;
    v.y *= 2.0f;
    v.z *= 2.0f;
    v.w *= 2.0f;
    o[k] = v;
  }
}

// k_correct: (rows, cols) -> (cols, rows), one 32x32 tile per block, staged
// in a tile padded to 33 columns so that neither the row-wise writes nor
// the column-wise reads of shared memory meet a bank twice.
__global__ void lab_transpose_kernel(const float* __restrict__ src, int rows,
                                     int cols, float* __restrict__ out) {
  __shared__ float tile[kTile][kTile + 1];
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const int col0 = blockIdx.x * kTile, row0 = blockIdx.y * kTile;
  for (int r = ty; r < kTile; r += kThreads / kTile) {
    const int gr = row0 + r, gc = col0 + tx;
    if (gr < rows && gc < cols) tile[r][tx] = src[(size_t)gr * cols + gc];
  }
  __syncthreads();
  for (int r = ty; r < kTile; r += kThreads / kTile) {
    const int orow = col0 + r, ocol = row0 + tx;  // out[orow][ocol] = src[ocol][orow]
    if (orow < cols && ocol < rows) out[(size_t)orow * rows + ocol] = tile[tx][r];
  }
}

// k_loop: one block, thread c owns column c. The source sits in shared
// memory (the script's src_ref is in VMEM); iteration i takes the slab of
// S = rows/4 rows at row S*(i % 4). With kTranspose the slab is first
// written transposed into a tile padded to S+1 columns (thread c stores
// slab column c as tile row c: the reads along a slab row are consecutive,
// the stores 33 words apart, so neither meets a bank twice), and after a
// barrier summed there (the sum over axis 1 of v.T); else it is summed in
// place (axis 0 of v). Both add a column's S values in row order, so both
// give the same sums; the difference in time is the transpose's.
template <bool kTranspose>
__global__ void lab_slab_loop_kernel(const float* __restrict__ src, int rows,
                                     int cols, int iters,
                                     float* __restrict__ out) {
  extern __shared__ float sm[];
  const int S = rows / 4;
  float* source = sm;                       // rows x cols
  float* tile = sm + (size_t)rows * cols;   // cols x (S + 1)
  for (int k = threadIdx.x; k < rows * cols; k += blockDim.x) source[k] = src[k];
  __syncthreads();
  const int c = threadIdx.x;
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const float* slab = source + (size_t)(i % 4) * S * cols;
    float sum = 0.0f;
    if (kTranspose) {
      if (c < cols) {
        for (int r = 0; r < S; ++r) tile[c * (S + 1) + r] = slab[r * cols + c];
      }
      __syncthreads();
      if (c < cols) {
        for (int r = 0; r < S; ++r) sum += tile[c * (S + 1) + r];
      }
      __syncthreads();
    } else if (c < cols) {
      for (int r = 0; r < S; ++r) sum += slab[r * cols + c];
    }
    acc += sum;
  }
  if (c < cols) out[c] = acc;
}

// ---------------- vf_lab_step_loop: the deposit probes' loops ----------------

constexpr int kLoopThreads = 1024;   // one per element of the (8, 128) tile
constexpr int kLanes = 128;
constexpr int kTileRows = 8;
constexpr int kOperand = 128 * 128;  // a product's right operand (K = 128 rows)
constexpr int kLhsRows = 80;         // the largest left operand held in shared memory
constexpr size_t kLoopSmem = (size_t)(kOperand + kLhsRows * kLanes) * sizeof(float);

// The scripts' bodies, in lab/_bodies.py's BODIES order.
enum Body : int {
  V_EVAL, V_PBUILD, V_TR, V_MM4, V_MM1, V_MM48, V_GB, V_FULL,          // breakdown
  D_BASE, D_STRIPS, D_EVAL4, D_MM, D_FULL,                              // deposit3
  B_BASE, B_EVAL1, B_EVAL4, B_BM, B_TR, B_P1, B_MMA, B_FULL,           // deposit2
  C_SCALAR, C_SLICE, C_RMWF, C_RMWD, C_RMWD_AND, C_U4, C_U8,           // loop_floor
  C_EVAL4_U1, C_EVAL4_U4, C_EVAL4_U8,
  E5,                                                                   // mosaic_facts
  kBodies
};

__host__ __device__ constexpr int unroll_of(int b) {
  return (b == C_U4 || b == C_EVAL4_U4) ? 4 : (b == C_U8 || b == C_EVAL4_U8) ? 8 : 1;
}
// What the output adds to the scratch's rows 0..7: breakdown's (8, 128)
// carry, the other scripts' scalar carry, or nothing (E5).
__host__ __device__ constexpr bool tile_carry(int b) { return b <= V_FULL; }
__host__ __device__ constexpr bool scalar_carry(int b) { return b >= D_BASE && b < E5; }

// A thread's view of the loop: its element (d, c) of the (8, 128) tile.
struct Loop {
  const float* big;  // the input, (rows, 128), read only
  float* acc;        // the scratch, (rows, 128), global memory
  int rows;          // the scratch's rows
  float* sb;         // shared: a product's right operand, 128 x 128
  float* sa;         // shared: a left operand from registers, up to 80 x 128
  int t, d, c;       // thread, tile row (dy), lane
  float tile;        // breakdown's carry, element (d, c)
  float scalar;      // the scalar carry
};

// Scratch element (row, c).
__device__ __forceinline__ float& at(const Loop& L, int row) {
  return L.acc[(size_t)row * kLanes + L.c];
}
// Row d of the 8 scratch rows from start, the start clamped to the last
// that fits (XLA's dynamic-slice rule; the TPU checks no bound).
__device__ __forceinline__ float& rows_at(const Loop& L, int start) {
  return at(L, min(start, L.rows - kTileRows) + L.d);
}
// recs_of: the step's 32 record rows.
__device__ __forceinline__ const float* recs_of(const Loop& L, int i) {
  return L.big + (size_t)((i % 8) * 32) * kLanes;
}
// py_of: the pixel centre of tile row d at tile row ty = i % 64.
__device__ __forceinline__ float py_of(const Loop& L, int i) {
  return ((float)L.d + (float)((i % 64) * 8)) + 0.5f;
}
// 2**(lane - 24 * (lane / 24)), exactly, from its bits.
__device__ __forceinline__ float lane_power(int c) {
  return __int_as_float((c - (c / 24) * 24 + 127) << 23);
}
// ((bits >> 23) & 0xFF) - 127 of x's float32 bits, as float.
__device__ __forceinline__ float exponent_of(float x) {
  return (float)(((__float_as_int(x) >> 23) & 0xFF) - 127);
}

// eval_slot's coverage tests: three edges (breakdown, E5); and az >= 0,
// aw > 0, aw - az >= 0 (deposit2, loop_floor); or asum - az >= 0 (deposit3).
enum Cover : int { kEdges, kAwAz, kAsumAz };
struct Slot {
  float cov, a0, a1, a2, aw;
};

template <int kCover>
__device__ __forceinline__ Slot eval_slot(const float* recs, int c, float py, int s) {
  auto col = [&](int k) { return recs[k * kLanes + c]; };
  const float px = col(25) + ((float)s + 0.5f);
  const float f0 = col(2) * (px - col(0)) - col(3) * (py - col(1));
  const float f1 = col(6) * (px - col(4)) - col(7) * (py - col(5));
  const float f2 = col(10) * (px - col(8)) - col(11) * (py - col(9));
  const float aw = f0 * col(21) + f1 * col(22) + f2 * col(23);
  bool cov = f0 >= 0.0f && f1 >= 0.0f && f2 >= 0.0f;
  if (kCover != kEdges) {
    const float az = f0 * col(25) + f1 * col(26) + f2 * col(27);
    const float last =
        kCover == kAwAz ? aw - az : (f0 * col(28) + f1 * col(29) + f2 * col(30)) - az;
    cov = cov && az >= 0.0f && aw > 0.0f && last >= 0.0f;
  }
  Slot r;
  r.cov = cov ? 1.0f : 0.0f;
  r.a0 = f0 * col(12) + f1 * col(13) + f2 * col(14);
  r.a1 = f0 * col(15) + f1 * col(16) + f2 * col(17);
  r.a2 = f0 * col(18) + f1 * col(19) + f2 * col(20);
  r.aw = aw;
  return r;
}

// dst (128 x 128) = ((col[k] + s) == n): the one-hot of the lanes col + s.
__device__ __forceinline__ void build_onehot(const Loop& L, const float* col, float s,
                                             float* dst) {
  for (int e = L.t; e < kOperand; e += kLoopThreads) {
    dst[e] = (col[e >> 7] + s == (float)(e & 127)) ? 1.0f : 0.0f;
  }
}

// L.sb = rows [0, 128) of src, 16 bytes a copy. The caller brackets it
// with barriers.
__device__ __forceinline__ void stage(const Loop& L, const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(L.sb);
  for (int e = L.t; e < kOperand / 4; e += kLoopThreads) d4[e] = s4[e];
}

// hi_dot on the CUDA cores: w[j] = sum_k A(d + 8j, k) * B(k, c) over one
// 128-row block of k, each product and each sum rounded once (-fmad=false),
// summed in k order from the k = 0 product (first) or onto w (the next
// block): _bodies.mm's order. A(m, k) = a[m * am + k * ak] (global or
// shared memory), B(k, n) = L.sb[k * bk + n * bn]. Rows j that the caller
// never reads are dead code to the compiler.
template <int kM>
__device__ __forceinline__ void mm(const Loop& L, const float* a, int am, int ak, int bk,
                                   int bn, float (&w)[kM / 8], bool first = true) {
  int k0 = 0;
  if (first) {
    const float b = L.sb[L.c * bn];
#pragma unroll
    for (int j = 0; j < kM / 8; ++j) w[j] = a[(L.d + 8 * j) * am] * b;
    k0 = 1;
  }
  for (int k = k0; k < 128; ++k) {
    const float b = L.sb[k * bk + L.c * bn];
#pragma unroll
    for (int j = 0; j < kM / 8; ++j) w[j] = w[j] + a[(L.d + 8 * j) * am + k * ak] * b;
  }
}

template <int kM>
__device__ __forceinline__ void mm_rows(const Loop& L, const float* a, float (&w)[kM / 8]) {
  mm<kM>(L, a, kLanes, 1, kLanes, 1, w);
}

// The winning lane of pixel (d, c) from the 6 bitmask groups wa[g]: the
// exponent of the last group's sum above zero, plus 24 * g; init if none.
__device__ __forceinline__ float winner(const float (&wa)[6], float init) {
  float win = init;
#pragma unroll
  for (int g = 0; g < 6; ++g) {
    if (wa[g] > 0.0f) win = exponent_of(wa[g]) + (float)(g * 24);
  }
  return win;
}

template <int kCover>
__device__ __forceinline__ float eval4(const float* recs, int c, float py) {
  float tot = 0.0f;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const Slot e = eval_slot<kCover>(recs, c, py, s);
    tot = tot + e.cov * e.a0 + e.a1 * e.a2 + e.aw;
  }
  return tot;
}

// d_full (kAsumAz) and b_full (kAwAz): the whole deposit trip.
template <int kCover>
__device__ __forceinline__ void full_trip(Loop& L, int i) {
  const float* recs = recs_of(L, i);
  const float py = py_of(L, i);
  const int ty = i % 64, grp = L.c / 24;
  const float pw = lane_power(L.c);
  float wa[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, wb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float kill = 0.0f;
  for (int s = 0; s < 4; ++s) {
    __syncthreads();  // the readers of the operands of the previous slot are done
    const Slot e = eval_slot<kCover>(recs, L.c, py, s);
    const float bm = e.cov * pw;
#pragma unroll
    for (int g = 0; g < 6; ++g) at(L, 96 + g * 8 + L.d) = bm * (grp == g ? 1.0f : 0.0f);
    build_onehot(L, recs + 25 * kLanes, (float)s, L.sb);
    at(L, 160 + L.d) = e.cov * e.a0;
    at(L, 168 + L.d) = e.cov * e.a1;
    at(L, 176 + L.d) = e.cov * e.a2;
    at(L, 184 + L.d) = e.cov * e.aw;
    if (kCover == kAwAz) L.sa[L.d * kLanes + L.c] = py * 0.001f;  // the stand-in's LHS
    __syncthreads();
    float ta[6], tb[4], tk[1];
    mm_rows<48>(L, L.acc + 96 * kLanes, ta);
#pragma unroll
    for (int j = 0; j < 6; ++j) wa[j] = wa[j] + ta[j];
    mm_rows<32>(L, L.acc + 160 * kLanes, tb);
#pragma unroll
    for (int j = 0; j < 4; ++j) wb[j] = wb[j] + tb[j];
    if (kCover == kAsumAz) {  // kill += WA[0:8] @ P
      L.sa[L.d * kLanes + L.c] = wa[0];
      __syncthreads();
      mm_rows<8>(L, L.sa, tk);
    } else {  // kill += broadcast(py * 0.001) @ P.T
      mm<8>(L, L.sa, kLanes, 1, 1, kLanes, tk);
    }
    kill = kill + tk[0];
  }
  __syncthreads();  // every product has read scratch rows 96..191
  const float win = winner(wa, -1.0f);
  float& cur = rows_at(L, ty * 8);
  const float v = cur;
  bool better;
  if (kCover == kAsumAz) {
    better = win + kill * 0.0f > v;
    cur = better ? win : v;
  } else {
    better = win > v;
    cur = better ? win + kill * 0.0f : v;
  }
  float& r2 = rows_at(L, ty * 8 + 512);
  r2 = better ? wb[0] : r2;
}

// One logical step i of body kBody (each script's body, in its op order).
template <int kBody>
__device__ __forceinline__ void step(Loop& L, int i) {
  const int ty = i % 64;
  if constexpr (kBody == V_EVAL) {
    const float py = py_of(L, i);
    float tot = L.tile;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const Slot e = eval_slot<kEdges>(L.big, L.c, py, s);
      tot = tot + e.cov * e.a0 + e.a1 + e.a2 * e.aw;
    }
    L.tile = tot;
  } else if constexpr (kBody == V_PBUILD) {
    const float x = L.big[25 * kLanes + L.d];
    float tot = L.tile;
#pragma unroll
    for (int s = 0; s < 4; ++s) tot = tot + ((x + (float)s == (float)L.c) ? 1.0f : 0.0f);
    L.tile = tot;
  } else if constexpr (kBody == V_TR) {
    L.tile = L.tile + (L.big[25 * kLanes + L.d] + (float)i);
  } else if constexpr (kBody == V_MM4) {
    float tot = L.tile;
    for (int s = 0; s < 4; ++s) {
      __syncthreads();
      stage(L, L.acc + (size_t)(128 + 128 * s) * kLanes);
      __syncthreads();
      float w[10];
      mm_rows<80>(L, L.acc, w);
      tot = tot + w[0];
    }
    L.tile = tot;
  } else if constexpr (kBody == V_MM1 || kBody == V_MM48) {
    constexpr int M = kBody == V_MM1 ? 80 : 48;  // (M, 512) = acc[0:512, 0:M].T
    float w[M / 8];
    for (int ch = 0; ch < 4; ++ch) {
      __syncthreads();
      stage(L, L.acc + (size_t)ch * kOperand);
      __syncthreads();
      mm<M>(L, L.acc + (size_t)ch * kOperand, 1, kLanes, kLanes, 1, w, ch == 0);
    }
    L.tile = L.tile + w[0];
  } else if constexpr (kBody == V_GB) {
    __syncthreads();
    stage(L, L.acc);  // PT = acc[0:128]
    __syncthreads();
    float w[1];
    mm_rows<8>(L, L.acc, w);
    for (int r = 0; r < 3; ++r) {
      L.sa[L.d * kLanes + L.c] = w[0];
      __syncthreads();
      mm_rows<8>(L, L.sa, w);
      __syncthreads();
    }
    L.tile = L.tile + w[0];
  } else if constexpr (kBody == V_FULL) {
    const float py = py_of(L, i);
    const int grp = L.c / 24;
    const float pw = lane_power(L.c);
    __syncthreads();  // the previous step's readers are done
    for (int s = 0; s < 4; ++s) {
      const Slot e = eval_slot<kEdges>(L.big, L.c, py, s);
      const float bm = e.cov * pw;
#pragma unroll
      for (int g = 0; g < 6; ++g)
        at(L, 150 + s * 48 + g * 8 + L.d) = bm * (grp == g ? 1.0f : 0.0f);
      build_onehot(L, L.big + 25 * kLanes, (float)s, L.acc + 350 * kLanes);
    }
    __syncthreads();
    stage(L, L.acc + 350 * kLanes);  // PA: the last slot's P
    __syncthreads();
    float wa[6];
    mm_rows<48>(L, L.acc + 150 * kLanes, wa);
    const float win = winner(wa, 0.0f);
    L.sa[L.d * kLanes + L.c] = win;
    __syncthreads();
    float kill = 0.0f;
    for (int s = 0; s < 4; ++s) {
      float kw[1];
      mm_rows<8>(L, L.sa, kw);
      kill = kill + kw[0];
    }
    float wb[4];
    mm_rows<32>(L, L.acc + 150 * kLanes, wb);
    __syncthreads();  // every product has read scratch rows 150..197
    float& cur = rows_at(L, ty * 8);
    const float v = cur;
    cur = win > v ? win : v;
    L.tile = L.tile + wb[0] + kill;
  } else if constexpr (kBody == D_BASE || kBody == B_BASE) {
    float& a = rows_at(L, ty * 8);
    a = a + recs_of(L, i)[L.d * kLanes + L.c] + py_of(L, i);
  } else if constexpr (kBody == D_STRIPS) {
    const float* rec = recs_of(L, i);  // rec[t * 128 + k]: triangle t's field k
    const float py = py_of(L, i);
    const float px = (float)L.c + 0.5f;
    float cids[kTileRows], a0[kTileRows], a1[kTileRows], a2[kTileRows], aw[kTileRows];
    bool cov[kTileRows];
#pragma unroll
    for (int t = 0; t < kTileRows; ++t) {
      auto col = [&](int k) { return rec[t * kLanes + k]; };
      const float f0 = col(2) * (px - col(0)) - col(3) * (py - col(1));
      const float f1 = col(6) * (px - col(4)) - col(7) * (py - col(5));
      const float f2 = col(10) * (px - col(8)) - col(11) * (py - col(9));
      a0[t] = f0 * col(12) + f1 * col(13) + f2 * col(14);
      a1[t] = f0 * col(15) + f1 * col(16) + f2 * col(17);
      a2[t] = f0 * col(18) + f1 * col(19) + f2 * col(20);
      aw[t] = f0 * col(21) + f1 * col(22) + f2 * col(23);
      const float az = f0 * col(25) + f1 * col(26) + f2 * col(27);
      const float asum = f0 * col(28) + f1 * col(29) + f2 * col(30);
      cov[t] = f0 >= 0.0f && f1 >= 0.0f && f2 >= 0.0f && az >= 0.0f && aw[t] > 0.0f &&
               asum - az >= 0.0f;
      cids[t] = cov[t] ? (float)t : -1.0f;
    }
    float wid = cids[0];
#pragma unroll
    for (int t = 1; t < kTileRows; ++t) wid = fmaxf(wid, cids[t]);
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, cw = 0.0f;
#pragma unroll
    for (int t = 0; t < kTileRows; ++t) {
      const float sel = (cids[t] == wid && cov[t]) ? 1.0f : 0.0f;
      c0 = c0 + a0[t] * sel;
      c1 = c1 + a1[t] * sel;
      c2 = c2 + a2[t] * sel;
      cw = cw + aw[t] * sel;
    }
    float& cur = rows_at(L, ty * 8);
    const float v = cur;
    const bool better = wid > v;
    cur = better ? wid : v;
    const float cs[4] = {c0, c1, c2, cw};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float& r = rows_at(L, ty * 8 + 128 * (k + 1));
      r = better ? cs[k] : r;
    }
  } else if constexpr (kBody == D_EVAL4) {
    float& a = rows_at(L, ty * 8);
    a = a + eval4<kAsumAz>(recs_of(L, i), L.c, py_of(L, i));
  } else if constexpr (kBody == B_EVAL4 || kBody == C_EVAL4_U1 || kBody == C_EVAL4_U4 ||
                       kBody == C_EVAL4_U8) {
    float& a = rows_at(L, ty * 8);
    a = a + eval4<kAwAz>(recs_of(L, i), L.c, py_of(L, i));
  } else if constexpr (kBody == D_MM) {
    const int off = (i % 4) * 128;
    const float* lhs = L.big + (size_t)off * kLanes;  // lhsA; lhsB = its rows 0..31
    float wa[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, wb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float gb = 0.0f;
    for (int s = 0; s < 4; ++s) {
      __syncthreads();
      stage(L, L.big + (size_t)(off + s) * kLanes);
      __syncthreads();
      float ta[6], tb[4], tg[1];
      mm_rows<48>(L, lhs, ta);
      mm_rows<32>(L, lhs, tb);
#pragma unroll
      for (int j = 0; j < 6; ++j) wa[j] = wa[j] + ta[j];
#pragma unroll
      for (int j = 0; j < 4; ++j) wb[j] = wb[j] + tb[j];
      L.sa[L.d * kLanes + L.c] = wa[0];
      __syncthreads();
      mm_rows<8>(L, L.sa, tg);
      gb = gb + tg[0];
    }
    float& a = rows_at(L, ty * 8);
    a = a + wa[0] + wb[0] + gb;
  } else if constexpr (kBody == D_FULL) {
    full_trip<kAsumAz>(L, i);
  } else if constexpr (kBody == B_EVAL1) {
    const Slot e = eval_slot<kAwAz>(recs_of(L, i), L.c, py_of(L, i), 0);
    float& a = rows_at(L, ty * 8);
    a = a + e.cov * e.a0 + e.a1 * e.a2 + e.aw;
  } else if constexpr (kBody == B_BM) {
    const float* recs = recs_of(L, i);
    const float py = py_of(L, i);
    const int grp = L.c / 24;
    const float pw = lane_power(L.c);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float bm = eval_slot<kAwAz>(recs, L.c, py, s).cov * pw;
#pragma unroll
      for (int g = 0; g < 6; ++g) at(L, 64 + g * 8 + L.d) = bm * (grp == g ? 1.0f : 0.0f);
    }
    float& a = rows_at(L, ty * 8);
    a = a + at(L, 64 + L.d);
  } else if constexpr (kBody == B_TR) {
    float& a = rows_at(L, ty * 8);
    a = a + recs_of(L, i)[25 * kLanes + L.d] + py_of(L, i);
  } else if constexpr (kBody == B_P1) {
    const float p = recs_of(L, i)[25 * kLanes + L.d] == (float)L.c ? 1.0f : 0.0f;
    float& a = rows_at(L, ty * 8);
    a = a + p + py_of(L, i);
  } else if constexpr (kBody == B_MMA) {
    const float* src = L.big + (size_t)((i % 4) * 128) * kLanes;  // lhs and P
    __syncthreads();
    stage(L, src);
    __syncthreads();
    float w[6];
    mm_rows<48>(L, src, w);
    float& a = rows_at(L, ty * 8);
    a = a + w[0] + py_of(L, i);
  } else if constexpr (kBody == B_FULL) {
    full_trip<kAwAz>(L, i);
  } else if constexpr (kBody == C_SCALAR) {
    L.scalar = L.scalar + (float)(i % 64);
  } else if constexpr (kBody == C_SLICE) {
    L.scalar = L.scalar + recs_of(L, i)[0];
  } else if constexpr (kBody == C_RMWF) {
    at(L, L.d) = at(L, L.d) + recs_of(L, i)[L.d * kLanes + L.c];
  } else if constexpr (kBody == C_RMWD || kBody == C_U4 || kBody == C_U8) {
    float& a = rows_at(L, ty * 8);
    a = a + recs_of(L, i)[L.d * kLanes + L.c];
  } else if constexpr (kBody == C_RMWD_AND) {
    float& a = rows_at(L, (i & 63) * 8);
    a = a + L.big[(size_t)((i & 7) * 32 + L.d) * kLanes + L.c];
  } else if constexpr (kBody == E5) {
    const float py = py_of(L, i);
    float total = 0.0f;
    for (int s = 0; s < 4; ++s) {
      __syncthreads();
      const Slot e = eval_slot<kEdges>(L.big, L.c, py, s);
      // LHS: [cov*a0, cov*a1, cov*a2, cov*aw, cov] twice, 8 rows each.
      const float lhs[5] = {e.cov * e.a0, e.cov * e.a1, e.cov * e.a2, e.cov * e.aw, e.cov};
#pragma unroll
      for (int j = 0; j < 10; ++j) L.sa[(j * 8 + L.d) * kLanes + L.c] = lhs[j % 5];
      build_onehot(L, L.big + 25 * kLanes, (float)s, L.sb);
      __syncthreads();
      float w[10];
      mm_rows<80>(L, L.sa, w);
      total = total + w[0] + w[5];
    }
    float& a = rows_at(L, ty * 8);
    a = a + total;
  }
}

// One block: nstep = iters * unroll_of(kBody) logical steps, then out =
// carry + acc[0:8] (breakdown), acc[0:8] + carry (the scalar carries) or
// acc[0:8] (E5).
template <int kBody>
__global__ void __launch_bounds__(kLoopThreads, 1)
    lab_step_loop_kernel(const float* __restrict__ big, float* acc, int rows, int iters,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) float loop_smem[];
  Loop L{big, acc, rows, loop_smem, loop_smem + kOperand, (int)threadIdx.x,
         (int)threadIdx.x / kLanes, (int)threadIdx.x % kLanes, 0.0f, 0.0f};
  constexpr int kUnroll = unroll_of(kBody);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) step<kBody>(L, it * kUnroll + j);
  }
  __syncthreads();
  const float a = at(L, L.d);
  out[L.d * kLanes + L.c] = tile_carry(kBody) ? L.tile + a : scalar_carry(kBody) ? a + L.scalar : a;
}

using LoopKernel = void (*)(const float*, float*, int, int, float*);

template <int... B>
LoopKernel loop_kernel(int body, std::integer_sequence<int, B...>) {
  static const LoopKernel table[] = {lab_step_loop_kernel<B>...};
  return table[body];
}

// ---------------- vf_lab_onehot_dot: E_exact and E1 ----------------
//
// What bounds it on an H100: its launch. The scripts' products are (80 or
// 96, 128) @ (128, 128): 1.3-1.6 M multiply-adds, 112-128 KB of operands,
// microseconds of work for one SM and well under one for the card. So the
// work is spread over the card, and each output keeps its own instruction
// sequence (the bits of every mode stay what they were on one block):
//   ffma    one thread per output element, blocks of kDotThreads: the
//           128-term chain in k order, a's row and b's column read from
//           global memory (L1 and L2: a warp shares its row, and reads
//           b's row k as 128 consecutive bytes);
//   tf32,   one warp per 16 x 8 output tile, one warp a block (80 blocks
//   tf32x3  for E_exact, 96 for E1): the warp loads the fragments of all
//           16 k steps of its 16 rows of a and 8 columns of b into
//           registers up front, then runs the mma steps, k0 ascending.
// Elements past m and n read as zero (masked loads, not a zero-padded
// copy), and neither kernel uses shared memory, so no launch needs the
// opt-in above 48 KB.

constexpr int kDotThreads = 128;
constexpr int kDotK = 128;
constexpr int kDotSteps = kDotK / 8;
enum DotMode : int { kFfma, kTf32, kTf32x3 };

// cvt.rna.tf32.f32: round to the tf32 grid (10 mantissa bits), to nearest,
// ties away from zero; the result is the float32 with its 13 low bits 0.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += A (16 x 8, row) @ B (8 x 8, col), TF32 inputs, float32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ffma: out (m, n) = a (m, 128) @ b (128, n), thread e the element (e / n,
// e % n): s = a0 * b0, then s = s + ak * bk for k = 1..127, each product
// and each sum rounded once (-fmad=false).
__global__ void __launch_bounds__(kDotThreads)
    lab_onehot_dot_ffma_kernel(const float* __restrict__ a, const float* __restrict__ b,
                               int m, int n, float* __restrict__ out) {
  const int e = blockIdx.x * kDotThreads + threadIdx.x;
  if (e >= m * n) return;
  const int col = e % n;
  const float* ar = a + (e / n) * kDotK;
  float s = ar[0] * b[col];
#pragma unroll 32
  for (int k = 1; k < kDotK; ++k) s = s + ar[k] * b[k * n + col];
  out[e] = s;
}

// tf32 (kParts 1) and tf32x3 (kParts 3): block i is the 16 x 8 output tile
// i (row-major over the tiles), one warp, 16 mma steps of k = 8. tf32x3
// splits each element of a into three tf32 parts (hi, then the rounded
// remainders: they cover its 24 bits), runs one pass per part into its own
// accumulator and adds the three in float32, (hi + mid) + lo. b is rounded
// to tf32 once (exact for 0/1).
template <int kParts>
__global__ void __launch_bounds__(32)
    lab_onehot_dot_mma_kernel(const float* __restrict__ a, const float* __restrict__ b, int m,
                              int n, float* __restrict__ out) {
  const int lane = threadIdx.x, g = lane >> 2, q = lane & 3;
  const int tiles_n = (n + 7) / 8;
  const int r0 = blockIdx.x / tiles_n * 16, n0 = blockIdx.x % tiles_n * 8;
  const int ra = r0 + g, rb = r0 + g + 8, col = n0 + g;
  // a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4); b0 (q, g),
  // b1 (q + 4, g) of each step, k0 = 8 * step.
  float av[kDotSteps][4];
  uint32_t bv[kDotSteps][2];
#pragma unroll
  for (int s = 0; s < kDotSteps; ++s) {
    const int k = 8 * s + q;
    av[s][0] = ra < m ? a[ra * kDotK + k] : 0.0f;
    av[s][1] = rb < m ? a[rb * kDotK + k] : 0.0f;
    av[s][2] = ra < m ? a[ra * kDotK + k + 4] : 0.0f;
    av[s][3] = rb < m ? a[rb * kDotK + k + 4] : 0.0f;
    bv[s][0] = tf32_rna(col < n ? b[k * n + col] : 0.0f);
    bv[s][1] = tf32_rna(col < n ? b[(k + 4) * n + col] : 0.0f);
  }
  float d[kParts][4] = {};
#pragma unroll
  for (int s = 0; s < kDotSteps; ++s) {
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      uint32_t ap[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        ap[v] = tf32_rna(av[s][v]);
        av[s][v] = av[s][v] - __uint_as_float(ap[v]);
      }
      mma_tf32(d[p], ap, bv[s][0], bv[s][1]);
    }
  }
  // d[v]: (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1).
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int row = r0 + g + (v >> 1) * 8, c = n0 + 2 * q + (v & 1);
    float val = d[0][v];
    if constexpr (kParts == 3) val = (d[0][v] + d[1][v]) + d[2][v];
    if (row < m && c < n) out[row * n + c] = val;
  }
}

// ---------------- vf_lab_lane_ops: E3 and E4 ----------------

enum LaneOp : int { kRoll, kExponent };

// One block per row, one thread per lane. kRoll: out[r][(c + shift) % cols]
// = x[r][c] (np.roll), through shared memory: a row's lanes span several
// warps. kExponent: ((bits >> 23) & 0xFF) - 127 of each element.
__global__ void lab_lane_ops_kernel(const float* __restrict__ x, int cols, int op, int shift,
                                    float* __restrict__ out) {
  __shared__ float row[1024];
  const int c = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * cols;
  if (op == kExponent) {
    out[base + c] = exponent_of(x[base + c]);
    return;
  }
  row[c] = x[base + c];
  __syncthreads();
  out[base + c] = row[(c - shift + cols) % cols];
}

// The most dynamic shared memory an H100 block may opt into.
constexpr int kMaxSmem = 232448;

// Opt a kernel into kMaxSmem bytes of dynamic shared memory on the current
// device.
template <typename K>
int allow_smem(K kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kMaxSmem);
}

}  // namespace

extern "C" {

// The op count and the chain's rows; lab._kernels.load() requires them to
// equal len(OPS) and CHAIN_ROWS.
int vf_lab_ops() { return kOps; }
int vf_lab_chain_rows() { return kChainRows; }
// The step loop's bodies; lab._kernels.load() requires len(_bodies.BODIES).
int vf_lab_bodies() { return kBodies; }

// Opt every kernel that may take more than 48 KB of dynamic shared memory
// (the slab copy, the slab loops, the step loop's bodies) into kMaxSmem on
// the current device; lab._kernels calls it once per device, before the
// device's first launch. Returns the first CUDA error.
int vf_lab_prepare() {
  int err = allow_smem(lab_slab_copy_kernel);
  if (!err) err = allow_smem(lab_slab_loop_kernel<true>);
  if (!err) err = allow_smem(lab_slab_loop_kernel<false>);
  for (int body = 0; body < kBodies && !err; ++body)
    err = allow_smem(loop_kernel(body, std::make_integer_sequence<int, kBodies>()));
  return err;
}

// t, u, p, out: n f32 each; op: an index into exp_fs_ops.py's OPS.
// Returns cudaGetLastError() after the launch.
int vf_lab_fs_ops(const float* t, const float* u, const float* p, long long n,
                  int op, float* out, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0) {
    lab_fs_ops_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        t, u, p, n, op, out);
  }
  return (int)cudaGetLastError();
}

// hh, xx, zz: n f32; channel: n int32 in 0..2; lut: (256, 3) f32 linear;
// par: [hr2, exposure, l0, l1, l2] f32 on the device; out: (15, n) f32.
int vf_lab_fs_chain(const float* hh, const float* xx, const float* zz,
                    const int* channel, int n, const float* lut,
                    const float* par, float* out, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0) {
    lab_fs_chain_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        hh, xx, zz, channel, n, lut, par, out);
  }
  return (int)cudaGetLastError();
}

// src: (rows, cols) f32, cols % 128 == 0, 16-byte aligned; out: (rows *
// cols / 128, 128) f32. Shared memory: rows * 512 bytes.
int vf_lab_slab_copy(const float* src, int rows, int cols, float* out,
                     void* stream) {
  const size_t smem = (size_t)rows * kSlabCols * sizeof(float);
  if (rows > 0 && cols > 0) {
    lab_slab_copy_kernel<<<cols / kSlabCols, kThreads, smem, (cudaStream_t)stream>>>(
        src, rows, cols, out);
  }
  return (int)cudaGetLastError();
}

// iters == 0: out (cols, rows) = src.T. iters > 0: rows % 4 == 0, cols <=
// 1024; out (1, cols); shared memory (rows * cols + cols * (rows/4 + 1)) * 4
// bytes.
int vf_lab_slab_transpose(const float* src, int rows, int cols, int iters,
                          int transpose, float* out, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  if (iters == 0) {
    const dim3 grid((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
    lab_transpose_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(src, rows, cols,
                                                                      out);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      ((size_t)rows * cols + (size_t)cols * (rows / 4 + 1)) * sizeof(float);
  const int threads = (cols + 31) / 32 * 32;
  if (transpose) {
    lab_slab_loop_kernel<true><<<1, threads, smem, (cudaStream_t)stream>>>(
        src, rows, cols, iters, out);
  } else {
    lab_slab_loop_kernel<false><<<1, threads, smem, (cudaStream_t)stream>>>(
        src, rows, cols, iters, out);
  }
  return (int)cudaGetLastError();
}

// big: the body's input (rows as the script has them, 128 columns) f32;
// acc: the scratch, (rows, 128) f32, updated in place; out: (8, 128) f32;
// iters loop iterations of unroll_of(body) steps each. One block of 1024
// threads, kLoopSmem bytes of shared memory.
int vf_lab_step_loop(const float* big, float* acc, int rows, int body, int iters, float* out,
                     void* stream) {
  if (body < 0 || body >= kBodies) return (int)cudaErrorInvalidValue;
  const LoopKernel kernel = loop_kernel(body, std::make_integer_sequence<int, kBodies>());
  kernel<<<1, kLoopThreads, kLoopSmem, (cudaStream_t)stream>>>(big, acc, rows, iters, out);
  return (int)cudaGetLastError();
}

// a: (m, 128) f32; b: (128, n) f32; out: (m, n) f32; 1 <= m, n <= 128; mode:
// 0 ffma, 1 tf32, 2 tf32x3.
int vf_lab_onehot_dot(const float* a, const float* b, int m, int n, int mode, float* out,
                      void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == kFfma) {
    lab_onehot_dot_ffma_kernel<<<(m * n + kDotThreads - 1) / kDotThreads, kDotThreads, 0, s>>>(
        a, b, m, n, out);
  } else {
    const int tiles = (m + 15) / 16 * ((n + 7) / 8);
    if (mode == kTf32) {
      lab_onehot_dot_mma_kernel<1><<<tiles, 32, 0, s>>>(a, b, m, n, out);
    } else {
      lab_onehot_dot_mma_kernel<3><<<tiles, 32, 0, s>>>(a, b, m, n, out);
    }
  }
  return (int)cudaGetLastError();
}

// x, out: (rows, cols) f32, cols <= 1024; op 0: roll by shift (0 <= shift
// < cols) along the columns, op 1: the exponent of each element's bits.
int vf_lab_lane_ops(const float* x, int rows, int cols, int op, int shift, float* out,
                    void* stream) {
  if (rows > 0 && cols > 0) {
    lab_lane_ops_kernel<<<rows, cols, 0, (cudaStream_t)stream>>>(x, cols, op, shift, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
