// The lab kernels of vulkan_forge_torch (sm_90a): four probes, each the
// counterpart of a TPU kernel that a script in scripts/ launches to answer
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
//
// What bounds them on an H100: nothing at these sizes but latency. The
// scripts' shapes are 32K elements (fs_ops), a few pixels (fs_chain),
// 128 KB (slab copy) and one 64 KB source walked by one block (the loop),
// so each launch costs a few microseconds of fixed overhead, and the loop
// is a chain of dependent shared-memory steps on one SM; what the loop
// measures is the per-iteration cost of the transpose, as the script's
// does on the TPU.
//
// Numerics: built with the raster kernels' flags (-fmad=false, no fast
// math), so +, -, *, / and sqrtf round once (IEEE round to nearest) and
// the transcendentals are CUDA's libdevice functions within the maximum
// ulp errors of the CUDA C++ Programming Guide's single-precision table.

#include <cuda_runtime.h>
#include <stdint.h>

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

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

extern "C" {

// The op count and the chain's rows; lab._kernels.load() requires them to
// equal len(OPS) and CHAIN_ROWS.
int vf_lab_ops() { return kOps; }
int vf_lab_chain_rows() { return kChainRows; }

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
  int err = allow_smem(lab_slab_copy_kernel, smem);
  if (err) return err;
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
  int err;
  if (transpose) {
    err = allow_smem(lab_slab_loop_kernel<true>, smem);
    if (err) return err;
    lab_slab_loop_kernel<true><<<1, threads, smem, (cudaStream_t)stream>>>(
        src, rows, cols, iters, out);
  } else {
    err = allow_smem(lab_slab_loop_kernel<false>, smem);
    if (err) return err;
    lab_slab_loop_kernel<false><<<1, threads, smem, (cudaStream_t)stream>>>(
        src, rows, cols, iters, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
