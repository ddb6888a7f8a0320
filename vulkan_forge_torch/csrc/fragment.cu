// The extended terrain fragment shader as one hand-written Hopper kernel
// (sm_90a).
//
// vf_terrain_fs_extended shades a g-buffer -- the varyings h, u, v and the
// coverage mask of B frames, (B, H, W) each -- into one u32 RGBA word per
// pixel, as fragment.terrain_fs_extended_plain does: heights normalised
// through [h_min, h_max] into a bilinear LUT sample, central-difference
// normals from the height texture at the pixel's uv (one-sided at the
// borders), Lambert with the ambient floor, exposure, Reinhard, the clear
// colour where nothing covers the pixel, sRGB encode and the u32 pack.
//
// It replaces no pallas_call: the JAX package's shader is XLA code
// (vulkan_forge/_raster/fragment.py:151-201), fused by XLA on the TPU. In
// the port it was about 60 eager torch ops over the g-buffer, two blocking
// uploads (the clear colour and the normal spacing) and a LUT gather that
// moved ~1.6 GB a 7680x4320 frame.
//
// What bounds it on an H100: its bytes. A pixel reads 13 bytes of g-buffer
// (h, u, v, mask) and writes a 4-byte word; the height texture is read
// once more (a 3601^2 tile is 52 MB). At 7680x4320 that is ~0.62 GB,
// ~0.18 ms at 3.35 TB/s, against ~126 f32 operations a pixel, ~0.06 ms at
// 67 TFLOP/s.
//
// The design: one grid over all B*H*W pixels, four consecutive pixels per
// thread, 256 threads a block. A thread loads its pixels' h, u and v with
// one 16-byte load each and their four mask bytes with one 4-byte load,
// and stores the four words with one 16-byte store (kVec; a g-buffer that
// does not start on those boundaries, and the ragged last group, go pixel
// by pixel). Each block stages the 4 KB LUT into shared memory once, and
// thread 0 reads the per-call scalars from the device pointers the
// pipeline holds (no host read) and computes the sun's direction and the
// clear colour's word once for the block. The four height texels of a
// pixel are read through the read-only path: neighbouring pixels share
// texels, and the texture fits the 50 MB L2 almost whole. An uncovered
// pixel stores the clear word and reads no texel and no LUT entry.
//
// Numerics: every op is the plain version's f32 op in its order, built
// with -fmad=false and without fast math (IEEE division, correctly
// rounded sqrtf, the powf of vf::shade_shipped), torch's clamp, which
// keeps a NaN, and constants as torch rounds its Python scalars, so the
// words are the plain version's on the card bit for bit. The sun's
// normalisation sums its squares in the order of torch's reduction over
// three values: two lanes, lane 0 adding elements 0 and 2, lane 1
// element 1, then lane 0 adding lane 1's sum.

#include "raster_common.cuh"

namespace {

constexpr int kFsThreads = 256;  // one LUT row a thread when staging
constexpr int kFsPixels = 4;     // consecutive pixels a thread
static_assert(kFsThreads == 256, "a block stages the LUT's 256 rows, one a thread");

// torch.clamp_min(x, lo), which keeps a NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// The texel index along one axis: clamp(floor(c * size), 0, size - 1) as
// an integer. A NaN coordinate, which the plain version cannot index with,
// reads texel 0.
__device__ __forceinline__ int texel(float c, int size) {
  const float t = vf::clampf(floorf(c * (float)size), 0.0f, (float)(size - 1));
  return isnan(t) ? 0 : (int)t;
}

// A LUT index: clamp(x, 0, 255) as an integer (0 for a NaN, as texel()).
__device__ __forceinline__ int lut_index(float x) {
  const float t = vf::clampf(x, 0.0f, 255.0f);
  return isnan(t) ? 0 : (int)t;
}

// _formats.srgb_encode, then the byte of _formats.pack_rgba_u32.
__device__ __forceinline__ int32_t srgb_byte(float v) {
  v = vf::clampf(v, 0.0f, 1.0f);
  const float lo = v * 12.92f;
  const float hi = 1.055f * powf(fmaxf(v, 1e-12f), (float)(1.0 / 2.4)) - 0.055f;
  const float s = v <= 0.0031308f ? lo : hi;
  return (int32_t)floorf(vf::clampf(s, 0.0f, 1.0f) * 255.0f + 0.5f);
}

// The per-call values every pixel reads, made once a block.
struct Params {
  float h_min, h_range, exposure, l0, l1, l2, sp, exaggeration;
  int32_t clear;
};

// One covered pixel of fragment.terrain_fs_extended_plain.
__device__ __forceinline__ int32_t shade(float h, float u, float v, const float4* lut,
                                         const float* __restrict__ heights, int ht, int wt,
                                         const Params& p) {
  const float t = vf::clampf((h - p.h_min) / p.h_range, 0.0f, 1.0f);
  // fragment.sample_lut_bilinear
  const float xf = t * 256.0f - 0.5f;
  const float x0 = floorf(xf);
  const float frac = xf - x0;
  const float4 a = lut[lut_index(x0)], b = lut[lut_index(x0 + 1.0f)];

  const int tx = texel(u, wt), ty = texel(v, ht);
  const int txm = max(tx - 1, 0), txp = min(tx + 1, wt - 1);
  const int tym = max(ty - 1, 0), typ = min(ty + 1, ht - 1);
  const size_t row = (size_t)ty * wt;
  const float hxp = __ldg(heights + row + txp), hxm = __ldg(heights + row + txm);
  const float hzp = __ldg(heights + (size_t)typ * wt + tx);
  const float hzm = __ldg(heights + (size_t)tym * wt + tx);
  const float step_x = (float)(txp - txm), step_z = (float)(typ - tym);
  const float dhdx = (hxp - hxm) * p.exaggeration / (fmaxf(step_x, 1.0f) * p.sp);
  const float dhdz = (hzp - hzm) * p.exaggeration / (fmaxf(step_z, 1.0f) * p.sp);
  const float inv_len = 1.0f / sqrtf(dhdx * dhdx + 1.0f + dhdz * dhdz);
  const float lambert =
      vf::clampf((-dhdx * p.l0 + p.l1 - dhdz * p.l2) * inv_len, 0.0f, 1.0f);
  const float shade = 0.15f + 0.85f * lambert;

  const float one_minus = 1.0f - frac;
  const float lin[3] = {a.x * one_minus + b.x * frac, a.y * one_minus + b.y * frac,
                        a.z * one_minus + b.z * frac};
  int32_t word = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float rgb = lin[c] * shade;
    rgb = rgb * p.exposure;
    rgb = rgb / (1.0f + rgb);  // Reinhard
    word |= srgb_byte(rgb) << (8 * c);
  }
  return word | (int32_t)0xFF000000;  // alpha = 255
}

// kVec: h, u, v and out start on 16-byte boundaries and mask on a 4-byte
// one, so a thread's four pixels load and store as vectors.
template <bool kVec>
__global__ void __launch_bounds__(kFsThreads)
terrain_fs_extended_kernel(const float* __restrict__ gh, const float* __restrict__ gu,
                           const float* __restrict__ gv, const uint8_t* __restrict__ mask,
                           long long n, const float* __restrict__ lut_g,
                           const float* __restrict__ heights, int ht, int wt,
                           const float* __restrict__ h_min, const float* __restrict__ h_max,
                           const float* __restrict__ exposure,
                           const float* __restrict__ sun_dir, const float* __restrict__ spacing,
                           float spacing_value, const float* __restrict__ exaggeration,
                           int32_t* __restrict__ out) {
  __shared__ float4 lut[256];
  __shared__ Params par;
  {
    const float* src = lut_g + 4 * threadIdx.x;
    lut[threadIdx.x] = make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));
  }
  if (threadIdx.x == 0) {
    Params p;
    const float lo = __ldg(h_min);
    p.h_min = lo;
    p.h_range = clamp_min(__ldg(h_max) - lo, 1e-8f);
    p.exposure = __ldg(exposure);
    // fragment.terrain_fs_extended_plain's l = sun / sqrt(sum(sun * sun)).
    const float s0 = __ldg(sun_dir), s1 = __ldg(sun_dir + 1), s2 = __ldg(sun_dir + 2);
    const float q0 = s0 * s0, q1 = s1 * s1, q2 = s2 * s2;
    const float norm = sqrtf((q0 + q2) + q1);
    p.l0 = s0 / norm;
    p.l1 = s1 / norm;
    p.l2 = s2 / norm;
    p.sp = clamp_min(spacing ? __ldg(spacing) : spacing_value, 1e-8f);
    p.exaggeration = __ldg(exaggeration);
    const float clear[3] = {0.02f, 0.02f, 0.03f};
    p.clear = srgb_byte(clear[0]) | (srgb_byte(clear[1]) << 8) | (srgb_byte(clear[2]) << 16) |
              (int32_t)0xFF000000;
    par = p;
  }
  __syncthreads();

  const long long i0 = ((long long)blockIdx.x * kFsThreads + threadIdx.x) * kFsPixels;
  if (i0 >= n) return;
  const Params p = par;
  if (kVec && i0 + kFsPixels <= n) {
    const float4 h = __ldg(reinterpret_cast<const float4*>(gh + i0));
    const float4 u = __ldg(reinterpret_cast<const float4*>(gu + i0));
    const float4 v = __ldg(reinterpret_cast<const float4*>(gv + i0));
    const uchar4 m = __ldg(reinterpret_cast<const uchar4*>(mask + i0));
    int4 w;
    w.x = m.x ? shade(h.x, u.x, v.x, lut, heights, ht, wt, p) : p.clear;
    w.y = m.y ? shade(h.y, u.y, v.y, lut, heights, ht, wt, p) : p.clear;
    w.z = m.z ? shade(h.z, u.z, v.z, lut, heights, ht, wt, p) : p.clear;
    w.w = m.w ? shade(h.w, u.w, v.w, lut, heights, ht, wt, p) : p.clear;
    *reinterpret_cast<int4*>(out + i0) = w;
  } else {
    const long long end = min(i0 + kFsPixels, n);
    for (long long i = i0; i < end; ++i) {
      out[i] = mask[i] ? shade(__ldg(gh + i), __ldg(gu + i), __ldg(gv + i), lut, heights, ht,
                               wt, p)
                       : p.clear;
    }
  }
}

}  // namespace

extern "C" {

// h, u, v: n f32 each; mask: n bytes (0 or 1); lut: (256, 4) f32; heights:
// (ht, wt) f32; h_min, h_max, exposure, exaggeration: one f32 each and
// sun_dir three, on the device; spacing: one f32 on the device, or null to
// take spacing_value; vec: 1 when h, u, v and out start on 16-byte
// boundaries and mask on a 4-byte one; out: n words.
int vf_terrain_fs_extended(const float* h, const float* u, const float* v,
                           const uint8_t* mask, long long n, const float* lut,
                           const float* heights, int ht, int wt, const float* h_min,
                           const float* h_max, const float* exposure, const float* sun_dir,
                           const float* spacing, float spacing_value,
                           const float* exaggeration, int vec, int32_t* out, void* stream) {
  if (n > 0) {
    const long long per_block = (long long)kFsThreads * kFsPixels;
    const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
    cudaStream_t s = (cudaStream_t)stream;
    if (vec) {
      terrain_fs_extended_kernel<true><<<blocks, kFsThreads, 0, s>>>(
          h, u, v, mask, n, lut, heights, ht, wt, h_min, h_max, exposure, sun_dir, spacing,
          spacing_value, exaggeration, out);
    } else {
      terrain_fs_extended_kernel<false><<<blocks, kFsThreads, 0, s>>>(
          h, u, v, mask, n, lut, heights, ht, wt, h_min, h_max, exposure, sun_dir, spacing,
          spacing_value, exaggeration, out);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
