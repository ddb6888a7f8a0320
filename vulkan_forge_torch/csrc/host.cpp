// Host core of vulkan_forge_torch: the C++ path of grid_generate.
//
// The counterpart of vf_grid_generate in the JAX package's host core: the
// same loop, the same f32 operations in the same order, and true f32
// divisions for uv. It is built by g++ on first use (vulkan_forge_torch/
// _native.py) with -ffp-contract=off: contracting `x * dx - cx` into a
// fused multiply-add rounds once where _mesh.make_grid rounds twice, and
// the output must equal make_grid's bit for bit. Plain C interface, loaded
// with ctypes.

#include <cstdint>

extern "C" {

// Centered grid mesh (src/terrain/mesh.rs:35-90): xy[i] = (x*dx - cx,
// y*dy - cy), uv in [0,1]^2, CCW cell indices [i0, i1, i2, i2, i1, i3].
// Output buffers are caller-allocated: xy and uv nx*nz*2 floats, idx
// (nx-1)*(nz-1)*6 uint32 (indices wrap mod 2^32, as make_grid's cast does).
void vf_grid_generate(int64_t nx, int64_t nz, float dx, float dy,
                      float* xy, float* uv, uint32_t* idx) {
    const float cx = (static_cast<float>(nx) - 1.0f) * 0.5f * dx;
    const float cy = (static_cast<float>(nz) - 1.0f) * 0.5f * dy;
    // True f32 division (not a reciprocal multiply), as make_grid divides.
    const float den_w = static_cast<float>(nx - 1);
    const float den_h = static_cast<float>(nz - 1);
    for (int64_t y = 0; y < nz; ++y) {
        const float wy = static_cast<float>(y) * dy - cy;
        const float v = static_cast<float>(y) / den_h;
        float* xyrow = xy + y * nx * 2;
        float* uvrow = uv + y * nx * 2;
        for (int64_t x = 0; x < nx; ++x) {
            xyrow[2 * x + 0] = static_cast<float>(x) * dx - cx;
            xyrow[2 * x + 1] = wy;
            uvrow[2 * x + 0] = static_cast<float>(x) / den_w;
            uvrow[2 * x + 1] = v;
        }
    }
    const uint32_t w = static_cast<uint32_t>(nx);
    uint32_t* p = idx;
    for (int64_t y = 0; y < nz - 1; ++y) {
        const uint32_t row = static_cast<uint32_t>(y) * w;
        for (int64_t x = 0; x < nx - 1; ++x) {
            const uint32_t i0 = row + static_cast<uint32_t>(x);
            const uint32_t i1 = i0 + 1;
            const uint32_t i2 = i0 + w;
            const uint32_t i3 = i2 + 1;
            *p++ = i0; *p++ = i1; *p++ = i2;
            *p++ = i2; *p++ = i1; *p++ = i3;
        }
    }
}

}  // extern "C"
