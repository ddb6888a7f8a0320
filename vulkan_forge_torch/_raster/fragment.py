"""Fragment stages ("fragment shaders") as torch epilogues.

Port of ``vulkan_forge/_raster/fragment.py:28-70, 203-214``:

  - ``terrain_fs``: the SHIPPED shader (src/shaders/terrain.wgsl:68-91):
    bilinear LUT, analytic-derivative normals, ambient-floor Lambert,
    rgb*exposure*shade, no tonemap, sRGB encode, u32 pack. It is the plain
    version of the fused kernel ``vf_raster_shade_shipped``, whose epilogue
    runs the same ops in the same order per pixel.
  - ``triangle_fs``: the gradient triangle's shader.

``lut`` is the pre-decoded linear (256, 4) float32 table (_colormap).
"""
from __future__ import annotations

import torch

from .._formats import pack_rgba_u32, srgb_encode


def sample_lut_bilinear(lut: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Bilinear, clamp-to-edge sample of the 256-entry LUT at coordinate t.

    Texel space x = t*256-0.5, blend the two nearest texels. Returns
    (..., C) linear values.
    """
    xf = t * 256.0 - 0.5
    x0 = torch.floor(xf)
    frac = (xf - x0)[..., None]
    i0 = torch.clamp(x0, 0, 255).to(torch.long)
    i1 = torch.clamp(x0 + 1.0, 0, 255).to(torch.long)
    return lut[i0] * (1.0 - frac) + lut[i1] * frac


def fs_scalars(h_range, exposure, sun_dir):
    """(hr2, exposure, l) with ``terrain_fs``'s ops: hr2 = 2*max(h_range,
    1e-8) and l the normalized sun direction. The fused kernel takes these
    precomputed, as the TPU kernel does (packed.py:907-913)."""
    hr2 = 2.0 * torch.clamp_min(h_range, 1e-8)
    l = sun_dir / torch.sqrt(torch.sum(sun_dir * sun_dir))
    return hr2, exposure, l


def terrain_fs(h, x, z, mask, lut, h_range, exposure, sun_dir):
    """Shipped terrain fragment shader (src/shaders/terrain.wgsl:68-91).

    h, x, z: (..., H, W) interpolated varyings; mask: (..., H, W) coverage;
    h_range, exposure: 0-d f32 tensors; sun_dir: (3,) f32. Returns
    (..., H, W) uint32 packed RGBA (background = clear color
    (0.02, 0.02, 0.03, 1.0), src/terrain/mod.rs:420).
    """
    hr2, exposure, l = fs_scalars(h_range, exposure, sun_dir)
    t = torch.clamp(0.5 + h / hr2, 0.0, 1.0)
    lut_rgb = sample_lut_bilinear(lut[:, :3], t)

    # Analytic-derivative normal (terrain.wgsl:79-81).
    dhdx = 1.3 * torch.cos(x * 1.3) * 0.25
    dhdz = -1.1 * torch.sin(z * 1.1) * 0.25
    inv_len = 1.0 / torch.sqrt(dhdx * dhdx + 1.0 + dhdz * dhdz)
    lambert = torch.clamp((-dhdx * l[0] + l[1] - dhdz * l[2]) * inv_len, 0.0, 1.0)
    shade = 0.15 + 0.85 * lambert  # mix(0.15, 1.0, lambert)

    rgb = lut_rgb * exposure * shade[..., None]

    clear = torch.tensor([0.02, 0.02, 0.03], dtype=torch.float32, device=h.device)
    rgb = torch.where(mask[..., None], rgb, clear)
    srgb = srgb_encode(rgb)
    one = torch.ones_like(srgb[..., 0])
    return pack_rgba_u32(srgb[..., 0], srgb[..., 1], srgb[..., 2], one)


def triangle_fs(r, g, b, mask):
    """Gradient-triangle fragment shader (src/shaders/triangle.wgsl:18-24).

    Varyings are the interpolated linear vertex colors; clear color is white
    (src/lib.rs:19). Hardware sRGB encode on store.
    """
    rgb = torch.stack([r, g, b], dim=-1)
    white = torch.ones(3, dtype=torch.float32, device=r.device)
    rgb = torch.where(mask[..., None], rgb, white)
    srgb = srgb_encode(rgb)
    one = torch.ones_like(srgb[..., 0])
    return pack_rgba_u32(srgb[..., 0], srgb[..., 1], srgb[..., 2], one)
