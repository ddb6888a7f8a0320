"""Fragment stages ("fragment shaders") as torch epilogues.

Port of ``vulkan_forge/_raster/fragment.py:28-70, 151-214``:

  - ``terrain_fs``: the SHIPPED shader (src/shaders/terrain.wgsl:68-91):
    bilinear LUT, analytic-derivative normals, ambient-floor Lambert,
    rgb*exposure*shade, no tonemap, sRGB encode, u32 pack. It is the plain
    version of the fused kernel ``vf_raster_shade_shipped``, whose epilogue
    runs the same ops in the same order per pixel.
  - ``terrain_fs_extended``: the documented extended pipeline
    (central-difference normals from the height texture, Reinhard tonemap).
    It is XLA code in the JAX package, with no Pallas kernel, and plain
    torch here on both devices.
  - ``triangle_fs``: the gradient triangle's shader.

``lut`` is the pre-decoded linear (256, 4) float32 table (_colormap).
"""
from __future__ import annotations

import torch

from .. import _trace
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

    clear = _trace.h2d(None, torch.tensor([0.02, 0.02, 0.03], dtype=torch.float32,
                                          device=h.device))
    rgb = torch.where(mask[..., None], rgb, clear)
    srgb = srgb_encode(rgb)
    one = torch.ones_like(srgb[..., 0])
    return pack_rgba_u32(srgb[..., 0], srgb[..., 1], srgb[..., 2], one)


def terrain_fs_extended(h, u, v, mask, lut, heights, h_min, h_max, exposure,
                        sun_dir, spacing, exaggeration):
    """Extended terrain shader: finite-difference normals + Reinhard tonemap.

    h, u, v: (..., H, W) interpolated varyings (height, texture u, v);
    heights: the (Ht, Wt) height texture; the scalars are 0-d f32 tensors.
    Ops in the order of ``vulkan_forge/_raster/fragment.py:151-201``:
    heights normalize into [0, 1] through [h_min, h_max], normals are
    central differences of the texture at the pixel's uv (one-sided at the
    borders), scaled by spacing and exaggeration; Reinhard in linear, then
    the target's sRGB encode. Returns (..., H, W) uint32 packed RGBA.
    """
    ht, wt = heights.shape
    t = torch.clamp((h - h_min) / torch.clamp_min(h_max - h_min, 1e-8), 0.0, 1.0)
    lut_rgb = sample_lut_bilinear(lut, t)[..., :3]

    tx = torch.clamp(torch.floor(u * wt), 0, wt - 1).to(torch.long)
    ty = torch.clamp(torch.floor(v * ht), 0, ht - 1).to(torch.long)
    txm = torch.clamp_min(tx - 1, 0)
    txp = torch.clamp_max(tx + 1, wt - 1)
    tym = torch.clamp_min(ty - 1, 0)
    typ = torch.clamp_max(ty + 1, ht - 1)
    step_x = (txp - txm).to(torch.float32)
    step_z = (typ - tym).to(torch.float32)
    sp = torch.clamp_min(spacing, 1e-8)
    dhdx = ((heights[ty, txp] - heights[ty, txm]) * exaggeration
            / (torch.clamp_min(step_x, 1.0) * sp))
    dhdz = ((heights[typ, tx] - heights[tym, tx]) * exaggeration
            / (torch.clamp_min(step_z, 1.0) * sp))
    inv_len = 1.0 / torch.sqrt(dhdx * dhdx + 1.0 + dhdz * dhdz)
    l = sun_dir / torch.sqrt(torch.sum(sun_dir * sun_dir))
    lambert = torch.clamp((-dhdx * l[0] + l[1] - dhdz * l[2]) * inv_len, 0.0, 1.0)
    shade = 0.15 + 0.85 * lambert

    rgb = lut_rgb * shade[..., None]
    rgb = rgb * exposure
    rgb = rgb / (1.0 + rgb)

    clear = _trace.h2d(None, torch.tensor([0.02, 0.02, 0.03], dtype=torch.float32,
                                          device=h.device))
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
